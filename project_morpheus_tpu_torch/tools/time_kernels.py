"""Device time of the kernels, apart from their wrappers' host time.

    python -m project_morpheus_tpu_torch.tools.time_kernels [prefill | w8a8]
    python -m project_morpheus_tpu_torch.tools.time_kernels w8a8-ab TAG [ROWS]

At the Orpheus-3B serving shapes (28 layers, 8 slots x 8192, KV=8, HD=128,
G=3) and two sets of live lengths (``SHAPES``), times each kernel three ways:

- ``device_ms``: ``GRAPH_CALLS`` wrapper calls (one per layer, so each call
  finds its layer cold in L2) captured in one CUDA graph, the graph replayed
  ``REPLAYS`` times between two CUDA events.  Only the kernels run in a
  replay, so this is the card's time per call, free of the wrapper's checks,
  allocations and ctypes call.
- ``host_us``: the host clock over ``GRAPH_CALLS`` eager wrapper calls that
  are not waited for: what one call costs the Python thread.
- ``events_ms``: CUDA events around ``GRAPH_CALLS`` eager calls, the method
  of the older records in ``PERF.md``; it reads the host wherever
  ``host_us`` exceeds ``device_ms``.

and, for the layered kernel, ``scaled_dot_product_attention`` on the same
inputs as a yardstick (graph-timed the same way; the port never calls it).
``PREFILL_SHAPES`` and the ``prefill_*`` helpers give the chunk-prefill
attention's inputs, its bytes and causal operations, and its SDPA
yardstick, timed the same way (``chip_smoke.py`` phase 2); with the
argument ``prefill`` this prints only the chunk-prefill kernel's records
(``prefill_timings``) and the checks that failed, and exits non-zero if
any did, after timing every shape (run it in a copy of the package with a
kernel constant changed, or in a ``git archive`` of a parent commit with
this file copied in, to compare designs in one call).
``main`` also splits each call's device time by CUDA kernel (split pass,
merge) with the torch profiler.  Prints one JSON line.  ``chip_smoke.py``
phase 2 times with these functions, the int8 GEMV with ``chained_ms`` (a
dependent add between calls) at ``gemv_shapes``.

With the argument ``w8a8`` it checks and times the chunk prefill's w8a8
kernels (``ops/w8a8_gemm.py``) at ``W8A8_PAIRS`` (the Orpheus-3B weights,
their tp = 2 halves and a tp = 8 rank's, and a 1B tp = 8 rank's ``wk``)
and ``W8A8_ROWS`` (``w8a8_timings``): each equal to its plain version bit
for bit, eager and replayed from a CUDA graph, also at the row tails
``W8A8_TAILS`` and at the N and K tails ``W8A8_SHAPE_TAILS`` (checked
only); then, at each timed row count, the GEMM's and the quantize's device
ms a call from a graph of 28 calls (the 28 layers' weights cycled, so each
call finds its weight cold in L2; the activations stay warm, as the
quantize's output and the norm's are in a round) and host us a call,
beside the bound, the plain versions' ms and three library yardsticks for
the GEMM: ``torch._int_mm`` on the (K, N) weight (the call this kernel
replaced), ``torch._int_mm`` on the K-major copy, and ``torch.matmul`` in
bf16 on a weight dequantized ahead of time; and the quantize + GEMM pair
as the projection runs it (a graph of 28 pairs), with the GEMM launched as
a programmatic dependent of the quantize and without.  The port never
calls the yardsticks.  Prints the records as text and one JSON line.  It
needs a CUDA card and fails without one.

With ``w8a8-ab TAG [ROWS]`` (rows comma-separated, default ``W8A8_ROWS``)
it prints ``TAG`` and one JSON object of the GEMM's and the quantize's
device ms a call (``w8a8_ab_times``) at the four 3B weights: copied into a
``git archive`` of a parent commit and run there in turns with this tree
(parent, change, change, parent), it compares the two in one call.
"""
from __future__ import annotations

import json
import re
import time

L, B, S, KV, HD, H = 28, 8, 8192, 8, 128, 24
SHAPES = {
    "mixed": [1, 37, 511, 2048, 3000, 5000, 8191, 8192],
    "all_live": [8192] * 8,
}
GRAPH_CALLS = 28
REPLAYS = 10


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = REPLAYS) -> float:
    """Device ms per ``fn(i)``: ``calls`` calls captured in a CUDA graph,
    replayed ``replays`` times between two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for i in range(calls):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def chained_ms(fn, link, calls: int = GRAPH_CALLS, replays: int = REPLAYS):
    """Device ms per ``fn(i)`` with a small dependent op between calls, as
    in serving, where a norm or an add sits between two projections: a graph
    of ``link(y)``, ``y = fn(i)`` pairs (``link`` takes the previous call's
    output) less a graph of the links alone.  A kernel launched to start
    before its predecessor ends then overlaps the link's tail, as in
    serving, and not the previous call.  Returns (ms per call, ms per link).
    """
    last = [fn(0)]

    def pair(i):
        link(last[0])
        last[0] = fn(i)

    both = graph_ms(pair, calls, replays)
    alone = graph_ms(lambda i: link(last[0]), calls, replays)
    return both - alone, alone


def host_us(fn, calls: int = GRAPH_CALLS) -> float:
    """Host us per ``fn(i)`` over ``calls`` eager calls, none waited for."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def events_ms(fn, calls: int = GRAPH_CALLS) -> float:
    """Device ms per ``fn(i)`` from events around eager calls."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def kernel_us(fn, calls: int = GRAPH_CALLS) -> dict:
    """Device us per ``fn(i)`` of each CUDA kernel it launches, from the
    torch profiler's CUPTI trace of ``calls`` eager calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            name = evt.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = re.split(r"[<(]", name)[0]
            out[name] = out.get(name, 0.0) + us / calls
    return out


def gemv_shapes() -> dict:
    """The int8 GEMV's weights in one Orpheus-3B decode step:
    name -> (K, N, k_major, layers)."""
    from ..model import LlamaConfig

    c = LlamaConfig.orpheus_3b()
    D, L, HD = c.hidden_size, c.num_layers, c.head_dim
    return {"wqkv": (D, (c.num_heads + 2 * c.num_kv_heads) * HD, False, L),
            "wo": (c.num_heads * HD, D, False, L),
            "wgu": (D, 2 * c.intermediate_size, False, L),
            "wd": (c.intermediate_size, D, False, L),
            "lm_head": (D, c.padded_vocab, True, 1)}


def gemv_link(torch, h, h0):
    """The dependent op between two timed GEMV calls: ``h = h0 + y[:, :1]``,
    an M x K add that reads the previous output and writes the next input
    (a residual add's size)."""
    return lambda y: torch.add(h0, y[:, :1], out=h)


def timings(fn) -> dict:
    return dict(device_ms=graph_ms(fn), host_us=host_us(fn), events_ms=events_ms(fn))


def sdpa_call(torch, q, k, v, lens):
    """One PyTorch call for the layered kernel's function (the yardstick)."""
    mask = (torch.arange(k.shape[-2], device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda i: sdpa(q4, k[i % k.shape[0]], v[i % v.shape[0]], attn_mask=mask,
                          enable_gqa=True)


# the chunk-prefill attention at the serving shapes: (chunk, history
# bucket, offset), every job's chunk at [offset, offset + chunk), J jobs on
# spread slots of the B-slot cache.  The first four end at their bucket;
# the main path's rounds (``engine._plan_chunks`` on ``chip_smoke.py``'s
# 2,491-token prompt: 1024 at 0, 1024 at 1024, 512 at 2048; its burst runs
# the first at J = 4) do not.  Frontiers (offset + chunk) fall along the
# tuple, so garbage written past one shape's frontier lies past every later
# one's too.
PREFILL_SHAPES = ((1024, 8192, 7168), (512, 8192, 7680), (1024, 4096, 3072),
                  (512, 4096, 2048), (1024, 2048, 1024), (1024, 1024, 0))
PREFILL_SLOTS = {1: [5], 4: [1, 3, 4, 6]}


def prefill_cache(torch, quant: bool, dev, g, layers: int = L, slots: int = B,
                  seq: int = S, kv: int = KV, hd: int = HD) -> dict:
    """A random cache of ``layers`` layers in either layout of
    ``model/llama.py``: int8 position-major with scales, or bf16
    head-major."""
    if quant:
        shape = (layers, slots, seq, kv * hd)
        return {"k": torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8),
                "v": torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8),
                "scale": torch.rand(layers, slots, seq, 2 * kv, generator=g, device=dev) * 0.02
                + 0.002}
    shape = (layers, slots, kv, seq, hd)
    return {n: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for n in ("k", "v")}


def prefill_garbage(cache: dict, slots, frontier: int) -> None:
    """Large finite values past ``frontier`` in each of ``slots``: read only
    if a kernel attends past a query's position."""
    quant = "scale" in cache
    for b in slots:
        if quant:
            cache["k"][:, b, frontier:], cache["v"][:, b, frontier:] = 127, -127
            cache["scale"][:, b, frontier:] = 1e3
        else:
            cache["k"][:, b, :, frontier:], cache["v"][:, b, :, frontier:] = 1e4, -1e4


def prefill_work(J: int, C: int, hist: int, quant: bool, off: int, h: int = H, kv: int = KV,
                 hd: int = HD):
    """(bytes, operations) one call needs with every job's chunk at ``off``:
    q in and out once, each job's attended K/V (and scales) once; the
    causal products only (q.k and p.v, a multiply-add each)."""
    keys = sum(min(off + c + 1, hist) for c in range(C))
    row = 2 * kv * hd * (1 if quant else 2) + (2 * kv * 4 if quant else 0)
    nbytes = 2 * J * C * h * hd * 2 + J * min(off + C, hist) * row + 8 * J
    return nbytes, 4.0 * J * keys * h * hd


def sdpa_prefill_call(torch, q, cache: dict, slots, hist: int, off: int):
    """The yardstick for a bf16 cache: ``scaled_dot_product_attention`` of
    the chunk (J, C, H, HD) over each job's history gathered beforehand
    (its kv heads repeated to the query heads), with the causal mask of a
    chunk at ``off``; ``fn(i)`` reads layer ``i``."""
    J, C, Hq, hd = q.shape
    idx = torch.tensor(slots, device=q.device)
    rep = Hq // cache["k"].shape[2]
    kh = cache["k"][:, idx, :, :hist].repeat_interleave(rep, dim=2)
    vh = cache["v"][:, idx, :, :hist].repeat_interleave(rep, dim=2)
    pos = off + torch.arange(C, device=q.device)
    mask = (torch.arange(hist, device=q.device)[None, :] <= pos[:, None])[None, None]
    q4 = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda i: sdpa(q4, kh[i % kh.shape[0]], vh[i % vh.shape[0]], attn_mask=mask)


def prefill_timings(torch, dev, check) -> dict:
    """The chunk-prefill kernel at every ``PREFILL_SHAPES`` shape, J = 1 and
    4 jobs on ``PREFILL_SLOTS``, int8 and bf16 caches, garbage past each
    job's frontier: checked against its twin at layers 0 and ``L - 1`` by
    ``check(got, want, what)`` (which raises on a difference, or records
    it, and returns the max abs error), then timed by :func:`timings`; bf16 shapes beside
    SDPA, the first bf16 J = 4 shape beside the twin.  Returns {shape name:
    record with J, C, hist, off, quant, err and the times}."""
    from project_morpheus_tpu_torch.ops import prefill_attention as pa

    g = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for quant in (True, False):
        cache = prefill_cache(torch, quant, dev, g)

        def layer(i):
            return {n: t[i % L] for n, t in cache.items()}

        for J, slots in PREFILL_SLOTS.items():
            st = torch.tensor(slots, dtype=torch.int32, device=dev)
            for C, hist, off in PREFILL_SHAPES:
                prefill_garbage(cache, slots, off + C)
                ot = torch.full((J,), off, dtype=torch.int32, device=dev)
                q = torch.randn(J, C, H, HD, generator=g, device=dev).to(torch.bfloat16)
                name = f"{'int8' if quant else 'bf16'} J={J} C={C} off={off} hist={hist}"
                err = 0.0
                for i in (0, L - 1):
                    got = pa.prefill_chunk_attention(q, layer(i), st, ot, hist)
                    want = pa.prefill_chunk_attention_plain(q, layer(i), st, ot, hist).float()
                    torch.cuda.synchronize()
                    err = max(err, check(got, want, f"prefill attention {name}, layer {i}"))
                rec = dict(timings(lambda i: pa.prefill_chunk_attention(q, layer(i), st, ot,
                                                                        hist)),
                           J=J, C=C, hist=hist, off=off, quant=quant, err=err, plain_ms=None,
                           library_ms=None)
                if not quant:
                    rec["library_ms"] = graph_ms(sdpa_prefill_call(torch, q, cache, slots, hist,
                                                                   off))
                    if J == 4 and (C, hist, off) == PREFILL_SHAPES[0]:
                        rec["plain_ms"] = events_ms(
                            lambda i: pa.prefill_chunk_attention_plain(q, layer(i), st, ot, hist),
                            3)
                out[name] = rec
        del cache
        torch.cuda.empty_cache()
    return out


# the chunk prefill's w8a8 weights (K, N): Orpheus-3B's fused projections,
# the halves a rank of tp = 2 holds, the unfused shares of a tp = 8 rank
# (tensor parallelism never fuses; wu is wg's shape) and Orpheus-1B's wk at
# tp = 8; the rows a call takes (a round's J x chunk), timed; the row tails
# (the 64-row tile's edge among them) and the N and K tails checked besides
W8A8_PAIRS = {"wqkv": (3072, 5120), "wo": (3072, 3072), "wgu": (3072, 16384), "wd": (8192, 3072),
              "wqkv/2": (3072, 2560), "wo/2": (1536, 3072), "wgu/2": (3072, 8192),
              "wd/2": (4096, 3072), "wq/8": (3072, 384), "wk/8": (3072, 128),
              "wo/8": (384, 3072), "wg/8": (3072, 1024), "wd/8": (1024, 3072),
              "1b wk/8": (2048, 64)}
W8A8_ROWS = (32, 128, 512, 1024, 2048, 4096)
W8A8_TAILS = (1, 33, 64, 65, 100, 1000)
W8A8_SHAPE_TAILS = {"N tail": (2048, 200), "K tail": (1040, 128), "K and N tails": (1040, 200),
                    "N = 1": (1040, 1)}
W8A8_SHORT_ROWS = (32, 128)  # the short prompts' rounds, recorded weight by weight


def w8a8_work(M: int, K: int, N: int):
    """(bytes, operations) of one GEMM call: h8, the weight, both scales
    read once, the bf16 output written once; a multiply-add per
    (row, column, k)."""
    return M * K + K * N + 4 * M + 4 * N + 2 * M * N, 2.0 * M * K * N


def quantize_work(M: int, K: int):
    """(bytes, fp32 operations) of one quantize call: bf16 rows read once,
    int8 rows and the scales written once; per value a compare for the
    maximum, a division, a rounding and two clamps."""
    return 3 * M * K + 4 * M, 5.0 * M * K


def w8a8_pair_ms(torch, wg, h, qt, scale, dependent: bool) -> float:
    """Device ms of one quantize + GEMM pair (a graph of 28, the weights
    cycled), the GEMM launched as a programmatic dependent or not."""
    keep = wg.DEPENDENT_LAUNCH
    wg.DEPENDENT_LAUNCH = dependent
    try:
        def pair(i):
            h8, hsc = wg.quantize_rows(h)
            return wg.w8a8_gemm(h8, hsc, qt[i % L], scale[i % L], torch.bfloat16)

        return graph_ms(pair)
    finally:
        wg.DEPENDENT_LAUNCH = keep


def w8a8_timings(torch, dev, rows=W8A8_ROWS, pairs=W8A8_PAIRS, tails=W8A8_TAILS,
                 shape_tails=W8A8_SHAPE_TAILS) -> dict:
    """The w8a8 kernels at ``pairs`` x (``tails`` + ``rows``) and
    ``shape_tails`` x (``tails`` + ``rows``): checked bit for bit against
    their plain versions, eagerly (layers 0 and ``L - 1``) and replayed from
    a captured graph; ``pairs`` at ``rows``, timed (module docstring).
    Raises on a difference.  Returns {"pair M=rows": record}."""
    from project_morpheus_tpu_torch.ops import w8a8_gemm as wg

    g = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for name, (K, N) in {**pairs, **shape_tails}.items():
        timed = name in pairs
        q = torch.randint(-127, 128, (L, K, N), generator=g, device=dev, dtype=torch.int8)
        qt = q.transpose(1, 2).contiguous()
        scale = torch.rand(L, N, generator=g, device=dev) * 0.02 + 1e-3
        wb = (q.float() * scale[:, None, :]).to(torch.bfloat16)  # the bf16 yardstick's weight
        for M in (*tails, *rows):
            what = f"w8a8 {name} {K}x{N} M={M}"
            h = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
            h8, hsc = wg.quantize_rows(h)
            want8, wantsc = wg.quantize_rows_plain(h)
            if not (torch.equal(h8, want8) and torch.equal(hsc, wantsc)):
                raise AssertionError(f"{what}: the quantize differs from its plain version")
            for i in (0, L - 1):
                got = wg.w8a8_gemm(h8, hsc, qt[i], scale[i], torch.bfloat16)
                want = wg.w8a8_gemm_plain(h8, hsc, qt[i], scale[i], torch.bfloat16)
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(f"{what}, layer {i}: {bad} values differ from the plain "
                                         "version")

            def both():
                x8, xsc = wg.quantize_rows(h)
                return x8, wg.w8a8_gemm(x8, xsc, qt[0], scale[0], torch.bfloat16)

            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                both()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                g8, gy = both()
            graph.replay()
            torch.cuda.synchronize()
            eager = wg.w8a8_gemm(h8, hsc, qt[0], scale[0], torch.bfloat16)
            if not (torch.equal(g8, h8) and torch.equal(gy, eager)):
                raise AssertionError(f"{what}: a replayed graph differs from the eager calls")
            del graph
            if M not in rows or not timed:
                continue
            gemm = lambda i: wg.w8a8_gemm(h8, hsc, qt[i % L], scale[i % L], torch.bfloat16)  # noqa: E731
            quant = lambda i: wg.quantize_rows(h)  # noqa: E731
            out[f"{name} M={M}"] = dict(
                K=K, N=N, M=M, plan=wg.PLAN(M, N, K, dev),
                device_ms=graph_ms(gemm), host_us=host_us(gemm),
                plain_ms=events_ms(lambda i: wg.w8a8_gemm_plain(h8, hsc, qt[i % L], scale[i % L],
                                                                torch.bfloat16), 3),
                library_ms=graph_ms(lambda i: torch._int_mm(h8, q[i % L])),
                library_kmajor_ms=graph_ms(lambda i: torch._int_mm(h8, qt[i % L].t())),
                library_bf16_ms=graph_ms(lambda i: h @ wb[i % L]),
                quantize_ms=graph_ms(quant), quantize_host_us=host_us(quant),
                quantize_plain_ms=events_ms(lambda i: wg.quantize_rows_plain(h), 3),
                pair_ms=w8a8_pair_ms(torch, wg, h, qt, scale, True),
                pair_nodep_ms=w8a8_pair_ms(torch, wg, h, qt, scale, False))
        del q, qt, scale, wb
        torch.cuda.empty_cache()
    return out


def w8a8_ab_times(torch, dev, rows=W8A8_ROWS) -> dict:
    """{"<weight> M=<rows>": GEMM device ms, "quantize <weight> M=<rows>":
    quantize device ms} at Orpheus-3B's four weights, each from a graph of
    28 calls (the layers' weights cycled), through the package's own
    ``quantize_rows`` and ``w8a8_gemm`` (an API older commits share)."""
    from project_morpheus_tpu_torch.ops import w8a8_gemm as wg

    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for name in ("wqkv", "wo", "wgu", "wd"):
        K, N = W8A8_PAIRS[name]
        qt = torch.randint(-127, 128, (L, N, K), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(L, N, generator=g, device=dev) * 0.02 + 1e-3
        for M in rows:
            h = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
            h8, hsc = wg.quantize_rows(h)
            out[f"{name} M={M}"] = graph_ms(lambda i: wg.w8a8_gemm(h8, hsc, qt[i % L],
                                                                   scale[i % L], torch.bfloat16))
            out[f"quantize {name} M={M}"] = graph_ms(lambda i: wg.quantize_rows(h))
    return out


def main() -> None:
    import sys

    import torch

    from project_morpheus_tpu_torch.ops import build, decode_attention as da

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA card")
    build.build_all()
    dev = torch.device("cuda")
    if sys.argv[1:2] == ["w8a8-ab"]:
        rows = [int(r) for r in sys.argv[3].split(",")] if len(sys.argv) > 3 else W8A8_ROWS
        print(sys.argv[2], json.dumps(w8a8_ab_times(torch, dev, rows)), flush=True)
        return
    if sys.argv[1:] == ["w8a8"]:
        shapes = w8a8_timings(torch, dev)
        for name, r in shapes.items():
            b_bytes, b_ops = w8a8_work(r["M"], r["K"], r["N"])
            bound = max(b_bytes / 3.35e12, b_ops / 1979e12) * 1e3
            qb = quantize_work(r["M"], r["K"])[0] / 3.35e12 * 1e3
            print(f"{name} (plan {r['plan']}): gemm {r['device_ms']:.4f} ms, host "
                  f"{r['host_us']:.1f} us, bound {bound:.4f} ms ({100 * bound / r['device_ms']:.1f}"
                  f"%), plain {r['plain_ms']:.3f}, _int_mm (K, N) {r['library_ms']:.4f}, _int_mm "
                  f"K-major {r['library_kmajor_ms']:.4f}, bf16 matmul {r['library_bf16_ms']:.4f}; "
                  f"quantize {r['quantize_ms'] * 1e3:.2f} us (bound {qb * 1e3:.2f} us), host "
                  f"{r['quantize_host_us']:.1f} us, plain {r['quantize_plain_ms']:.3f} ms; pair "
                  f"{r['pair_ms'] * 1e3:.2f} us dependent, {r['pair_nodep_ms'] * 1e3:.2f} us not",
                  flush=True)
        print(json.dumps({"card": torch.cuda.get_device_name(0), "w8a8": shapes}), flush=True)
        return
    if sys.argv[1:] == ["prefill"]:
        fails = []

        def check(got, want, what):  # chip_smoke.check_close's bound, recorded
            err = (got.float() - want).abs()
            bad = int((err > 1e-2 * want.abs() + 2e-3).sum())
            if bad:
                fails.append(dict(what=what, values=bad, max_err=err.max().item()))
            return err.max().item()

        shapes = prefill_timings(torch, dev, check)
        print(json.dumps({"card": torch.cuda.get_device_name(0), "fails": fails,
                          "prefill": shapes}), flush=True)
        if fails:
            raise SystemExit(f"time_kernels: {len(fails)} checks failed: {fails}")
        return
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, HD, generator=g, device=dev).to(torch.bfloat16)
    out = {"card": torch.cuda.get_device_name(0), "slots": {}, "layered": {}, "sdpa": {}}
    k8 = torch.randint(-127, 128, (L, B, S, KV * HD), generator=g, device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, B, S, KV * HD), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand(L, B, S, 2 * KV, generator=g, device=dev) * 0.02 + 0.002
    for name, lens in SHAPES.items():
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        fn = lambda i: da.decode_attention_int8_slots(q, k8, v8, sc, lt, i % L)  # noqa: E731
        out["slots"][name] = dict(timings(fn), by_kernel_us=kernel_us(fn))
    del k8, v8, sc
    kb = torch.randn(L, B, KV, S, HD, generator=g, device=dev).to(torch.bfloat16)
    vb = torch.randn(L, B, KV, S, HD, generator=g, device=dev).to(torch.bfloat16)
    for name, lens in SHAPES.items():
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        fn = lambda i: da.decode_attention_layered(q, kb, vb, lt, i % L)  # noqa: E731
        out["layered"][name] = dict(timings(fn), by_kernel_us=kernel_us(fn))
        out["sdpa"][name] = dict(device_ms=graph_ms(sdpa_call(torch, q, kb, vb, lt)))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
