"""Device time of the kernels, apart from their wrappers' host time.

    python -m project_morpheus_tpu_torch.tools.time_kernels [prefill | w8a8 | trunk [MODEL ...]]
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
inputs as a yardstick (graph-timed the same way; the port never calls it),
each beside its byte bound (``decode_bytes`` at 3.35 TB/s); then the
layered kernel the same way at the benchmark trunks' shapes
(``TRUNK_DIMS``) and their cells' live lengths (``TRUNK_SHAPES``).
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

With ``trunk [MODEL ...]`` it checks and times the decode trunk's three
kernels and the plain op chains they replaced at ``TRUNK_CONFIGS``
(``trunk_timings``), then a layer's whole chain between its attention
calls both ways, and prints the records as text and one JSON line.

With ``w8a8-ab TAG [ROWS]`` (rows comma-separated, default ``W8A8_ROWS``)
it prints ``TAG`` and one JSON object of the GEMM's and the quantize's
device ms a call (``w8a8_ab_times``) at the four 3B weights: copied into a
``git archive`` of a parent commit and run there in turns with this tree
(parent, change, change, parent), it compares the two in one call.
"""
from __future__ import annotations

import importlib
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

# the benchmark trunks' decode attention (a bf16 cache: the layered
# kernel), (L, B, S, KV, HD, H), at the live lengths of one decode step in
# each of their cells: chat ~11 streams at 60-700 positions, clone 12 at
# 1,400-2,800, read 8 readers at 60-730 (PERF.md sections 4-5), idle slots
# at one position (serving attends lengths + 1); every slot at 2,048 and at
# the capacity; and every slot at one position, the call's floor at the
# same grid (launch, one tile a block, the merge's launch)
TRUNK_DIMS = {"smollm2-1.7b": (24, 16, 8192, 32, 64, 32),
              "mistral-7b-v0.3": (32, 8, 8192, 8, 128, 32)}
TRUNK_SHAPES = {
    "smollm2-1.7b": {
        "chat": [1] * 5 + [60, 120, 180, 240, 300, 330, 360, 420, 480, 560, 700],
        "clone": [1] * 4 + [1400, 1530, 1660, 1790, 1920, 2050, 2180, 2310, 2440, 2570, 2700,
                            2800],
        "all_2048": [2048] * 16,
        "all_live": [8192] * 16,
        "floor": [1] * 16,
    },
    "mistral-7b-v0.3": {
        "read": [60, 150, 250, 350, 450, 550, 650, 730],
        "all_2048": [2048] * 8,
        "all_live": [8192] * 8,
        "floor": [1] * 8,
    },
}

# the trunk kernels' widths (ops/decode_trunk.py): the benchmark trunks and
# Orpheus-3B, as LlamaConfig fields beside the slots each serves
TRUNK_CONFIGS = {
    "smollm2-1.7b": (16, dict(num_layers=24, hidden_size=2048, intermediate_size=8192,
                              num_heads=32, num_kv_heads=32, head_dim=64, rope_theta=130000.0,
                              rope_scaling_factor=1.0)),
    "mistral-7b-v0.3": (8, dict(num_layers=32, hidden_size=4096, intermediate_size=14336,
                                num_heads=32, num_kv_heads=8, head_dim=128, rope_theta=1e6,
                                rope_scaling_factor=1.0)),
    "orpheus-3b": (8, {}),
}


def trunk_config(name: str, **kw):
    """The ``LlamaConfig`` of a ``TRUNK_CONFIGS`` model, ``kw`` overriding."""
    from ..model import LlamaConfig

    return LlamaConfig(**{**TRUNK_CONFIGS[name][1], **kw})


def decode_bytes(lens, KV: int, HD: int, S: int, H: int, quant: bool = False) -> int:
    """Bytes one decode-attention call needs: each slot's live K and V rows
    (and int8 scales) once, q in and the output once."""
    row = 2 * KV * HD * (1 if quant else 2) + (2 * KV * 4 if quant else 0)
    return sum(min(n, S) for n in lens) * row + 2 * len(lens) * H * HD * 2


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


def layered_timings(torch, da, dev, dims, shapes) -> dict:
    """The layered kernel over a random bf16 cache of ``dims`` (L, B, S,
    KV, HD, H) at each of ``shapes`` (name -> live lengths): ``timings``,
    the device us of each CUDA kernel, the byte bound (3.35 TB/s), SDPA's
    device ms on the same inputs (``library_ms``) and, at the first shape,
    the plain twin's ms (events around 3 eager calls)."""
    L_, B_, S_, KV_, HD_, H_ = dims
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(B_, H_, HD_, generator=g, device=dev).to(torch.bfloat16)
    kb = torch.randn(L_, B_, KV_, S_, HD_, generator=g, device=dev).to(torch.bfloat16)
    vb = torch.randn(L_, B_, KV_, S_, HD_, generator=g, device=dev).to(torch.bfloat16)
    out = {}
    for n, (name, lens) in enumerate(shapes.items()):
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        fn = lambda i: da.decode_attention_layered(q, kb, vb, lt, i % L_)  # noqa: E731
        rec = dict(timings(fn), by_kernel_us=kernel_us(fn),
                   bound_ms=decode_bytes(lens, KV_, HD_, S_, H_) / 3.35e9,
                   library_ms=graph_ms(sdpa_call(torch, q, kb, vb, lt)))
        if n == 0:
            rec["plain_ms"] = events_ms(
                lambda i: da.decode_attention_layered_plain(q, kb, vb, lt, i % L_), 3)
        out[name] = rec
    del q, kb, vb
    torch.cuda.empty_cache()
    return out


def trunk_bytes(rows: int, cfg) -> dict:
    """Bytes each trunk kernel's call needs: its inputs read once and its
    outputs written once (``ops/decode_trunk.py``)."""
    D, F_, H, KV, HD = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                        cfg.num_kv_heads, cfg.head_dim)
    return {"add_rmsnorm": 2 * (4 * rows * D + D),  # x, d, w in; x, h out
            "rope_kv_write": 2 * rows * ((H + 2 * KV) * HD * 2) + 4 * rows + 2 * HD,
            "swiglu": 2 * rows * 3 * F_}


def kernel_launches(fn, calls: int = 4) -> float:
    """CUDA kernels (and copies) launched a ``fn(i)``, from the torch
    profiler's trace of ``calls`` eager calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    n = 0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            n += evt.count
    return n / calls


def trunk_timings(torch, dev, models=None) -> dict:
    """The trunk kernels (``ops/decode_trunk.py``) at ``TRUNK_CONFIGS``'
    widths and slots, each checked against its twin and then timed
    (``timings``; ``graph_ms`` over ``GRAPH_CALLS`` calls, the model's
    layers cycled) beside its byte bound (``trunk_bytes`` at 3.35 TB/s),
    the plain op chain it replaced (graph-timed the same way) and the
    launches a call of each; then a layer's whole chain between its
    attention calls (add + norm, the wqkv GEMV, RoPE + write, the wo GEMV,
    add + norm, the wgu GEMV, SwiGLU, the wd GEMV) over random int8 weights
    of every layer, through the kernels and through the plain ops.  Returns
    {model: {name: record}}."""
    from ..model import llama as tl
    from ..ops import decode_trunk as dt
    from ..ops import int8_gemv as ig

    out = {}
    for model in models or TRUNK_CONFIGS:
        rows = TRUNK_CONFIGS[model][0]
        cfg = trunk_config(model)
        L_, D, F_, H_, KV_, HD_ = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                                   cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        S_, eps, bf = 8192, cfg.rms_eps, torch.bfloat16
        g = torch.Generator(device=dev).manual_seed(2)

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

        x, d, ws = rnd(rows, 1, D), rnd(rows, 1, D) * 0.01, rnd(L_, D) * 0.1 + 1
        qkv, gu = rnd(rows, 1, (H_ + 2 * KV_) * HD_, scale=3.0), rnd(rows, 1, 2 * F_, scale=4.0)
        lengths = torch.randint(60, 2800, (rows,), generator=g, device=dev, dtype=torch.int32)
        inv = tl.rope_inv_freqs(cfg, dev)
        ck, cv = rnd(L_, rows, KV_, S_, HD_), rnd(L_, rows, KV_, S_, HD_)

        def split(qkv):
            return dt.split_qkv(qkv, KV_, HD_)

        cases = {
            "add_rmsnorm": (lambda i: dt.add_rmsnorm(x, d, ws[i % L_], eps),
                            lambda i: tl.rmsnorm(x + d, ws[i % L_], eps),
                            lambda: (dt.add_rmsnorm(x.clone(), d, ws[0], eps),
                                     tl.rmsnorm(x + d, ws[0], eps))),
            "rope_kv_write": (lambda i: dt.rope_kv_write(qkv, lengths, inv, ck, cv, i % L_),
                              lambda i: dt.rope_kv_write_plain(*split(qkv), lengths, inv, ck, cv,
                                                               i % L_),
                              lambda: (dt.rope_kv_write(qkv, lengths, inv, ck, cv, 0),
                                       dt.rope_kv_write_plain(*split(qkv), lengths, inv, ck, cv,
                                                              0))),
            "swiglu": (lambda i: dt.swiglu(gu, F_), lambda i: dt.swiglu_plain(gu, F_),
                       lambda: (dt.swiglu(gu, F_), dt.swiglu_plain(gu, F_))),
        }
        bytes_ = trunk_bytes(rows, cfg)
        recs = {}
        for name, (kern, plain, pair) in cases.items():
            got, want = pair()
            err = (got.float() - want.float()).abs()
            rec = dict(timings(kern), bound_ms=bytes_[name] / 3.35e9,
                       plain_ms=graph_ms(plain), launches=kernel_launches(kern),
                       plain_launches=kernel_launches(plain),
                       equal_share=float((got == want).float().mean()),
                       max_rel_err=float((err / want.float().abs().clamp(min=1e-30)).max()))
            rec["share"] = rec["bound_ms"] / rec["device_ms"]
            recs[name] = rec
        del ck, cv
        # a layer's chain between its attention calls, over int8 weights
        mats = {"wqkv": (D, (H_ + 2 * KV_) * HD_), "wo": (H_ * HD_, D),
                "wgu": (D, 2 * F_), "wd": (F_, D)}
        w8 = {n: torch.randint(-127, 128, (L_, *kn), generator=g, device=dev, dtype=torch.int8)
              for n, kn in mats.items()}
        wsc = {n: torch.rand(L_, kn[1], generator=g, device=dev) * 2e-3 + 1e-4
               for n, kn in mats.items()}
        ck, cv = rnd(L_, rows, KV_, S_, HD_), rnd(L_, rows, KV_, S_, HD_)
        attn = rnd(rows, 1, H_ * HD_)

        def mm(h, n, i):
            return ig.int8_gemv(h, w8[n][i], wsc[n][i])

        def fused_layer(i):
            h = dt.add_rmsnorm(x, d, ws[i % L_], eps)
            dt.rope_kv_write(mm(h, "wqkv", i % L_), lengths, inv, ck, cv, i % L_)
            h = dt.add_rmsnorm(x, mm(attn, "wo", i % L_), ws[i % L_], eps)
            return mm(dt.swiglu(mm(h, "wgu", i % L_), F_), "wd", i % L_)

        def plain_layer(i):
            xx = x + d
            h = tl.rmsnorm(xx, ws[i % L_], eps)
            dt.rope_kv_write_plain(*split(mm(h, "wqkv", i % L_)), lengths, inv, ck, cv, i % L_)
            xx = xx + mm(attn, "wo", i % L_)
            h = tl.rmsnorm(xx, ws[i % L_], eps)
            return mm(dt.swiglu_plain(mm(h, "wgu", i % L_), F_), "wd", i % L_)

        layer_bytes = sum(k * n for k, n in mats.values()) + sum(bytes_.values()) + 2 * rows * D
        recs["layer"] = dict(device_ms=graph_ms(fused_layer, L_, 5),
                             plain_ms=graph_ms(plain_layer, L_, 5),
                             bound_ms=layer_bytes / 3.35e9, launches=kernel_launches(fused_layer),
                             plain_launches=kernel_launches(plain_layer))
        recs["layer"]["share"] = recs["layer"]["bound_ms"] / recs["layer"]["device_ms"]
        del w8, wsc, ck, cv
        torch.cuda.empty_cache()
        out[model] = dict(rows=rows, layers=L_, **recs)
    return out


def main() -> None:
    import sys

    import torch

    from project_morpheus_tpu_torch.ops import build

    da = importlib.import_module("project_morpheus_tpu_torch.ops.decode_attention")

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
    if sys.argv[1:2] == ["trunk"]:
        shapes = trunk_timings(torch, dev, sys.argv[2:] or None)
        for model, recs in shapes.items():
            for name, r in recs.items():
                if not isinstance(r, dict):
                    continue
                print(f"trunk {model} {name}: {r['device_ms'] * 1e3:.2f} us, bound "
                      f"{r['bound_ms'] * 1e3:.3f} us ({100 * r['share']:.1f}%), host "
                      f"{r.get('host_us', float('nan')):.1f} us, plain {r['plain_ms'] * 1e3:.2f} "
                      f"us; launches {r['launches']:.1f} / plain {r['plain_launches']:.1f}; "
                      f"equal {r.get('equal_share')}, max rel err {r.get('max_rel_err')}",
                      flush=True)
        print(json.dumps({"card": torch.cuda.get_device_name(0), "trunk": shapes}), flush=True)
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
    out = {"card": torch.cuda.get_device_name(0), "slots": {}}
    k8 = torch.randint(-127, 128, (L, B, S, KV * HD), generator=g, device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, B, S, KV * HD), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand(L, B, S, 2 * KV, generator=g, device=dev) * 0.02 + 0.002
    for name, lens in SHAPES.items():
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        fn = lambda i: da.decode_attention_int8_slots(q, k8, v8, sc, lt, i % L)  # noqa: E731
        out["slots"][name] = dict(timings(fn), by_kernel_us=kernel_us(fn),
                                  bound_ms=decode_bytes(lens, KV, HD, S, H, True) / 3.35e9)
    del q, k8, v8, sc
    out["layered"] = layered_timings(torch, da, dev, (L, B, S, KV, HD, H), SHAPES)
    for model, shapes in TRUNK_SHAPES.items():
        out[model] = layered_timings(torch, da, dev, TRUNK_DIMS[model], shapes)
    for part in ["slots", "layered", *TRUNK_SHAPES]:
        for name, r in out[part].items():
            r["share"] = r["bound_ms"] / r["device_ms"]
            print(f"{part} {name}: {r['device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({100 * r['share']:.1f}%), host {r['host_us']:.1f} us, plain "
                  f"{r.get('plain_ms')}, library {r.get('library_ms')}, by kernel "
                  f"{r['by_kernel_us']}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
