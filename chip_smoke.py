#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (project_morpheus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 1, no result lines):

1. build the CUDA kernels from ``project_morpheus_tpu_torch/ops/csrc``;
2. hold each kernel against its plain PyTorch twin at the Orpheus-3B
   serving shapes (8 slots x 8192 positions, all live, then mixed live
   lengths with garbage past each slot's frontier, then one slot past the
   capacity) at layers 0 and 27, and time it at the mixed and all-live
   shapes with ``tools/time_kernels.py``: device time per call from a CUDA
   graph of 28 calls, the wrapper's host time per call, the bound, and
   the twin's and (where one exists) the PyTorch library call's time;
   then check them at the Orpheus-1B head shape (HD=64, G=4);
3. hold the port's decode path on the card (bf16, int8 weights, CUDA
   kernels, int8 and bf16 caches) against the same path on the CPU (fp32,
   plain twins) on a small model;
4. serve Orpheus-3B (int8 weights, int8 KV cache, 8 slots x 8192) through
   ``ServingRuntime`` and ``LocalTorchAdapter``: one ~2,500-token prompt
   (three prefill chunks, decode bucket >= 2048, so the slot kernel runs)
   and three short ones, 7 x 24 tokens each; streamed PCM is checked and
   TTFA, tokens/s and real-time factor printed;
5. serve the 3B widths at 4 layers with a bf16 cache and
   ``attn_impl="kernel"``, so the layered kernel runs in decode;
6. answer one ``POST /v1/audio/speech`` from the port's server on
   localhost with a RIFF WAV.

Kernel launch counts are zeroed just before phases 4 and 5 and read just
after them.  The last lines are the card's name and power limit, one JSON
line describing every kernel, and ``{"ok": true, "device": {...}}``.
Without a CUDA card, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time
import traceback

H100_BYTES_PER_S = 3.35e12   # H100 SXM data sheet: HBM3 bandwidth
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_close(got, want, what: str) -> float:
    """bf16 kernel output vs fp32 twin: |err| <= 1e-2 |ref| + 2e-3 (bf16
    rounding of the output plus summation order)."""
    err = (got.float() - want).abs()
    bad = err > 1e-2 * want.abs() + 2e-3
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} values off, max err {err.max().item():.3e}")
    return err.max().item()


# ------------------------------------------------------------ phase 2


def shape_timings(torch, dev, fn_for, nbytes_for, ops_for, library_for=None):
    """Per timed shape: device ms (CUDA graph), host us, the old events
    reading, bound and bound fraction, and the library call's device ms."""
    from project_morpheus_tpu_torch.tools import time_kernels as tk

    out = {}
    for name, lens in tk.SHAPES.items():
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        fn = fn_for(lt)
        t = tk.timings(fn)
        b_ms, b_by = bound(nbytes_for(sum(lens)), ops_for(sum(lens)))
        rec = dict(live=sum(lens), device_ms=t["device_ms"], host_us=t["host_us"],
                   events_ms=t["events_ms"], bound_ms=b_ms, bound_by=b_by,
                   bound_frac=b_ms / t["device_ms"], library_ms=None)
        if library_for is not None:
            rec["library_ms"] = tk.graph_ms(library_for(lt))
        out[name] = rec
    return out


def kernel_record(name, source, replaces, err, plain, shapes):
    mixed = shapes["mixed"]
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
                max_abs_err=err, ms=mixed["device_ms"], plain_ms=plain,
                bound_ms=mixed["bound_ms"], bound_by=mixed["bound_by"],
                library_ms=mixed["library_ms"], shapes=shapes)


def log_shapes(name, shapes):
    for shape, r in shapes.items():
        lib = "" if r["library_ms"] is None else f", sdpa {r['library_ms']:.4f} ms"
        log(f"  {name} [{shape}, {r['live']} live]: device {r['device_ms']:.4f} ms/call, "
            f"host {r['host_us']:.1f} us/call, events {r['events_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({100 * r['bound_frac']:.1f}%){lib}")


def phase_kernels(torch, da, dev):
    """Each kernel vs its twin at the 3B shapes; returns kernel records."""
    from project_morpheus_tpu_torch.tools import time_kernels as tk

    g = torch.Generator(device=dev).manual_seed(0)
    L, B, S, KV, HD, H = tk.L, tk.B, tk.S, tk.KV, tk.HD, tk.H
    mixed = tk.SHAPES["mixed"]
    # checked at the timed shapes, and with the last slot past the capacity
    sets = {name: torch.tensor(v, dtype=torch.int32, device=dev) for name, v in tk.SHAPES.items()}
    sets["past_capacity"] = torch.tensor(mixed[:-1] + [S + 100], dtype=torch.int32, device=dev)
    q = torch.randn(B, H, HD, generator=g, device=dev).to(torch.bfloat16)
    q_bytes = 2 * B * H * HD * 2 + B * 4  # q in, out, lengths
    ops = lambda live: 4.0 * live * H * HD  # q.k and p.v, multiply-add each
    records = []

    def check_sets(run, twin, what, garbage):
        """All live first, on clean data; then garbage past each mixed
        frontier, and the mixed and past-capacity sets."""
        err = 0.0
        for name in ("all_live", "mixed", "past_capacity"):
            if name == "mixed":
                garbage()
            for layer in (0, L - 1):
                got, want = run(sets[name], layer), twin(sets[name], layer)
                torch.cuda.synchronize()
                err = max(err, check_close(got, want, f"{what}, {name}, layer {layer}"))
                if bool(got[0].float().abs().max() == 0):
                    raise AssertionError(f"{what} wrote zeros for a live slot")
        return err

    # kernel 3: int8 slots over the flat position-major cache
    k8 = torch.randint(-127, 128, (L, B, S, KV * HD), generator=g, device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, B, S, KV * HD), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand(L, B, S, 2 * KV, generator=g, device=dev) * 0.02 + 0.002

    def garbage8():
        for b, n in enumerate(mixed):
            k8[:, b, n:], v8[:, b, n:], sc[:, b, n:] = 127, -127, 1e3

    err = check_sets(lambda lt, i: da.decode_attention_int8_slots(q, k8, v8, sc, lt, i),
                     lambda lt, i: da.decode_attention_int8_slots_plain(q.float(), k8, v8, sc, lt, i),
                     "int8 slot kernel", garbage8)
    plain = tk.events_ms(lambda i: da.decode_attention_int8_slots_plain(
        q, k8, v8, sc, sets["mixed"], i % L), 5)
    shapes = shape_timings(
        torch, dev, lambda lt: (lambda i: da.decode_attention_int8_slots(q, k8, v8, sc, lt, i % L)),
        lambda live: q_bytes + live * (2 * KV * HD + 2 * KV * 4), ops)
    records.append(kernel_record(
        "decode_attention_int8_slots",
        "project_morpheus_tpu_torch/ops/csrc/decode_attention_int8_slots.cu",
        "project_morpheus_tpu/ops/decode_attention.py:355", err, plain, shapes))
    log(f"kernel decode_attention_int8_slots: max_abs_err {err:.3e}, twin {plain:.3f} ms")
    log_shapes("decode_attention_int8_slots", shapes)

    # int8 branch of the layered kernel (template flag), two layers
    k8h = k8[:2].view(2, B, S, KV, HD).transpose(2, 3).contiguous()
    v8h = v8[:2].view(2, B, S, KV, HD).transpose(2, 3).contiguous()
    ksh = sc[:2, ..., :KV].transpose(2, 3).contiguous()
    vsh = sc[:2, ..., KV:].transpose(2, 3).contiguous()
    del k8, v8, sc
    e8 = 0.0
    for name in ("mixed", "past_capacity"):
        got = da.decode_attention_layered(q, k8h, v8h, sets[name], 1, k_scale=ksh, v_scale=vsh)
        want = da.decode_attention_layered_plain(q.float(), k8h, v8h, sets[name], 1, ksh, vsh)
        torch.cuda.synchronize()
        e8 = max(e8, check_close(got, want, f"layered kernel, int8 cache, {name}"))
    log(f"kernel decode_attention_layered (int8 cache): max_abs_err {e8:.3e}")
    del k8h, v8h, ksh, vsh

    # kernel 2: layered bf16 over the head-major cache; kernel 1 is it at L = 1
    kb = torch.randn(L, B, KV, S, HD, generator=g, device=dev).to(torch.bfloat16)
    vb = torch.randn(L, B, KV, S, HD, generator=g, device=dev).to(torch.bfloat16)

    def garbage16():
        for b, n in enumerate(mixed):
            kb[:, b, :, n:], vb[:, b, :, n:] = 1e4, -1e4

    err = check_sets(lambda lt, i: da.decode_attention_layered(q, kb, vb, lt, i),
                     lambda lt, i: da.decode_attention_layered_plain(q.float(), kb, vb, lt, i),
                     "layered kernel", garbage16)
    got = da.decode_attention(q, kb[5], vb[5], sets["mixed"])
    want = da.decode_attention_layered_plain(q.float(), kb, vb, sets["mixed"], 5)
    torch.cuda.synchronize()
    err = max(err, check_close(got, want, "single-layer entry"))
    plain = tk.events_ms(lambda i: da.decode_attention_layered_plain(
        q, kb, vb, sets["mixed"], i % L), 5)
    shapes = shape_timings(
        torch, dev, lambda lt: (lambda i: da.decode_attention_layered(q, kb, vb, lt, i % L)),
        lambda live: q_bytes + live * 2 * KV * HD * 2, ops,
        library_for=lambda lt: tk.sdpa_call(torch, q, kb, vb, lt))
    records.append(kernel_record(
        "decode_attention_layered",
        "project_morpheus_tpu_torch/ops/csrc/decode_attention_layered.cu",
        "project_morpheus_tpu/ops/decode_attention.py:149", err, plain, shapes))
    log(f"kernel decode_attention_layered: max_abs_err {err:.3e}, twin {plain:.3f} ms")
    log_shapes("decode_attention_layered", shapes)
    del kb, vb
    torch.cuda.empty_cache()
    return records


def phase_1b_heads(torch, da, dev) -> float:
    """The kernels at the Orpheus-1B head shape (HD=64, G=4) on a small
    cache, lengths 0 to past the capacity, against their twins."""
    g = torch.Generator(device=dev).manual_seed(1)
    L, B, S, KV, HD, G = 2, 6, 1024, 8, 64, 4
    lens = torch.tensor([0, 1, 65, 700, S, S + 100], dtype=torch.int32, device=dev)
    q = torch.randn(B, KV * G, HD, generator=g, device=dev).to(torch.bfloat16)
    k8 = torch.randint(-127, 128, (L, B, S, KV * HD), generator=g, device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, B, S, KV * HD), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand(L, B, S, 2 * KV, generator=g, device=dev) * 0.02
    kb = torch.randn(L, B, KV, S, HD, generator=g, device=dev).to(torch.bfloat16)
    vb = torch.randn(L, B, KV, S, HD, generator=g, device=dev).to(torch.bfloat16)
    k8h = k8.view(L, B, S, KV, HD).transpose(2, 3).contiguous()
    v8h = v8.view(L, B, S, KV, HD).transpose(2, 3).contiguous()
    ksh = sc[..., :KV].transpose(2, 3).contiguous()
    vsh = sc[..., KV:].transpose(2, 3).contiguous()
    cases = {
        "int8 slot kernel": (da.decode_attention_int8_slots(q, k8, v8, sc, lens, 1),
                             da.decode_attention_int8_slots_plain(q.float(), k8, v8, sc, lens, 1)),
        "layered kernel, bf16": (da.decode_attention_layered(q, kb, vb, lens, 1),
                                 da.decode_attention_layered_plain(q.float(), kb, vb, lens, 1)),
        "layered kernel, int8": (
            da.decode_attention_layered(q, k8h, v8h, lens, 1, k_scale=ksh, v_scale=vsh),
            da.decode_attention_layered_plain(q.float(), k8h, v8h, lens, 1, ksh, vsh)),
    }
    torch.cuda.synchronize()
    err = 0.0
    for what, (got, want) in cases.items():
        err = max(err, check_close(got, want, f"{what} at HD=64, G=4"))
        if not bool((got[0] == 0).all()):
            raise AssertionError(f"{what} at HD=64, G=4: a slot of length 0 is not zeros")
    log(f"kernels at the 1B head shape (HD=64, G=4): max_abs_err {err:.3e}")
    return err


# ------------------------------------------------------------ phase 3


def phase_reference(torch, dev):
    """Decode path on the card (bf16, kernels) vs on the CPU (fp32, twins)."""
    from project_morpheus_tpu_torch.model import LlamaConfig
    from project_morpheus_tpu_torch.model import llama
    from project_morpheus_tpu_torch.model.quant import quantize_params_int8

    cfg = LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=6, num_kv_heads=2, head_dim=128, max_seq_len=512,
                      rope_scaling_factor=1.0)
    cpu_params = quantize_params_int8(llama.init_llama_params(cfg, 7, "cpu", torch.float32))

    card_params = {
        "embed": {k: v.to(dev) for k, v in cpu_params["embed"].items()},
        "ln_f": cpu_params["ln_f"].to(dev, torch.bfloat16),
        "layers": {k: ({"q": v["q"].to(dev), "scale": v["scale"].to(dev)} if isinstance(v, dict)
                       else v.to(dev, torch.bfloat16))
                   for k, v in cpu_params["layers"].items()},
    }
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(3, 1000, (2, 40), generator=g, dtype=torch.int32)
    steps = torch.randint(3, 1000, (3, 2), generator=g, dtype=torch.int32)
    worst = 0.0
    for cache_dtype in (torch.int8, torch.bfloat16):
        outs = []
        for params, d in ((card_params, dev), (cpu_params, torch.device("cpu"))):
            cdt = cache_dtype if cache_dtype == torch.int8 or d.type == "cuda" else torch.float32
            cache = llama.init_kv_cache(cfg, 2, 512, cdt, d)
            logits = []
            for b in range(2):
                logits.append(llama.llama_prefill_chunk(
                    params, prompt[b].to(d), cfg, cache, 0, b, 40, hist_bucket=64, w8a8=True))
            lengths = torch.full((2,), 40, dtype=torch.int32, device=d)
            for s in range(3):
                logits += list(llama.llama_decode_step(
                    params, steps[s].to(d), cfg, cache, lengths, attn_impl="kernel"))
                lengths = lengths + 1
            outs.append(torch.stack(logits).float().cpu())
        rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
        worst = max(worst, rel)
        name = "int8" if cache_dtype == torch.int8 else "bf16"
        if not (torch.isfinite(outs[0]).all() and rel < 5e-2):
            raise AssertionError(f"card vs CPU logits, {name} cache: relative L2 error {rel:.3e}")
        log(f"reference ({name} cache): card vs CPU logits relative L2 error {rel:.3e} (limit 5e-2)")
    return worst


# ------------------------------------------------------------ phases 4-6


async def pull_all(adapter, chunk: int = 4096):
    """Pull one utterance; returns (pcm bytes, seconds to first audio)."""
    t0 = time.perf_counter()
    ttfa, data = None, bytearray()
    while True:
        c = await adapter.pull(chunk)
        if c.pcm and ttfa is None:
            ttfa = time.perf_counter() - t0
        data += c.pcm
        if c.eos:
            return bytes(data), ttfa


def check_pcm(np, pcm: bytes, hops: int, hop_bytes: int, what: str):
    if len(pcm) != hops * hop_bytes:
        raise AssertionError(f"{what}: {len(pcm)} PCM bytes, expected {hops} hops of {hop_bytes}")
    x = np.frombuffer(pcm, np.int16)
    if x.std() == 0:
        raise AssertionError(f"{what}: silent PCM")


async def serve(prompts, max_tokens):
    from project_morpheus_tpu_torch.adapters.local_torch import LocalTorchAdapter
    from project_morpheus_tpu_torch.model.sampling import SamplingParams

    sp = SamplingParams(max_tokens=max_tokens)
    adapters = [LocalTorchAdapter(p, sampling=sp) for p in prompts]
    t0 = time.perf_counter()
    out = await asyncio.gather(*[pull_all(a) for a in adapters])
    return out, time.perf_counter() - t0


async def phase_http(card, np):
    import aiohttp
    from aiohttp import web

    from project_morpheus_tpu_torch.server.app import create_app

    runner = web.AppRunner(create_app(generation={"max_tokens": 7 * 8}))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    try:
        async with aiohttp.ClientSession() as s:
            async with s.post(f"http://127.0.0.1:{port}/v1/audio/speech",
                              json={"input": "Hello from the card.", "voice": "tara"}) as r:
                status, ctype, body = r.status, r.headers.get("Content-Type"), await r.read()
    finally:
        await runner.cleanup()
    if status != 200 or ctype != "audio/wav" or body[:4] != b"RIFF" or body[8:12] != b"WAVE":
        raise AssertionError(f"speech request: status {status}, type {ctype}, head {body[:12]!r}")
    check_pcm(np, body[44:], 8, 4096, "HTTP speech")
    log(f"http: POST /v1/audio/speech -> RIFF WAV, {len(body) - 44} PCM bytes [{card}]")


async def serving_phases(card: str, records) -> None:
    """Phases 4-6 in one event loop (the engines' queues live in it)."""
    import numpy as np
    import torch

    from project_morpheus_tpu_torch.adapters import runtime as rt
    from project_morpheus_tpu_torch.model.tokenizer import format_prompt_ids
    from project_morpheus_tpu_torch.ops import decode_attention as da
    from project_morpheus_tpu_torch.tools.profile_serving import (
        LONG_PROMPT, PROMPTS, TOKENS_PER_REQUEST, serving_runtime)

    # phase 4: the 3B int8 serving path (the workload profile_serving traces)
    t0 = time.perf_counter()
    rt3 = serving_runtime()
    torch.cuda.synchronize()
    log(f"3b runtime built in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card)")
    prompts = list(PROMPTS)
    n_long = len(format_prompt_ids(LONG_PROMPT, "tara"))
    if not 2048 < n_long <= 3072:
        raise AssertionError(f"long prompt is {n_long} tokens")
    da.reset_launch_counts()
    out, wall = await serve(prompts, TOKENS_PER_REQUEST)
    torch.cuda.synchronize()
    launches = dict(da.LAUNCHES)
    fs = rt3.snac_cfg.frame_samples
    for i, (pcm, _) in enumerate(out):
        check_pcm(np, pcm, TOKENS_PER_REQUEST // 7, 2 * fs, f"3b request {i}")
    if launches["decode_attention_int8_slots"] <= 0:
        raise AssertionError(f"3b int8 decode never launched the slot kernel: {launches}")
    records[0]["launches"] = launches["decode_attention_int8_slots"]
    audio_s = sum(len(p) for p, _ in out) / 2 / 24000
    ttfa = [t for _, t in out]
    log(f"serve 3b int8/int8-KV: {len(prompts)} requests (long prompt {n_long} tokens), "
        f"TTFA {' / '.join(f'{t:.3f}' for t in ttfa)} s, "
        f"{len(prompts) * TOKENS_PER_REQUEST / wall:.1f} tokens/s, "
        f"real-time factor {audio_s / wall:.3f} ({audio_s:.2f} s audio in {wall:.2f} s), "
        f"decode steps {rt3.engine.steps}, launches {launches} [{card}]")

    # phase 5: bf16 cache, kernel attention, 3B widths at 4 layers
    os.environ["ORPHEUS_KV_QUANT"] = "bfloat16"
    rt4 = rt.ServingRuntime(device="cuda", num_layers=4, attn_impl="kernel",
                            banded_sampling=True)
    rt.set_runtime(rt4)
    da.reset_launch_counts()
    out4, wall4 = await serve(["Bf16 cache decode.", "Second stream."], 7 * 8)
    torch.cuda.synchronize()
    launches4 = dict(da.LAUNCHES)
    for i, (pcm, _) in enumerate(out4):
        check_pcm(np, pcm, 8, 2 * fs, f"bf16-cache request {i}")
    if launches4["decode_attention_layered"] <= 0:
        raise AssertionError(f"bf16-cache decode never launched the layered kernel: {launches4}")
    records[1]["launches"] = launches4["decode_attention_layered"]
    log(f"serve 3b widths x 4 layers, bf16 KV, kernel attention: {wall4:.2f} s, "
        f"launches {launches4} [{card}]")
    await rt4.engine.close()

    # phase 6: one HTTP request through the port's server (3B int8 runtime)
    rt.set_runtime(rt3)
    await phase_http(card, np)
    await rt3.engine.close()


def run(card: str) -> None:
    import torch

    from project_morpheus_tpu_torch.ops import build, decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    secs = build.build_all()
    log(f"build: {secs:.2f} s for {len(build.SOURCES)} CUDA sources (sm_90a, nvcc in parallel)")
    for src, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line:
                log(f"  {src}: {line.strip()}")

    records = phase_kernels(torch, da, dev)
    phase_1b_heads(torch, da, dev)
    phase_reference(torch, dev)

    asyncio.run(serving_phases(card, records))

    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        import project_morpheus_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout of the repository", file=sys.stderr)
        return 2
    try:
        card = card_line()
        log(f"card: {card}")
        run(card)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
