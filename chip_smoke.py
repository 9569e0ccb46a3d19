#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (project_morpheus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 1, no result lines):

1. build the CUDA kernels from ``project_morpheus_tpu_torch/ops/csrc``;
2. hold each decode-attention kernel against its plain PyTorch twin at the
   Orpheus-3B serving shapes (8 slots x 8192 positions, all live, then
   mixed live lengths with garbage past each slot's frontier, then one slot
   past the capacity) at layers 0 and 27, and time it at the mixed and
   all-live shapes with ``tools/time_kernels.py``: device time per call
   from a CUDA graph of 28 calls, the wrapper's host time per call, the
   bound, and the twin's and (where one exists) the PyTorch library call's
   time; then check them at the Orpheus-1B head shape (HD=64, G=4);
   then the int8 chunk-prefill attention at a tensor-parallel rank's kv
   heads (one: Orpheus-3B and 1B at tp = 8; and 2, 4, 8) against its twin;
   then the int8 GEMV at the five 3B weight shapes (wqkv, wo, wgu, wd over
   28 stacked layers, and the tied lm_head), M = 1 and 8 rows: against its
   twin, and timed from CUDA graphs with a small dependent add between
   calls (less the add's own time: the kernel starts before the one ahead
   of it ends) beside its bound, its twin (the cast + matmul it replaces)
   and ``torch.matmul`` on a pre-cast bf16 weight; then the chunk-prefill
   attention kernel (``prefill_chunk_attention``) at the 3B head shape:
   C = 1024 ending at hist 1024, 4096 and 8192, C = 512 ending at hist
   8192, and the main path's rounds (C = 1024 at 1024 in hist 2048, C = 512
   at 2048 in hist 4096), J = 1 and 4, int8 and bf16 caches, garbage past
   each frontier, against its
   twin, each shape timed from a CUDA graph of 28 calls beside its bound
   (causal operations against bytes) and, for bf16, SDPA with the same
   causal mask over the gathered history; then the chunk prefill's w8a8
   quantize and GEMM (``ops/w8a8_gemm.py``) at the four 3B weights, the
   tp = 2 halves, a tp = 8 rank's shares, 1B's ``wk`` at tp = 8 and four
   N / K tails, M = 32 to 4096 rows and the tails 1, 33, 64, 65, 100,
   1000, equal to their plain versions bit for bit, eager and replayed
   from a CUDA graph, timed beside their bounds (the GEMM's operations at
   the int8 rate), the plain versions and, for the GEMM, ``torch._int_mm``
   on the (K, N) weight and on the K-major copy and ``torch.matmul`` on a
   pre-dequantized bf16 weight, and the quantize + GEMM pair with and
   without the dependent launch; the short rounds (32 and 128 rows)
   weight by weight beside the K-major ``_int_mm``; then the five int8
   scales that divide by 127, card against CPU at 3B shapes, dividing by
   the number 127.0 (reported) and by a tensor (which must not differ);
3. hold the port's decode path on the card (bf16, int8 weights, CUDA
   kernels, int8 and bf16 caches) against the same path on the CPU (fp32,
   plain twins) on a small model; then serve seeded requests on that model
   with frame programs replayed from CUDA graphs and run eagerly, greedy
   and at temperature 0.9: the tokens must be identical;
4. serve Orpheus-3B (int8 weights, int8 KV cache, 8 slots x 8192) through
   ``ServingRuntime`` and ``LocalTorchAdapter`` after ``engine.warmup``:
   one ~2,500-token prompt (three prefill chunks, decode bucket >= 2048, so
   the slot kernel runs) and three short ones, 7 x 24 tokens each, seeded;
   a burst of 4 equal ~1,300-token prompts (two prefill chunks each), which
   must run J-batched prefill rounds; then the first load again with
   ``frames_per_dispatch=2``, whose traces must equal the first run's.
   Each load prints ms per decode step, TTFA and real-time factor, and
   runs once more under the torch profiler for the device's idle share.
   Prefill rounds replay the CUDA graphs ``warmup`` captured (printed: how
   many, the graph pool's bytes, and the bytes of the weights' K-major
   copies for the w8a8 GEMM; none captured after warmup; the replays,
   host and device ms a round); the first load runs again, seeded and
   greedy, with prefill rounds eager: the same tokens;
5. serve the 3B widths at 4 layers with a bf16 cache and
   ``attn_impl="kernel"``, so the layered kernel runs in decode;
6. answer one ``POST /v1/audio/speech`` from the port's server on
   localhost with a RIFF WAV, with the 3B runtime switched to the server's
   ``attn_impl="auto"`` and warmed up for it: the short context's frames
   must replay the CUDA graphs of the dense int8 attention branch;
7. checkpoint serving: write a full-width 28-layer bf16 Orpheus-3B HF
   release directory (``config.json`` with the published key names and
   llama3 rope scaling, two safetensors shards and their index, a
   byte-level BPE ``tokenizer.json`` with Orpheus's added tokens) and a
   SNAC ``.npz`` with this script's own writers; build ``ServingRuntime``
   from ``ORPHEUS_CHECKPOINT_PATH``, ``ORPHEUS_TOKENIZER_PATH`` and
   ``ORPHEUS_SNAC_PATH`` (int8 weights, int8 KV cache): every loaded leaf
   must equal the written params bit for bit, and the config
   ``orpheus_3b()`` in every field the model reads; four seeded requests
   must give the same tokens and PCM as a runtime given the params
   directly; then the server on the loaded runtime (speech, ``/ws/tts``,
   ``/config``, ``/barge-in``, ``/adapters``, ``/sources``), and
   ``remote_sse`` against a local SSE stub replaying a served trace, whose
   PCM must equal the exact stream decoder's.  Prints the seconds to write
   and to load the files, the host's peak RSS during the load, and the
   TTFA of the first HTTP request on the loaded weights;
8. training, after the serving runtimes are freed (TF32 off): (a) a
   2-layer D=256 model in fp32, card vs CPU: loss and grads with dense
   and blockwise attention, the chunked-vocab loss vs the dense one, 3
   AdamW steps through ``make_train_step``; (b) the training attention at
   the 3B shape (H=24, KV=8, HD=128, S=8192, bf16, right padding): the
   card's SDPA path vs the plain blockwise twin, forward and dq/dk/dv,
   with the backend and the ms of each; (c) Orpheus-3B at full width,
   seq 8192, batch 1, 6 steps of ``train_loop`` (blockwise attention,
   per-layer recompute, chunked-vocab loss): finite losses, the last
   below the second; ms a step, tokens/s, peak memory and a ``train_mfu``
   line; (d) LoRA r=32 on the 3B base at seq 2048, 3 steps: the base
   bit-identical, the adapters moved; (e) the trained params merged with
   the adapters, saved in the port's format, served from
   ``ORPHEUS_CHECKPOINT_PATH`` (int8 weights and KV): tokens equal to a
   runtime handed the params; (f) kill/resume at 4 layers, seq 1024, in a
   process under ``torch.use_deterministic_algorithms``: equal losses and
   params; (g) the training CLI as a subprocess; (h) the SNAC encoder,
   card vs CPU in fp32: codes equal except at near-ties.  The training
   path runs no hand-written kernel; its attention is a library call;
9. the last modules: (a) the native PCM library built with g++; the 3B
   int8 runtime serves one greedy utterance to the port's ``Client`` over
   REST and ``/ws/tts``, and through an orchestrator with a PCM ring, with
   ``ORPHEUS_NATIVE_PCM`` unset and set: the PCM, the ring's bytes and the
   served hops stitched with a 10 ms crossfade must be equal; the
   orchestrator's timeline replays to the ring's PCM; the watermark
   embedded in six served utterances is detected with its key only;
   (b) on a world of one over NCCL, the 3B int8 engine on a 1 x 1 mesh,
   its collectives captured in CUDA graphs, prefill rounds too: phase 4's
   seeded traces must equal the unsharded engine's; (c) two ranks on the one card over gloo
   (``tp2_main``), Orpheus-3B at full width, int8 weights and KV, tp = 2,
   the slot kernel on each rank's 4 kv heads: every sharded GEMV shape and
   the slot kernel against their twins, one decode step's logits against
   the unsharded step's (``MESH_LOGIT_TOL``) and, closely
   (``MESH_TP_REF_TOL``), against the unsharded step computing each
   product and the attention at the ranks' shapes (``_tp_arithmetic``), while a planted fault (rank 1's wo scales x ``MESH_FAULT``) must
   exceed that limit; four greedy requests of 84
   tokens against the unsharded engine's (agreement and first divergence,
   reported), ms a step; (d) Orpheus-3B at seq 8192, phase 8's seed and
   batches, 2 steps of ``train_loop`` on a 1 x 1 mesh in ``fsdp`` and
   ``fsdp_tp``: losses equal to phase 8's; (e) the training CLI under
   ``torchrun --nproc_per_node 1``, run beside (c) and (d).

Kernel launch counts are zeroed just before the first run of phase 4 (the
main path), just before phase 5, just before phase 7's first seeded
load and just before phase 9's mesh engine (b) and each rank's TP engine
(c), and read just after each; launches inside replayed
CUDA graphs are counted through each graph's tally.  The last lines are the
GEMV's device ms a frame in the k=1 serving load, the card's name and power
limit, one JSON line describing every kernel (the chunk-prefill attention
the fourth, the w8a8 GEMM and quantize the fifth and sixth, each timed as
one 1,024-row prefill round's 112 calls), and
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

H100_BYTES_PER_S = 3.35e12   # H100 SXM data sheet: HBM3 bandwidth
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak (Hopper white paper)
H100_FP32_OPS_PER_S = 67e12   # fp32 outside the tensor cores


_T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - _T0:6.1f} s]", *a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def bound(nbytes: float, ops: float, ops_per_s: float = H100_BF16_OPS_PER_S):
    """(least ms, what bounds it): bytes over HBM bandwidth or operations
    over ``ops_per_s``, the peak rate of their type (bf16 by default)."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / ops_per_s
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


def phase_prefill_kv_heads(torch, dev) -> float:
    """The int8 chunk attention at a tensor-parallel rank's kv heads: one
    (Orpheus-3B at tp = 8: H = 3, HD = 128; Orpheus-1B at tp = 8: H = 4,
    HD = 64; a bf16 cache there too) and 2, 4 and 8 (G = 3, HD = 128), a
    1,024-row chunk at 0 and two 512-row chunks at 1,536 in a 2,048-position
    bucket with garbage past each frontier, against the twin
    (``check_close``)."""
    from project_morpheus_tpu_torch.ops import prefill_attention as pa
    from project_morpheus_tpu_torch.tools import time_kernels as tk

    g = torch.Generator(device=dev).manual_seed(13)
    B, S, hist = 4, 2048, 2048
    err, n = 0.0, 0
    for KV, G, HD in ((1, 3, 128), (1, 4, 64), (2, 3, 128), (4, 3, 128), (8, 3, 128)):
        for quant in ((True, False) if KV == 1 else (True,)):
            cache = tk.prefill_cache(torch, quant, dev, g, layers=1, slots=B, seq=S, kv=KV, hd=HD)
            layer = {name: t[0] for name, t in cache.items()}
            for slots, C, off in (([1], 1024, 0), ([3, 0], 512, hist - 512)):
                tk.prefill_garbage(cache, slots, off + C)
                st = torch.tensor(slots, dtype=torch.int32, device=dev)
                ot = torch.full((len(slots),), off, dtype=torch.int32, device=dev)
                q = torch.randn(len(slots), C, KV * G, HD, generator=g,
                                device=dev).to(torch.bfloat16)
                got = pa.prefill_chunk_attention(q, layer, st, ot, hist)
                want = pa.prefill_chunk_attention_plain(q, layer, st, ot, hist).float()
                torch.cuda.synchronize()
                what = (f"prefill attention, {'int8' if quant else 'bf16'} cache, KV={KV}, "
                        f"H={KV * G}, HD={HD}, J={len(slots)} C={C} at {off}")
                err = max(err, check_close(got, want, what))
                n += 1
            del cache
    log(f"kernel prefill_chunk_attention at one kv head (3B and 1B at tp = 8) and at 2, 4, 8: "
        f"{n} shapes within check_close, max_abs_err {err:.3e}")
    return err


def phase_int8_scales(torch, dev) -> None:
    """The five int8 scales that divide by 127 (the KV cache's, the dense
    int8 branch's query and probability scales, the weights' and the
    embedding's) at Orpheus-3B shapes, on the card against the same function
    on the CPU: the share that differ with the division by a Python number
    the code had (PyTorch's CUDA division by a number multiplies by its
    reciprocal) and with the division the sites now make
    (``quant.div127``), which must be 0."""
    from project_morpheus_tpu_torch.model import LlamaConfig, llama, quant

    cfg = LlamaConfig.orpheus_3b()
    KV, HD, D = cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    G = cfg.num_heads // KV
    g = torch.Generator(device=dev).manual_seed(17)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    vs = torch.rand(8, KV, 1, 2048, generator=g, device=dev) * 0.02 + 0.002
    sites = {  # name: (the site now, the site as it divided before, an input)
        "quantize_kv (a chunk's K, 1024 x 8 heads)": (
            lambda x: llama.quantize_kv(x)[1],
            lambda x: torch.clamp(x.abs().amax(dim=-1) / 127.0, min=1e-8),
            rnd(1024, KV, HD).to(torch.bfloat16).float()),
        "dense q scales (64 steps x 8 slots)": (
            llama.int8_q_scale, lambda x: torch.clamp(x.abs().amax(dim=-1), min=1e-8) / 127.0,
            rnd(64, 8, KV, G, HD).to(torch.bfloat16).float()),
        "dense p scales (8 slots, bucket 2048)": (
            llama.int8_p_scale, lambda x: torch.clamp(x.amax(dim=-1), min=1e-30) / 127.0,
            torch.softmax(rnd(8, KV, G, 2048) * 4, dim=-1) * vs),
        "weight scales (wqkv, 3072 x 5120)": (
            lambda x: quant._quant_2d(x)["scale"],
            lambda x: torch.clamp(x.abs().amax(dim=0) / 127.0, min=1e-12),
            rnd(D, 5120) * 0.02),
        "embedding scales (one of 8 chunks)": (
            lambda x: quant._quant_rows(x)[1],
            lambda x: torch.clamp(x.abs().amax(dim=1) / 127.0, min=1e-12),
            rnd(cfg.padded_vocab // 8, D) * 0.02),
    }
    for name, (site, before, x) in sites.items():
        xc = x.cpu()
        was = (before(x).cpu() != before(xc)).float().mean().item()
        now = (site(x).cpu() != site(xc)).float().mean().item()
        log(f"int8 scales, {name}: card vs CPU differ in {100 * was:.3f}% dividing by the number "
            f"127.0, {100 * now:.3f}% dividing by a tensor")
        if now != 0.0:
            raise AssertionError(f"int8 scales, {name}: {100 * now:.3f}% differ between the card "
                                 "and the CPU")


def phase_gemv(torch, dev):
    """The int8 GEMV at the 3B weight shapes against its twin (M = 1, 8),
    timed per call; returns its kernel record (times per decode step:
    28 calls of each layer weight and one lm_head, at M = 8).

    The kernel starts streaming weights before the previous kernel ends, so
    back-to-back calls would overlap one GEMV with the next, which serving
    never does (a norm, an add or a SiLU sits between).  Its time is taken
    with a small dependent add between calls (``time_kernels.chained_ms``),
    less the add's own time; the back-to-back time is printed beside it."""
    from project_morpheus_tpu_torch.ops import int8_gemv as ig
    from project_morpheus_tpu_torch.tools import time_kernels as tk

    g = torch.Generator(device=dev).manual_seed(5)
    recs, err = {}, 0.0
    step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for name, (K, N, k_major, layers) in tk.gemv_shapes().items():
        wshape = (layers, N, K) if k_major else (layers, K, N)
        q = torch.randint(-127, 128, wshape, generator=g, device=dev, dtype=torch.int8)
        sc = torch.rand(layers, N, generator=g, device=dev) * 0.02 + 1e-3
        wb = q.to(torch.bfloat16)  # the yardstick's pre-cast weight
        for M in (1, 8):
            h0 = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
            h = h0.clone()
            for i in {0, layers - 1}:
                got = ig.int8_gemv(h, q[i], sc[i], k_major=k_major)
                want = ig.int8_gemv_plain(h, q[i], sc[i], k_major).float()
                torch.cuda.synchronize()
                d = (got.float() - want).abs()
                bad = d > 2.0**-6 * want.abs() + 1e-3  # two bf16 roundings apart, at most
                if bool(bad.any()):
                    raise AssertionError(f"int8 GEMV {name}, M={M}, layer {i}: "
                                         f"{int(bad.sum())} values off, max err {d.max().item():.3e}")
                err = max(err, d.max().item())
            run = lambda i: ig.int8_gemv(h, q[i % layers], sc[i % layers], k_major=k_major)  # noqa: E731
            twin = lambda i: ig.int8_gemv_plain(h, q[i % layers], sc[i % layers], k_major)  # noqa: E731
            if k_major:
                lib = lambda i: h @ wb[i % layers].T  # noqa: E731
            else:
                lib = lambda i: h @ wb[i % layers]  # noqa: E731
            link = tk.gemv_link(torch, h, h0)
            out_bytes = 4 if k_major else 2
            b_ms, b_by = bound(K * N + 4 * N + 2 * M * K + out_bytes * M * N, 2.0 * M * K * N)
            dev_ms, link_ms = tk.chained_ms(run, link)
            lib_ms, _ = tk.chained_ms(lib, link)
            r = dict(K=K, N=N, M=M, device_ms=dev_ms, add_ms=link_ms,
                     back_to_back_ms=tk.graph_ms(run), host_us=tk.host_us(run),
                     plain_ms=tk.graph_ms(twin), library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            r["bound_frac"] = b_ms / r["device_ms"]
            recs[f"{name}_m{M}"] = r
            log(f"  int8_gemv [{name} {K}x{N}, M={M}]: device {dev_ms * 1e3:.2f} us/call "
                f"(with an add between calls, less the add's own {link_ms * 1e3:.2f} us; "
                f"back to back {r['back_to_back_ms'] * 1e3:.2f} us), "
                f"host {r['host_us']:.1f} us/call, "
                f"bound {b_ms * 1e3:.1f} us by {b_by} ({100 * r['bound_frac']:.1f}%), "
                f"cast+matmul {r['plain_ms'] * 1e3:.1f} us, matmul on bf16 weight "
                f"{lib_ms * 1e3:.2f} us")
            if M == 8:
                for key, val in (("ms", dev_ms), ("plain_ms", r["plain_ms"]),
                                 ("library_ms", lib_ms), ("bound_ms", b_ms)):
                    step[key] += layers * val
        del q, sc, wb
        torch.cuda.empty_cache()
    log(f"kernel int8_gemv: max_abs_err {err:.3e}; one 3B decode step's calls at M=8: "
        f"{step['ms']:.3f} ms (bound {step['bound_ms']:.3f} ms, "
        f"{100 * step['bound_ms'] / step['ms']:.1f}%), cast+matmul {step['plain_ms']:.3f} ms, "
        f"matmul on bf16 weights {step['library_ms']:.3f} ms")
    return dict(name="int8_gemv", route="cuda",
                source="project_morpheus_tpu_torch/ops/csrc/int8_gemv.cu",
                replaces="project_morpheus_tpu/model/quant.py:61 (XLA's fused dequant-dot, "
                         "not a Pallas kernel)",
                launches=0, max_abs_err=err, ms=step["ms"], plain_ms=step["plain_ms"],
                bound_ms=step["bound_ms"], bound_by="bytes", library_ms=step["library_ms"],
                shapes=recs)


def phase_prefill_kernel(torch, dev):
    """The chunk-prefill attention kernel against its twin at the 3B shapes
    (H=24, KV=8, HD=128; 28 layers x 8 slots x 8192), through
    ``time_kernels.prefill_timings``: every ``PREFILL_SHAPES`` (chunk,
    bucket, offset), the bucket's last chunks and the main path's own
    rounds, J = 1 and 4 jobs on spread slots, int8 and bf16 caches, garbage
    past each frontier, layers 0 and 27; each shape timed (device ms from a
    CUDA graph of 28 calls, one a layer) beside its bound, the bf16 ones
    beside SDPA.
    Returns the kernel record, headed by bf16, J = 4, C = 1024, hist 8192."""
    from project_morpheus_tpu_torch.tools import time_kernels as tk

    shapes = tk.prefill_timings(torch, dev, check_close)
    for name, rec in shapes.items():
        b_ms, b_by = bound(*tk.prefill_work(rec["J"], rec["C"], rec["hist"], rec["quant"],
                                            rec["off"]))
        rec.update(bound_ms=b_ms, bound_by=b_by, bound_frac=b_ms / rec["device_ms"])
        extra = "".join(f", {what} {rec[k]:.4f} ms" for k, what in
                        (("library_ms", "sdpa"), ("plain_ms", "twin")) if rec[k] is not None)
        log(f"  prefill_chunk_attention [{name}]: device {rec['device_ms']:.4f} ms/call, "
            f"host {rec['host_us']:.1f} us/call, bound {b_ms:.4f} ms by {b_by} "
            f"({100 * rec['bound_frac']:.1f}%){extra}")
    head = next(r for r in shapes.values() if r["plain_ms"] is not None)
    err = max(r["err"] for r in shapes.values())
    log(f"kernel prefill_chunk_attention: max_abs_err {err:.3e} over {len(shapes)} shapes x "
        f"2 layers")
    return dict(name="prefill_chunk_attention", route="cuda",
                source="project_morpheus_tpu_torch/ops/csrc/prefill_chunk_attention.cu",
                replaces="project_morpheus_tpu/model/llama.py:643 (_chunk_streaming_attn, jnp "
                         "fused by XLA into the jitted prefill; not a Pallas kernel)",
                launches=0, max_abs_err=err, ms=head["device_ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], shapes=shapes)


def phase_w8a8(torch, dev):
    """The chunk prefill's w8a8 quantize and GEMM against their plain
    versions, bit for bit, eager and replayed from a CUDA graph, at every
    ``time_kernels.W8A8_PAIRS`` weight (Orpheus-3B's, the tp = 2 halves, a
    tp = 8 rank's and 1B's ``wk`` at tp = 8) and the N and K tails
    (``W8A8_SHAPE_TAILS``), at ``W8A8_ROWS`` + ``W8A8_TAILS`` row counts,
    timed at the rows (``time_kernels.w8a8_timings``), the quantize + GEMM
    pair with and without the dependent launch.  Logs the short rounds (32
    and 128 rows) weight by weight beside ``_int_mm`` on the K-major copy,
    and their sum's share of the bytes bound.  Returns the GEMM's and the
    quantize's records, each headed by one 1,024-row round's 28 layers x
    four 3B projections (summed device ms); every shape is in the log."""
    from project_morpheus_tpu_torch.tools import time_kernels as tk

    t0 = time.perf_counter()
    shapes = tk.w8a8_timings(torch, dev)
    for name, r in shapes.items():
        b_ms, b_by = bound(*tk.w8a8_work(r["M"], r["K"], r["N"]), H100_INT8_OPS_PER_S)
        q_ms, q_by = bound(*tk.quantize_work(r["M"], r["K"]), H100_FP32_OPS_PER_S)
        r.update(bound_ms=b_ms, bound_by=b_by, bound_frac=b_ms / r["device_ms"],
                 quantize_bound_ms=q_ms, quantize_bound_by=q_by)
        log(f"  w8a8 [{name}, plan {r['plan']}]: gemm {r['device_ms']:.4f} ms/call, host "
            f"{r['host_us']:.1f} us, bound {b_ms:.4f} ms by {b_by} "
            f"({100 * r['bound_frac']:.1f}%), plain {r['plain_ms']:.3f} ms, _int_mm (K, N) "
            f"{r['library_ms']:.4f}, _int_mm K-major {r['library_kmajor_ms']:.4f}, bf16 matmul "
            f"{r['library_bf16_ms']:.4f}; quantize {r['quantize_ms'] * 1e3:.2f} us/call (bound "
            f"{q_ms * 1e3:.2f} us by {q_by}), host {r['quantize_host_us']:.1f} us, plain "
            f"{r['quantize_plain_ms'] * 1e3:.1f} us; quantize + gemm {r['pair_ms'] * 1e3:.2f} "
            f"us with the dependent launch, {r['pair_nodep_ms'] * 1e3:.2f} us without")
    weights = ("wqkv", "wo", "wgu", "wd")
    # the short prompts' rounds weight by weight, beside _int_mm on the K-major copy
    short = {}
    for M in tk.W8A8_SHORT_ROWS:
        recs = [shapes[f"{n} M={M}"] for n in weights]
        tot = {k: sum(r[k] for r in recs) for k in ("device_ms", "library_kmajor_ms", "bound_ms",
                                                    "pair_ms", "pair_nodep_ms", "quantize_ms")}
        slower = [n for n, r in zip(weights, recs) if r["device_ms"] > r["library_kmajor_ms"]]
        per = "; ".join(f"{n} {r['device_ms'] * 1e3:.2f} us (_int_mm K-major "
                        f"{r['library_kmajor_ms'] * 1e3:.2f}, bound {r['bound_ms'] * 1e3:.2f})"
                        for n, r in zip(weights, recs))
        log(f"w8a8 GEMM at {M} rows: {per}; sum {tot['device_ms']:.4f} ms, "
            f"{100 * tot['bound_ms'] / tot['device_ms']:.1f}% of its bytes bound "
            f"{tot['bound_ms']:.4f} ms (_int_mm K-major {tot['library_kmajor_ms']:.4f}); slower "
            f"than _int_mm: {slower or 'none'}; quantize + GEMM pairs {tot['pair_ms']:.4f} ms "
            f"with the dependent launch, {tot['pair_nodep_ms']:.4f} without")
        short[M] = dict(tot, bound_frac=tot["bound_ms"] / tot["device_ms"], slower=slower,
                        weights={n: {k: r[k] for k in ("plan", "device_ms", "library_kmajor_ms",
                                                       "bound_ms", "pair_ms", "pair_nodep_ms")}
                                 for n, r in zip(weights, recs)})
    head = [shapes[f"{n} M=1024"] for n in weights]
    round_ = {k: tk.L * sum(r[k] for r in head)
              for k in ("device_ms", "plain_ms", "library_ms", "library_kmajor_ms",
                        "library_bf16_ms", "bound_ms", "quantize_ms", "quantize_plain_ms",
                        "quantize_bound_ms", "pair_ms", "pair_nodep_ms")}
    log(f"kernels w8a8: equal to the plain versions bit for bit at {len(tk.W8A8_PAIRS)} weights "
        f"x {len(tk.W8A8_ROWS) + len(tk.W8A8_TAILS)} row counts, eager and replayed; a "
        f"1,024-row round's 28 x 4 GEMMs {round_['device_ms']:.3f} ms (bound "
        f"{round_['bound_ms']:.3f}, {100 * round_['bound_ms'] / round_['device_ms']:.1f}%; "
        f"_int_mm (K, N) {round_['library_ms']:.3f}, K-major {round_['library_kmajor_ms']:.3f}, "
        f"bf16 matmul {round_['library_bf16_ms']:.3f}), quantizes "
        f"{round_['quantize_ms']:.3f} ms (bound {round_['quantize_bound_ms']:.3f}, "
        f"{100 * round_['quantize_bound_ms'] / round_['quantize_ms']:.1f}% of it), quantize + "
        f"GEMM pairs {round_['pair_ms']:.3f} ms with the dependent launch, "
        f"{round_['pair_nodep_ms']:.3f} without; {time.perf_counter() - t0:.1f} s")
    src = "project_morpheus_tpu_torch/ops/csrc/w8a8_gemm.cu"
    replaces = "project_morpheus_tpu/model/quant.py:{} (matmul_w8a8: XLA's {}; not a Pallas kernel)"
    gemm = dict(name="w8a8_gemm", route="cuda", source=src,
                replaces=replaces.format("89-95", "int8 dot_general with int32 accumulation "
                                         "and the scaling"),
                launches=0, max_abs_err=0.0, ms=round_["device_ms"], plain_ms=round_["plain_ms"],
                bound_ms=round_["bound_ms"], bound_by="operations",
                library_ms=round_["library_ms"],
                library_kmajor_ms=round_["library_kmajor_ms"],
                library_bf16_ms=round_["library_bf16_ms"], pair_ms=round_["pair_ms"],
                pair_nodep_ms=round_["pair_nodep_ms"],
                short_rounds={M: {k: v for k, v in r.items() if k != "weights"}
                              for M, r in short.items()})
    quant = dict(name="w8a8_quantize", route="cuda", source=src,
                 replaces=replaces.format("84-88", "per-token int8 quantization"), launches=0,
                 max_abs_err=0.0, ms=round_["quantize_ms"], plain_ms=round_["quantize_plain_ms"],
                 bound_ms=round_["quantize_bound_ms"], bound_by="bytes", library_ms=None,
                 short_rounds={M: dict(ms=r["quantize_ms"]) for M, r in short.items()})
    return [gemm, quant]


# ------------------------------------------------------------ phase 3


def phase_reference(torch, dev):
    """Decode path on the card (bf16, kernels) vs on the CPU (fp32, twins)."""
    from project_morpheus_tpu_torch.model import LlamaConfig
    from project_morpheus_tpu_torch.model import llama
    from project_morpheus_tpu_torch.model.quant import add_k_major_copies, quantize_params_int8

    cfg = LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=6, num_kv_heads=2, head_dim=128, max_seq_len=512,
                      rope_scaling_factor=1.0)
    cpu_params = quantize_params_int8(llama.init_llama_params(cfg, 7, "cpu", torch.float32))

    card_params = add_k_major_copies({
        "embed": {k: v.to(dev) for k, v in cpu_params["embed"].items()},
        "ln_f": cpu_params["ln_f"].to(dev, torch.bfloat16),
        "layers": {k: ({"q": v["q"].to(dev), "scale": v["scale"].to(dev)} if isinstance(v, dict)
                       else v.to(dev, torch.bfloat16))
                   for k, v in cpu_params["layers"].items()},
    })
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


def phase_graphs(torch, dev) -> None:
    """Seeded requests on a small int8 model: graph replay == eager."""
    from project_morpheus_tpu_torch.tools import graph_check as gc

    for temp in (0.0, 0.9):
        (gt, gp), (et, ep) = gc.graph_and_eager_traces(dev, temp)
        if gp.replays == 0 or ep.captures != 0:
            raise AssertionError(f"graph engine replayed {gp.replays} programs, "
                                 f"eager engine captured {ep.captures}")
        if gt != et or any(len(t) != gc.MAX_TOKENS for t in gt):
            raise AssertionError(f"graph vs eager traces differ at temperature {temp}")
        log(f"graphs: temperature {temp}: {len(gt)} seeded traces of {gc.MAX_TOKENS} tokens "
            f"identical replayed ({gp.captures} graphs, {gp.replays} replays) and eager")


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


async def serve(prompts, max_tokens, seeds=None, temperature=None):
    """Pull every prompt through its own adapter (at ``temperature``, else
    the default); returns ([(pcm, ttfa)], wall seconds, [token trace of
    each request])."""
    from project_morpheus_tpu_torch.adapters.local_torch import LocalTorchAdapter
    from project_morpheus_tpu_torch.model.sampling import SamplingParams

    seeds = seeds or [None] * len(prompts)
    temp = {} if temperature is None else {"temperature": temperature}
    adapters = [LocalTorchAdapter(p, sampling=SamplingParams(max_tokens=max_tokens, seed=s, **temp))
                for p, s in zip(prompts, seeds)]
    t0 = time.perf_counter()
    out = await asyncio.gather(*[pull_all(a) for a in adapters])
    wall = time.perf_counter() - t0
    traces = []
    for a in adapters:  # audio requests also queue their tokens, unread
        q, toks = a._requests[0].token_queue, []
        while not q.empty():
            t = q.get_nowait()
            if t is not None:
                toks.append(t)
        traces.append(toks)
    return out, wall, traces


async def measured_load(torch, engine, prompts, max_tokens, seeds, what, card,
                        temperature=None):
    """Serve one seeded load: ms per decode step, TTFA and real-time factor
    on the host clock.  Returns ([(pcm, ttfa)], token traces)."""
    steps0 = engine.steps
    torch.cuda.synchronize()
    out, wall, traces = await serve(prompts, max_tokens, seeds, temperature)
    torch.cuda.synchronize()
    steps = engine.steps - steps0
    audio_s = sum(len(p) for p, _ in out) / 2 / 24000
    log(f"serve 3b {what}: {len(prompts)} requests in {wall:.3f} s, {steps} decode steps "
        f"({1e3 * wall / max(steps, 1):.2f} ms/step), TTFA "
        f"{' / '.join(f'{t:.3f}' for _, t in out)} s, real-time factor {audio_s / wall:.3f} "
        f"[{card}]")
    return out, traces


async def idle_share(torch, prompts, max_tokens, seeds, what, card):
    """Serve the same seeded load again under the torch profiler (card
    activity only): the device's idle share, 1 - (time any kernel or copy
    ran) / wall.  Returns (idle share, the trace)."""
    from project_morpheus_tpu_torch.tools.profile_serving import device_trace

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with device_trace() as trace:
        _, wall, _ = await serve(prompts, max_tokens, seeds)
        torch.cuda.synchronize()
    busy = trace["busy_s"]
    log(f"  {what}, profiled rerun: {wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{100 * (1 - busy / wall):.1f}% (profiler start and trace read: "
        f"{time.perf_counter() - t0 - wall:.1f} s) [{card}]")
    return 1 - busy / wall, trace


# the earlier GEMV design (per-lane register loads, a ticket-reduced K split;
# commit d980781) in tools/profile_serving.py's short-prompt window on an
# NVIDIA H100 80GB HBM3 at 700 W: projections + lm_head, ms a frame (PERF.md)
EARLIER_GEMV_MS_A_FRAME = (12.92, 1.83)


def gemv_ms_a_frame(trace, frames: int):
    """Device ms a frame of the GEMV's (K, N) and (N, K) kernels in a trace."""
    kn = sum(us for name, (us, _) in trace["ops"].items() if "gemv_kn" in name)
    nk = sum(us for name, (us, _) in trace["ops"].items() if "gemv_nk" in name)
    return kn / frames / 1e3, nk / frames / 1e3


HTTP_TEXT, HTTP_TOKENS = "Hello from the card.", 7 * 8


async def phase_http(card, np):
    import aiohttp
    from aiohttp import web

    from project_morpheus_tpu_torch.server.app import create_app

    runner = web.AppRunner(create_app(generation={"max_tokens": HTTP_TOKENS}))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    try:
        async with aiohttp.ClientSession() as s:
            async with s.post(f"http://127.0.0.1:{port}/v1/audio/speech",
                              json={"input": HTTP_TEXT, "voice": "tara"}) as r:
                status, ctype, body = r.status, r.headers.get("Content-Type"), await r.read()
    finally:
        await runner.cleanup()
    if status != 200 or ctype != "audio/wav" or body[:4] != b"RIFF" or body[8:12] != b"WAVE":
        raise AssertionError(f"speech request: status {status}, type {ctype}, head {body[:12]!r}")
    check_pcm(np, body[44:], 8, 4096, "HTTP speech")
    log(f"http: POST /v1/audio/speech -> RIFF WAV, {len(body) - 44} PCM bytes [{card}]")


async def serving_phases(card: str, records) -> str:
    """Phases 4-6 in one event loop (the engines' queues live in it);
    returns the line on the GEMV's serving time."""
    import numpy as np
    import torch

    from project_morpheus_tpu_torch.adapters import runtime as rt
    from project_morpheus_tpu_torch.model.quant import add_k_major_copies
    from project_morpheus_tpu_torch.model.tokenizer import format_prompt_ids
    from project_morpheus_tpu_torch.ops import decode_attention as da
    from project_morpheus_tpu_torch.ops import int8_gemv as ig
    from project_morpheus_tpu_torch.ops import prefill_attention as pa
    from project_morpheus_tpu_torch.ops import w8a8_gemm as wg
    from project_morpheus_tpu_torch.tools.profile_serving import (
        BURST_PROMPT, LONG_PROMPT, PROMPTS, TOKENS_PER_REQUEST, round_timer, serving_runtime,
        warm)

    # phase 4: the 3B int8 serving path (the workload profile_serving traces)
    t0 = time.perf_counter()
    rt3 = serving_runtime()
    torch.cuda.synchronize()
    log(f"3b runtime built in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card)")
    # what the engine's K-major copies cost: the same copies made once more
    # from the leaves without them, memory_allocated before and after
    lp = rt3.engine.params["layers"]
    bare = {"layers": {k: {n: t for n, t in w.items() if n != "qt"} if isinstance(w, dict) else w
                       for k, w in lp.items()}}
    before = torch.cuda.memory_allocated()
    again = add_k_major_copies(bare)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    del again
    kmajor = sum(w["qt"].numel() for w in lp.values() if isinstance(w, dict) and "qt" in w)
    records[4]["k_major_copy_bytes"] = after - before
    log(f"  w8a8 K-major copies: memory_allocated {before / 2**30:.3f} -> {after / 2**30:.3f} "
        f"GiB making them once more (+{(after - before) / 1e9:.3f} GB, the engine's "
        f"{kmajor / 1e9:.3f} GB) [{card}]")
    prompts = list(PROMPTS)
    seeds = [100 + i for i in range(len(prompts))]
    n_long = len(format_prompt_ids(LONG_PROMPT, "tara"))
    if not 2048 < n_long <= 3072:
        raise AssertionError(f"long prompt is {n_long} tokens")
    eng = rt3.engine
    n, secs = warm(eng)
    prefill_keys = {k for k in eng.programs.graph_keys if k[0] == "prefill"}
    captures0 = eng.programs.captures
    log(f"warmup (frames_per_dispatch=1): {n} programs in {secs:.2f} s, "
        f"{eng.programs.captures} CUDA graphs captured, {len(prefill_keys)} of them prefill "
        f"rounds (J up to {eng._max_batch_j}); graph pool {eng.programs.pool_bytes() / 2**30:.3f} "
        f"GiB, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved in all [{card}]")
    fs = rt3.snac_cfg.frame_samples

    def prefill_replays():
        return sum(c for k, c in eng.programs.replayed.items() if k[0] == "prefill")

    da.reset_launch_counts()
    ig.reset_launch_counts()
    pa.reset_launch_counts()
    wg.reset_launch_counts()
    replays0 = prefill_replays()
    with round_timer(eng) as rounds:
        out, traces1 = await measured_load(torch, eng, prompts, TOKENS_PER_REQUEST, seeds,
                                           "k=1 (main path)", card)
    launches = {**da.LAUNCHES, **ig.LAUNCHES, **pa.LAUNCHES, **wg.LAUNCHES}
    for i, (pcm, _) in enumerate(out):
        check_pcm(np, pcm, TOKENS_PER_REQUEST // 7, 2 * fs, f"3b request {i}")
    for name in ("decode_attention_int8_slots", "int8_gemv", "prefill_chunk_attention",
                 "w8a8_gemm", "w8a8_quantize"):
        if launches[name] <= 0:
            raise AssertionError(f"3b int8 serving never launched {name}: {launches}")
    records[0]["launches"] = launches["decode_attention_int8_slots"]
    records[2]["launches"] = launches["int8_gemv"]
    records[3]["launches"] = launches["prefill_chunk_attention"]
    records[4]["launches"] = launches["w8a8_gemm"]
    records[5]["launches"] = launches["w8a8_quantize"]
    for i, kname in ((4, "w8a8_gemm"), (5, "w8a8_quantize")):  # on the short rounds
        records[i]["launches_short"] = launches[kname + "_short"]
    log(f"w8a8 launches in the main-path load: GEMM {launches['w8a8_gemm']} "
        f"({launches['w8a8_gemm_short']} on <= {wg.SHORT_ROWS} rows), quantize "
        f"{launches['w8a8_quantize']} ({launches['w8a8_quantize_short']})")
    n_rounds = max(rounds["rounds"], 1)
    records[3]["serving_round_ms"] = dict(rounds=rounds["rounds"],
                                         host=rounds["host_s"] / n_rounds * 1e3,
                                         device=rounds["device_s"] / n_rounds * 1e3)
    log(f"  main path launches (graph replays counted) {launches}, graphs replayed "
        f"{eng.programs.replays}, prefill rounds {rounds['rounds']} (replayed "
        f"{prefill_replays() - replays0}): host {rounds['host_s'] / n_rounds * 1e3:.2f} ms a "
        f"round, device {rounds['device_s'] / n_rounds * 1e3:.2f} ms a round [{card}]")
    if prefill_replays() - replays0 <= 0:
        raise AssertionError("the main path replayed no prefill round")

    # the same load with prefill rounds eager, seeded and greedy: the same tokens
    greedy = {}
    for graphs in (True, False):
        eng.prefill_graphs = graphs
        with round_timer(eng) as rounds:
            _, greedy[graphs] = await measured_load(
                torch, eng, prompts, TOKENS_PER_REQUEST, seeds,
                f"greedy, prefill rounds {'replayed' if graphs else 'eager'}", card,
                temperature=0.0)
        log(f"  greedy, prefill rounds {'replayed' if graphs else 'eager'}: host "
            f"{rounds['host_s'] / max(rounds['rounds'], 1) * 1e3:.2f} ms a round, device "
            f"{rounds['device_s'] / max(rounds['rounds'], 1) * 1e3:.2f} ms a round [{card}]")
    with round_timer(eng) as rounds:
        _, traces_eager = await measured_load(torch, eng, prompts, TOKENS_PER_REQUEST, seeds,
                                              "k=1, prefill rounds eager", card)
    eng.prefill_graphs = True
    records[3]["eager_round_ms"] = dict(host=rounds["host_s"] / max(rounds["rounds"], 1) * 1e3,
                                        device=rounds["device_s"] / max(rounds["rounds"], 1) * 1e3)
    if traces_eager != traces1 or greedy[True] != greedy[False] or any(
            len(t) == 0 for t in traces1 + greedy[True]):
        raise AssertionError("traces differ between prefill rounds replayed and eager")
    log(f"  prefill rounds eager: host {records[3]['eager_round_ms']['host']:.2f} ms a round, "
        f"device {records[3]['eager_round_ms']['device']:.2f} ms a round; seeded "
        f"({sum(map(len, traces1))} tokens) and greedy ({sum(map(len, greedy[True]))}) traces "
        f"equal to the replayed rounds' [{card}]")
    steps0 = eng.steps
    _, trace = await idle_share(torch, prompts, TOKENS_PER_REQUEST, seeds, "k=1", card)
    kn, nk = gemv_ms_a_frame(trace, max(1, (eng.steps - steps0) // eng.steps_per_sync))
    records[2]["serving_gemv_ms_a_frame"] = [kn, nk]
    gemv_line = (f"int8 GEMV in the k=1 serving load, device ms a frame: {kn:.3f} (K, N) + "
                 f"{nk:.3f} (N, K) = {kn + nk:.3f}; earlier design "
                 f"{EARLIER_GEMV_MS_A_FRAME[0]} + {EARLIER_GEMV_MS_A_FRAME[1]} = "
                 f"{sum(EARLIER_GEMV_MS_A_FRAME):.2f} (short-prompt window of "
                 f"tools/profile_serving.py, commit d980781, NVIDIA H100 80GB HBM3, 700 W) [{card}]")
    log(gemv_line)

    # a cold burst of equal long prompts: J-batched prefill rounds
    rounds0 = dict(eng.prefill_rounds)
    burst = [BURST_PROMPT] * 4
    burst_seeds = [200 + i for i in range(4)]
    what = f"burst of 4 x {len(format_prompt_ids(BURST_PROMPT, 'tara'))}-token prompts"
    outb, _ = await measured_load(torch, eng, burst, 7 * 12, burst_seeds, what, card)
    for i, (pcm, _) in enumerate(outb):
        check_pcm(np, pcm, 12, 2 * fs, f"burst request {i}")
    batched = {j: c - rounds0.get(j, 0) for j, c in eng.prefill_rounds.items()
               if j > 1 and c > rounds0.get(j, 0)}
    if not batched:
        raise AssertionError(f"the burst ran no J-batched prefill round: {dict(eng.prefill_rounds)}")
    new_prefill = {k for k in eng.programs.graph_keys if k[0] == "prefill"} - prefill_keys
    if new_prefill:
        raise AssertionError(f"prefill rounds captured after warmup: {sorted(new_prefill)}")
    log(f"  J-batched prefill rounds in the burst (width: rounds): {batched}; CUDA graphs "
        f"captured since warmup: {eng.programs.captures - captures0} (prefill rounds: 0) "
        f"[{card}]")
    await idle_share(torch, burst, 7 * 12, burst_seeds, "burst", card)

    # the same seeded load, up to two frames a dispatch
    eng.frames_per_dispatch = 2
    n, secs = warm(eng, PROMPTS, burst=1)
    log(f"warmup (frames_per_dispatch=2): {n} programs in {secs:.2f} s, "
        f"{eng.programs.captures} CUDA graphs captured in all")
    out2, traces2 = await measured_load(torch, eng, prompts, TOKENS_PER_REQUEST, seeds, "k=2",
                                        card)
    if traces2 != traces1 or any(len(t) == 0 for t in traces1):
        where = [(len(a), len(b), next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None))
                 for a, b in zip(traces1, traces2)]
        raise AssertionError("seeded traces differ between frames_per_dispatch 1 and 2 "
                             f"(lengths and first differing index per request: {where})")
    same_pcm = all(a[0] == b[0] for a, b in zip(out, out2))
    log(f"  k=2 traces identical to k=1 ({sum(map(len, traces1))} tokens); "
        f"PCM identical: {same_pcm}")
    await idle_share(torch, prompts, TOKENS_PER_REQUEST, seeds, "k=2", card)
    eng.frames_per_dispatch = 1

    # phase 5: bf16 cache, kernel attention, 3B widths at 4 layers
    os.environ["ORPHEUS_KV_QUANT"] = "bfloat16"
    rt4 = rt.ServingRuntime(device="cuda", num_layers=4, attn_impl="kernel",
                            banded_sampling=True)
    rt.set_runtime(rt4)
    da.reset_launch_counts()
    out4, wall4, _ = await serve(["Bf16 cache decode.", "Second stream."], 7 * 8)
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
    # under the server's attention choice: a short context stays below
    # pallas_min_bucket, so its frames replay the dense int8 branch's graphs
    rt.set_runtime(rt3)
    eng.attn_impl = "auto"
    n, secs = warm(eng, [HTTP_TEXT], burst=1)
    replayed0 = dict(eng.programs.replayed)
    await phase_http(card, np)
    dense = {key: c - replayed0.get(key, 0) for key, c in eng.programs.replayed.items()
             if key[1] == "dense" and c > replayed0.get(key, 0)}
    if not dense:
        raise AssertionError(f"the HTTP request replayed no dense frame program: "
                             f"{dict(eng.programs.replayed)}")
    log(f"  attn_impl auto: warmup {n} programs in {secs:.2f} s; dense frame programs "
        f"replayed (bucket, attn, steps, frames, ...: replays) {dense} [{card}]")
    await rt3.engine.close()
    return gemv_line


# ------------------------------------------------------------ phase 7
#
# This script's own writers of an HF release directory: independent of the
# port's reader (model/hf_weights.py), which phase 7 and the tests check
# against them.

ST_DTYPES = {"torch.bfloat16": "BF16", "torch.float16": "F16", "torch.float32": "F32"}
HF_LAYER_NAMES = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
                  "wo": "self_attn.o_proj", "wg": "mlp.gate_proj", "wu": "mlp.up_proj",
                  "wd": "mlp.down_proj", "ln1": "input_layernorm",
                  "ln2": "post_attention_layernorm"}
# the pre-tokenizer split of the Llama-3 tokenizer.json
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
TOKENIZER_MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("Ġ", "a"), ("e", "r"),
                    ("o", "n"), ("Ġ", "s"), ("r", "e"), ("a", "t"), ("e", "n"), ("o", "r"),
                    ("Ġ", "w"), ("e", "s"), ("l", "l"), ("Ġ", "c"), ("i", "s"), ("o", "u")]


def hf_config_dict(cfg) -> dict:
    """``config.json`` of an Orpheus-3B release (``canopylabs/orpheus-3b-0.1-ft``'s
    key names) for the widths of ``cfg``."""
    return {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "attention_bias": False, "attention_dropout": 0.0, "mlp_bias": False,
        "bos_token_id": 128000, "eos_token_id": 128009, "hidden_act": "silu",
        "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "max_position_embeddings": 131072, "initializer_range": 0.02, "pretraining_tp": 1,
        "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
        "rope_scaling": {"rope_type": "llama3", "factor": cfg.rope_scaling_factor,
                         "low_freq_factor": cfg.rope_low_freq_factor,
                         "high_freq_factor": cfg.rope_high_freq_factor,
                         "original_max_position_embeddings": cfg.rope_original_max_pos},
        "tie_word_embeddings": cfg.tie_embeddings, "torch_dtype": "bfloat16",
        "use_cache": True, "vocab_size": cfg.vocab_size,
    }


def hf_tensors(params, cfg):
    """(name, tensor) of ``params`` in an HF Llama release's names and
    ``(out, in)`` layout, vocab padding dropped."""
    yield "model.embed_tokens.weight", params["embed"][:cfg.vocab_size]
    for i in range(cfg.num_layers):
        for key, name in HF_LAYER_NAMES.items():
            w = params["layers"][key][i]
            yield f"model.layers.{i}.{name}.weight", w.T if w.ndim == 2 else w
    yield "model.norm.weight", params["ln_f"]
    if "lm_head" in params:
        yield "lm_head.weight", params["lm_head"][:, :cfg.vocab_size].T


def write_safetensors(path, tensors) -> int:
    """One safetensors file from ``[(name, tensor)]`` (any device): the
    8-byte little-endian header length, the JSON header padded to 8 bytes,
    then each tensor's bytes in order, one tensor on the host at a time;
    then ``fsync`` and ``posix_fadvise(DONTNEED)``, which asks the kernel to
    drop the file from the page cache (a filesystem may not honour it).
    Returns the file's size."""
    import torch

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in tensors:
            f.write(t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
        f.flush()
        os.fsync(f.fileno())
        os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
    return 8 + len(raw) + offset


def write_hf_checkpoint(directory, params, cfg, shards: int = 2) -> int:
    """``config.json``, ``shards`` safetensors files and their index;
    returns the bytes written."""
    directory = Path(directory)
    tensors = list(hf_tensors(params, cfg))
    per = math.ceil(len(tensors) / shards)
    weight_map, total = {}, 0
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = tensors[s * per:(s + 1) * per]
        total += write_safetensors(directory / fname, part)
        weight_map.update({name: fname for name, _ in part})
    size = sum(t.numel() * t.element_size() for _, t in tensors)
    (directory / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": size}, "weight_map": weight_map}))
    (directory / "config.json").write_text(json.dumps(hf_config_dict(cfg), indent=2))
    return total


def _byte_chars():
    """GPT-2's byte -> printable character map (byte-level BPE)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def write_tokenizer(directory, vocab_size: int) -> None:
    """A byte-level BPE ``tokenizer.json`` in the Llama-3 layout: the 256
    byte symbols, a few merges, filler entries up to id 128,000 that no
    text reaches, then Orpheus's added tokens (Llama-3's 256 special ids,
    ``<|eot_id|>`` at 128,009, and ``<custom_token_N>`` at 128,256 + N up
    to ``vocab_size``)."""
    chars = _byte_chars()
    vocab = {chars[b]: b for b in range(256)}
    for a, b in TOKENIZER_MERGES:
        vocab[a + b] = len(vocab)
    while len(vocab) < 128000:
        vocab[f"一filler{len(vocab)}"] = len(vocab)
    names = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>", 128009: "<|eot_id|>"}
    added = [{"id": i, "content": names.get(i, f"<|reserved_special_token_{i - 128002}|>"),
              "single_word": False, "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for i in range(128000, 128256)]
    added += [{"id": 128256 + n, "content": f"<custom_token_{n}>", "single_word": False,
               "lstrip": False, "rstrip": False, "normalized": False, "special": True}
              for n in range(vocab_size - 128256)]
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [list(m) for m in TOKENIZER_MERGES]},
    }
    Path(directory, "tokenizer.json").write_text(json.dumps(spec))
    Path(directory, "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "clean_up_tokenization_spaces": True}))


class PeakRss:
    """Samples the process's resident set every 5 ms while the block runs;
    ``peak`` and ``start`` in bytes."""

    def __init__(self) -> None:
        self.start = self.peak = self._read()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _read() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self) -> None:
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._read())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self._read())


CKPT_PROMPTS = ("Loaded weights speak first.", "Hello there, how are you today?",
                "A short sentence.", "Streaming speech from a checkpoint.")


def check_loaded_params(torch, loaded, mem, lcfg, cfg) -> int:
    """Every loaded leaf equals the written params bit for bit; the config
    equals ``cfg`` in every field the model reads.  Returns leaves checked."""
    fields = [f for f in cfg.__dataclass_fields__ if f not in ("max_seq_len", "dtype")]
    bad = [f for f in fields if getattr(lcfg, f) != getattr(cfg, f)]
    if bad or lcfg.max_seq_len != 131072:
        raise AssertionError(f"loaded config differs in {bad} (max_seq_len {lcfg.max_seq_len})")
    pairs = [("embed", loaded["embed"], mem["embed"]), ("ln_f", loaded["ln_f"], mem["ln_f"])]
    pairs += [(k, loaded["layers"][k], v) for k, v in mem["layers"].items()]
    if set(loaded) != set(mem) or set(loaded["layers"]) != set(mem["layers"]):
        raise AssertionError(f"loaded leaves {sorted(loaded)} vs {sorted(mem)}")
    for name, a, b in pairs:
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.view(torch.int16), b.view(torch.int16)):
            raise AssertionError(f"loaded leaf {name} differs from the written params")
    return len(pairs)


def trace_codes(trace):
    """Audio codes of a token trace, as the remote path keeps them (code > 0)."""
    from project_morpheus_tpu_torch.adapters.runtime import audio_code_from_token_id

    codes, pos = [], 0
    for t in trace:
        c = audio_code_from_token_id(t, pos)
        if c is not None:
            pos += 1
            codes.append(c)
    return [c for c in codes if c > 0]


async def sse_stub(codes):
    """A local OpenAI-style completions endpoint streaming ``codes`` as
    ``<custom_token_N>`` SSE events, two tokens an event; returns
    (runner, url)."""
    from aiohttp import web

    from project_morpheus_tpu_torch.codec.frames import custom_number_from_audio_code

    toks = [f"<custom_token_{custom_number_from_audio_code(c, i)}>" for i, c in enumerate(codes)]

    async def completions(request):
        body = await request.json()
        if body.get("stream") is not True:
            raise web.HTTPBadRequest(text="stream must be true")
        resp = web.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        for i in range(0, len(toks), 2):
            event = {"choices": [{"text": "".join(toks[i:i + 2])}]}
            await resp.write(f"data: {json.dumps(event)}\n\n".encode())
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    app = web.Application()
    app.router.add_post("/v1/completions", completions)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}/v1/completions"


async def phase_checkpoint_server(card, np, fs, workdir):
    """The server on the loaded runtime: speech (TTFA of the first
    request), ``/ws/tts``, ``/config``, ``/barge-in``, ``/adapters``,
    ``/sources``.  Config writes land in ``workdir``."""
    import aiohttp
    from aiohttp import web

    from project_morpheus_tpu_torch import config as config_mod
    from project_morpheus_tpu_torch.server.app import create_app

    config_mod.HOME_CONFIG = Path(workdir, "home_config")
    runner = web.AppRunner(create_app(generation={"max_tokens": HTTP_TOKENS}))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    try:
        async with aiohttp.ClientSession() as s:
            t0 = time.perf_counter()
            ttfa, body = None, bytearray()
            async with s.post(f"{base}/v1/audio/speech",
                              json={"input": "Loaded from a checkpoint.", "voice": "tara"}) as r:
                status, ctype = r.status, r.headers.get("Content-Type")
                async for chunk in r.content.iter_any():
                    body += chunk
                    if ttfa is None and len(body) > 44:
                        ttfa = time.perf_counter() - t0
            if status != 200 or ctype != "audio/wav" or body[:4] != b"RIFF":
                raise AssertionError(f"speech on loaded weights: {status} {ctype} {bytes(body[:12])!r}")
            check_pcm(np, bytes(body[44:]), HTTP_TOKENS // 7, 2 * fs, "HTTP speech, loaded weights")
            async with s.ws_connect(f"{base}/ws/tts") as ws:
                await ws.send_str(json.dumps({"input": "Over the websocket."}))
                pcm, eos = bytearray(), None
                async for msg in ws:
                    if msg.type == aiohttp.WSMsgType.BINARY:
                        pcm += msg.data
                    else:
                        eos = json.loads(msg.data)
                        break
            if eos != {"eos": True}:
                raise AssertionError(f"/ws/tts ended with {eos}")
            check_pcm(np, bytes(pcm), HTTP_TOKENS // 7, 2 * fs, "/ws/tts, loaded weights")
            async with s.post(f"{base}/config", json={"temperature": 0.7}) as r:
                posted = (r.status, await r.json())
            async with s.get(f"{base}/config") as r:
                got = await r.json()
            async with s.post(f"{base}/barge-in") as r:
                barge = await r.json()
            async with s.get(f"{base}/adapters") as r:
                adapters = await r.json()
            async with s.get(f"{base}/sources") as r:
                sources = await r.json()
    finally:
        await runner.cleanup()
    if posted[0] != 200 or got.get("TEMPERATURE") != "0.7" or got.get("ORPHEUS_TEMPERATURE") != "0.7":
        raise AssertionError(f"/config: POST {posted}, GET temperature {got.get('TEMPERATURE')}")
    if barge != {"ok": True} or set(adapters) != {"local_torch", "remote_sse"} or \
            set(sources) != {"websocket", "http_poll", "cli_pipe"}:
        raise AssertionError(f"/barge-in {barge}, /adapters {sorted(adapters)}, "
                             f"/sources {sorted(sources)}")
    log(f"http on loaded weights: TTFA {ttfa:.3f} s (first request), {len(body) - 44} PCM bytes; "
        f"/ws/tts {len(pcm)} PCM bytes then eos; /config temperature 0.7 applied; /barge-in, "
        f"/adapters, /sources answered [{card}]")
    return ttfa


async def phase_checkpoint(card: str, records) -> None:
    """Phase 7 (see the module docstring)."""
    import numpy as np
    import torch

    from project_morpheus_tpu_torch.adapters import remote_backend as rb
    from project_morpheus_tpu_torch.adapters import runtime as rt
    from project_morpheus_tpu_torch.codec.snac_config import SNACConfig
    from project_morpheus_tpu_torch.codec.stream_decode import ExactStreamDecoder
    from project_morpheus_tpu_torch.codec.weights import random_torch_state
    from project_morpheus_tpu_torch.model import LlamaConfig
    from project_morpheus_tpu_torch.model.llama import init_llama_params
    from project_morpheus_tpu_torch.model.tokenizer import BPETokenizer, format_prompt_ids
    from project_morpheus_tpu_torch.ops import decode_attention as da
    from project_morpheus_tpu_torch.ops import int8_gemv as ig
    from project_morpheus_tpu_torch.ops import w8a8_gemm as wg

    rt.set_runtime(None)  # drop phase 4's 3B runtime
    torch.cuda.empty_cache()
    cfg = LlamaConfig.orpheus_3b()
    workdir = tempfile.mkdtemp(prefix="orpheus_ckpt_")
    cwd = os.getcwd()
    try:
        free = shutil.disk_usage(workdir).free
        if free < 10e9:
            raise AssertionError(f"{free / 1e9:.1f} GB free under {workdir}; the files need ~6.6 GB")
        ckpt, snac_path = Path(workdir, "orpheus-3b"), Path(workdir, "snac_24khz.npz")
        ckpt.mkdir()
        t0 = time.perf_counter()
        mem = init_llama_params(cfg, 11, "cuda", torch.bfloat16)
        mem["embed"][cfg.vocab_size:] = 0  # a release has no padded rows
        nbytes = write_hf_checkpoint(ckpt, mem, cfg)
        write_tokenizer(ckpt, cfg.vocab_size)
        np.savez(snac_path, **random_torch_state(SNACConfig.snac_24khz(), 5))
        write_s = time.perf_counter() - t0
        log(f"checkpoint: wrote {nbytes / 1e9:.3f} GB of bf16 safetensors (2 shards + index, "
            f"flushed to the disk), tokenizer.json and a SNAC .npz in {write_s:.2f} s "
            f"({free / 1e9:.0f} GB were free)")
        tok = BPETokenizer(ckpt)
        text = "tara: Hello there, the weather is nice."
        ids = tok.encode(text + "<custom_token_5><|eot_id|>")
        if ids[-2:] != [128261, 128009] or tok.decode(tok.encode(text)) != text:
            raise AssertionError(f"tokenizer.json round trip: {ids[-4:]}")

        os.environ.update(ORPHEUS_CHECKPOINT_PATH=str(ckpt), ORPHEUS_SNAC_PATH=str(snac_path),
                          ORPHEUS_TOKENIZER_PATH=str(ckpt), ORPHEUS_QUANT="int8",
                          ORPHEUS_KV_QUANT="int8", ORPHEUS_MODEL_SIZE="3b",
                          ORPHEUS_MAX_SEQ="8192", ORPHEUS_MAX_SLOTS="8")
        kw = dict(device="cuda", attn_impl="kernel", banded_sampling=True)
        loaded_rt = rt.ServingRuntime(**kw)
        torch.cuda.synchronize()
        with PeakRss() as rss:
            t0 = time.perf_counter()
            loaded, lcfg = loaded_rt.load_params()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        gib = 2.0**30
        shard = max(f.stat().st_size for f in ckpt.glob("*.safetensors"))
        log(f"checkpoint: loaded onto the card in {load_s:.2f} s ({nbytes / 1e9 / load_s:.2f} "
            f"GB/s; each shard fsynced and fadvised DONTNEED after writing); host RSS "
            f"{rss.start / gib:.2f} GiB before, peak {rss.peak / gib:.2f} GiB during the load "
            f"(+{(rss.peak - rss.start) / gib:.2f} GiB; largest shard {shard / gib:.2f} GiB) [{card}]")
        n = check_loaded_params(torch, loaded, mem, lcfg, cfg)
        log(f"checkpoint: {n} loaded leaves equal the written params bit for bit; config equals "
            f"orpheus_3b() in every field the model reads (max_position_embeddings 131072 read, "
            f"cache sized by ORPHEUS_MAX_SEQ)")
        t0 = time.perf_counter()
        loaded_rt.build((loaded, lcfg))
        torch.cuda.synchronize()
        log(f"checkpoint: runtime built on the loaded params (int8 quantization, engine, SNAC "
            f".npz) in {time.perf_counter() - t0:.2f} s [{card}]")
        direct_rt = rt.ServingRuntime(**kw)
        direct_rt.build((mem, cfg))
        del loaded, mem
        torch.cuda.empty_cache()
        if loaded_rt.engine.cache["k"].shape[2] != 8192:
            raise AssertionError(f"KV cache of {loaded_rt.engine.cache['k'].shape[2]} positions")

        seeds = [300 + i for i in range(len(CKPT_PROMPTS))]
        fs = loaded_rt.snac_cfg.frame_samples
        results = {}
        for name, runtime in (("loaded", loaded_rt), ("direct", direct_rt)):
            rt.set_runtime(runtime)
            if name == "loaded":
                da.reset_launch_counts()
                ig.reset_launch_counts()
                wg.reset_launch_counts()
            t0 = time.perf_counter()
            out, wall, traces = await serve(list(CKPT_PROMPTS), 7 * 24, seeds)
            torch.cuda.synchronize()
            if name == "loaded":
                launches = {**da.LAUNCHES, **ig.LAUNCHES, **wg.LAUNCHES}
            results[name] = (out, traces)
            for i, (pcm, _) in enumerate(out):
                check_pcm(np, pcm, 24, 2 * fs, f"{name} request {i}")
            log(f"checkpoint: 4 seeded requests from the {name} runtime in {wall:.2f} s, TTFA "
                f"{' / '.join(f'{t:.3f}' for _, t in out)} s (graphs captured on first use) [{card}]")
        for kname in ("decode_attention_int8_slots", "int8_gemv", "w8a8_gemm", "w8a8_quantize"):
            if launches[kname] <= 0:
                raise AssertionError(f"serving loaded weights never launched {kname}: {launches}")
        records[0]["checkpoint_launches"] = launches["decode_attention_int8_slots"]
        records[2]["checkpoint_launches"] = launches["int8_gemv"]
        records[4]["checkpoint_launches"] = launches["w8a8_gemm"]
        records[5]["checkpoint_launches"] = launches["w8a8_quantize"]
        (lo, lt), (do, dt) = results["loaded"], results["direct"]
        if lt != dt or any(len(t) == 0 for t in lt):
            raise AssertionError("token traces differ between loaded and direct params")
        if any(a[0] != b[0] for a, b in zip(lo, do)):
            raise AssertionError("PCM differs between loaded and direct params")
        log(f"checkpoint: traces identical ({sum(map(len, lt))} tokens) and PCM bit-identical, "
            f"loaded vs direct; launches {launches}")
        if format_prompt_ids(CKPT_PROMPTS[0], "tara") != format_prompt_ids(
                CKPT_PROMPTS[0], "tara", tok):
            raise AssertionError("the served prompts were not tokenized by tokenizer.json")
        await direct_rt.engine.close()

        rt.set_runtime(loaded_rt)
        os.chdir(workdir)  # POST /config writes .env here
        ttfa = await phase_checkpoint_server(card, np, fs, workdir)

        codes = trace_codes(lt[0])
        runner, url = await sse_stub(codes)
        try:
            os.environ["ORPHEUS_API_URL"] = url
            got = bytearray()
            async for pcm in rb.stream_pcm_from_api("replayed", decoder_mode="exact"):
                got += pcm
        finally:
            await runner.cleanup()
        dec = ExactStreamDecoder(loaded_rt.snac_params, loaded_rt.snac_cfg)
        want = b"".join(h.tobytes() for h in dec.push_tokens(codes) + dec.flush())
        if not got or bytes(got) != want:
            raise AssertionError(f"remote_sse PCM ({len(got)} bytes) != exact decoder ({len(want)})")
        log(f"remote_sse: {len(codes)} codes over a local SSE stub -> {len(got)} PCM bytes, equal "
            f"to the exact stream decoder's on the card [{card}]")
        await loaded_rt.engine.close()
        log(f"checkpoint serving summary: write {write_s:.2f} s, load {load_s:.2f} s "
            f"({nbytes / 1e9 / load_s:.2f} GB/s), host peak RSS {rss.peak / 2**30:.2f} GiB, TTFA "
            f"{ttfa:.3f} s on loaded weights [{card}]")
    finally:
        os.chdir(cwd)
        rt.set_runtime(None)
        shutil.rmtree(workdir, ignore_errors=True)


# ------------------------------------------------------------ phase 8

TRAIN_SEQ = 8192      # the reference recipe's sequence length
LORA_SEQ = 2048       # JAX's LoRA step: dense attention, no recompute
RESUME_SEQ = 1024
TEXT_IDS = 2048       # a training example: text ids, then the audio band
ENCODE_SAMPLES = 24 * 2048  # 2.048 s at 24 kHz, whole 4-frame groups
ENCODE_MARGIN = 1e-4  # card codes may differ only where the CPU's best two
# cosines are closer than this (or below a level that already differed)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in fp32 on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def update_err(after, before, ref_after):
    """Two runs' updates (params after less before, all leaves as one
    vector): (relative L2 norm of their difference, largest elementwise
    difference over the largest reference update).  AdamW divides each
    gradient element by its own RMS, so elements whose gradient is near
    its epsilon can differ by a part of the learning rate; the L2 norm is
    the bound, the elementwise figure is printed."""
    from project_morpheus_tpu_torch.training.pretrain import tree_leaves

    num = den = worst = top = 0.0
    for a, b, r in zip(tree_leaves(after), tree_leaves(before), tree_leaves(ref_after)):
        want = r.detach().cpu().double() - b.cpu().double()
        d = a.detach().cpu().double() - b.cpu().double() - want
        num, den = num + float((d * d).sum()), den + float((want * want).sum())
        worst, top = max(worst, float(d.abs().max())), max(top, float(want.abs().max()))
    return (num / den) ** 0.5, worst / top


def train_example(np, cfg, seq: int, seed: int) -> dict:
    """``seq`` ids from a numpy seed: ``TEXT_IDS`` text ids, then 7-token
    audio frames in the audio band (code + position-in-frame band)."""
    from project_morpheus_tpu_torch.model.config import ORPHEUS_SPECIAL_TOKENS

    rng = np.random.default_rng(seed)
    n_text = min(TEXT_IDS, seq // 4)
    text = rng.integers(0, min(cfg.vocab_size, 128_256), n_text)
    pos = np.arange(seq - n_text)
    audio = ORPHEUS_SPECIAL_TOKENS["audio_base"] + rng.integers(0, 4096, pos.size) + (pos % 7) * 4096
    audio = np.minimum(audio, cfg.vocab_size - 1)
    return {"input_ids": np.concatenate([text, audio]).tolist()}


def phase_train_small(torch, np, card: str) -> None:
    """(a) card vs CPU on a small model in fp32 with TF32 off: loss and
    grads with dense and blockwise attention, the chunked-vocab loss vs the
    dense one, and 3 AdamW steps through ``make_train_step``."""
    from project_morpheus_tpu_torch.model.llama import init_llama_params
    from project_morpheus_tpu_torch.tools.graph_check import small_config
    from project_morpheus_tpu_torch.training import pretrain as tp

    cfg = small_config()
    cpu_params = init_llama_params(cfg, 3, "cpu", torch.float32)
    rng = np.random.default_rng(3)
    B, S = 2, 256
    ids = rng.integers(5, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    mask[1, 200:] = False
    labels = np.where(mask, ids, -100).astype(np.int32)
    labels[0, :9] = -100
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels}

    def copy(dev):
        return tp.tree_map(lambda t: t.to(dev, copy=True), cpu_params)

    def loss_grads(params, impl, chunk=0):
        leaves = tp.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = tp.causal_lm_loss(params, batch, cfg, attn_impl=impl, logits_chunk=chunk)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    tc = tp.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, max_grad_norm=0.5)
    for impl in ("dense", "blockwise"):
        lc, gc = loss_grads(copy("cpu"), impl)
        lg, gg = loss_grads(copy("cuda"), impl)
        loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
        grad_err = max(rel_err(a, b) for a, b in zip(gg, gc))
        runs = {}
        for dev in ("cpu", "cuda"):
            params = copy(dev)
            opt = tp.make_optimizer(tc)
            state, step = opt.init(params), tp.make_train_step(cfg, opt, attn_impl=impl)
            runs[dev] = (params, [float(step(params, state, batch)[2]) for _ in range(3)])
        step_err = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][1], runs["cpu"][1]))
        upd, upd_max = update_err(runs["cuda"][0], cpu_params, runs["cpu"][0])
        if loss_err > 1e-5 or grad_err > 1e-4 or step_err > 1e-5 or upd > 1e-3:
            raise AssertionError(f"train {impl}, card vs CPU: loss {loss_err:.2e}, grads "
                                 f"{grad_err:.2e}, step losses {step_err:.2e}, updates {upd:.2e}")
        log(f"train (a) {impl}, card vs CPU (fp32, TF32 off; 2 layers, D=256, vocab 1024, "
            f"B=2 x S=256, one row padded): max rel err loss {loss_err:.2e}, grads "
            f"{grad_err:.2e}, 3 AdamW steps' losses {step_err:.2e}, their updates {upd:.2e} "
            f"(relative L2; largest element {upd_max:.2e} of the largest update) (limits 1e-5, "
            f"1e-4, 1e-5, 1e-3)")
    dense, _ = loss_grads(copy("cuda"), "blockwise")
    chunked, _ = loss_grads(copy("cuda"), "blockwise", chunk=64)
    chunk_err = abs(float(chunked) - float(dense)) / abs(float(dense))
    if chunk_err > 1e-5:
        raise AssertionError(f"chunked-vocab loss vs dense on the card: {chunk_err:.2e}")
    log(f"train (a) chunked-vocab loss (64-position chunks) vs dense loss on the card: max rel "
        f"err {chunk_err:.2e} (limit 1e-5)")


def phase_train_attention(torch, card: str) -> None:
    """(b) the training attention at the 3B shape (H=24, KV=8, HD=128,
    S=8192, B=1, bf16, right padding): the card's SDPA path vs the plain
    blockwise twin, forward and dq/dk/dv, with the time of each."""
    from project_morpheus_tpu_torch.ops import blockwise_attention as ba

    B, S, H, KV, HD = 1, TRAIN_SEQ, 24, 8, 128
    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, w = (torch.randn(B, S, h, HD, generator=g, device="cuda").to(torch.bfloat16)
                  for h in (H, KV, KV, H))
    mask = torch.ones(B, S, dtype=torch.bool, device="cuda")
    mask[:, S - 1000:] = False

    def run(fn, reps):
        """(output, dq/dk/dv, forward ms, forward + backward ms): the times
        are the mean of ``reps`` runs after a warm one, or of one run."""
        fwd = both = 0.0
        for i in range(reps + 1):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*leaves, mask)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads = torch.autograd.grad((out.float() * w.float()).sum(), leaves)
            torch.cuda.synchronize()
            if i > 0 or reps == 0:
                fwd, both = fwd + t1 - t0, both + time.perf_counter() - t0
        n = max(reps, 1)
        return out.detach(), grads, 1e3 * fwd / n, 1e3 * both / n

    out, grads, fwd_ms, all_ms = run(ba.sdpa_attention, 5)
    tout, tgrads, tfwd_ms, tall_ms = run(ba.blockwise_attention_twin, 0)
    check_close(out, tout.float(), "training attention forward, SDPA vs twin")
    errs = [rel_err(a, b) for a, b in zip(grads, tgrads)]
    if max(errs) > 2e-2:
        raise AssertionError(f"training attention dq/dk/dv vs twin: {errs}")
    flops = 2 * S * S * HD * H  # causal QK^T and PV
    log(f"train (b) attention at B=1, S=8192, H=24, KV=8, HD=128, bf16, keys past 7192 "
        f"padded: SDPA backend {ba.SDPA_BACKEND} {fwd_ms:.2f} ms forward, {all_ms:.2f} ms "
        f"forward + backward (means of 5 runs, the loss's product included); plain blockwise "
        f"twin {tfwd_ms:.1f} / {tall_ms:.1f} ms (one run); forward "
        f"within 1e-2|ref| + 2e-3, dq/dk/dv max err {errs[0]:.2e} / {errs[1]:.2e} / "
        f"{errs[2]:.2e} of max |ref| (limit 2e-2); causal forward {flops / 1e12:.3f} TFLOP, "
        f"{flops / fwd_ms / 1e9:.0f} TFLOP/s [{card}]")


def matmul_params(cfg) -> int:
    """Weights that meet a matmul each token: the projections of every
    layer and the lm head (tied: the embedding, read as a matrix); the
    embedding lookup is not a matmul."""
    D, F, HD = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    per_layer = D * cfg.num_heads * HD * 2 + D * cfg.num_kv_heads * HD * 2 + 3 * D * F
    return cfg.num_layers * per_layer + D * cfg.padded_vocab


def phase_train_3b(torch, np, card: str):
    """(c) Orpheus-3B at full width, seq 8192, batch 1, through
    ``train_loop``'s auto long posture; returns the trained params."""
    from project_morpheus_tpu_torch.model import LlamaConfig
    from project_morpheus_tpu_torch.model.llama import init_llama_params
    from project_morpheus_tpu_torch.training.pretrain import TrainConfig, resolve_attn, train_loop

    cfg = LlamaConfig.orpheus_3b()
    params = init_llama_params(cfg, 13, "cuda", torch.bfloat16)
    ex = train_example(np, cfg, TRAIN_SEQ, 13)
    batches = [{"kind": ("text", "audio")[i % 2], "examples": [ex]} for i in range(6)]
    tc = TrainConfig(seq_len=TRAIN_SEQ, warmup_steps=1, log_every=1)
    logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trained, _ = train_loop(params, cfg, iter(batches), tc=tc, log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    del params
    losses = [r.get("text_loss", r.get("audio_loss")) for r in logs]
    if len(losses) != 6 or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[1]:
        raise AssertionError(f"3B training losses {losses}")
    step_s = (logs[-1]["elapsed_s"] - logs[0]["elapsed_s"]) / 5
    TRAIN_3B.update(losses=losses, ms_step=1e3 * step_s)
    n_mm = matmul_params(cfg)
    attn = 2 * TRAIN_SEQ**2 * cfg.head_dim * cfg.num_heads * cfg.num_layers
    flops = 6 * n_mm * TRAIN_SEQ + 3 * attn
    log(f"train (c) Orpheus-3B full width (28 layers, D 3072, vocab 157,184 padded, tied, bf16), "
        f"seq 8192, batch 1, {resolve_attn(TRAIN_SEQ)} + chunked-vocab loss, AdamW (bf16 "
        f"moments): losses {' '.join(f'{x:.4f}' for x in losses)} (first step at rate 0); "
        f"{1e3 * step_s:.1f} ms/step over steps 2-6, {TRAIN_SEQ / step_s:.0f} tokens/s; 6 steps "
        f"in {wall:.1f} s; peak allocated {peak / 2**30:.2f} GiB, reserved {reserved / 2**30:.2f} "
        f"GiB (the caller's 6.6 GB of initial params included) [{card}]")
    print(f"train_mfu: {flops / step_s / H100_BF16_OPS_PER_S:.4f} = (6 * N_matmul * T + 3 * "
          f"causal attention FLOPs) / step time / 989e12; N_matmul = {n_mm:,} (28 layers' "
          f"projections + the tied lm head), T = {TRAIN_SEQ}, causal attention = 2 * S^2 * HD * H "
          f"* L = {attn:.4e} FLOPs forward; recompute not counted; step {1e3 * step_s:.1f} ms "
          f"[{card}]", flush=True)
    return trained, cfg


def phase_train_lora(torch, np, card: str, base, cfg):
    """(d) LoRA r=32, alpha=64, rslora on the 3B base, seq 2048, batch 1,
    3 steps: the base bit-identical, the adapters moved."""
    from project_morpheus_tpu_torch.training.data import pad_collate
    from project_morpheus_tpu_torch.training.lora import (
        LoraConfig, init_lora_params, make_lora_train_step)
    from project_morpheus_tpu_torch.training.pretrain import TrainConfig, make_optimizer, tree_leaves

    lc = LoraConfig(rank=32, alpha=64.0, rslora=True)
    lora = init_lora_params(cfg, lc, 17, "cuda")
    before = [t.clone() for t in tree_leaves(base)]
    opt = make_optimizer(TrainConfig(learning_rate=1e-4, warmup_steps=1, total_steps=10))
    state, step = opt.init(lora), make_lora_train_step(cfg, lc, opt)
    batch = pad_collate([train_example(np, cfg, LORA_SEQ, 17)], max_len=LORA_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        lora, state, loss = step(lora, state, base, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(base), before))
    del before
    moved = float(lora["layers"]["wq"]["b"].detach().abs().sum())
    if not same or moved == 0 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"LoRA: base unchanged {same}, |B| {moved}, losses {losses}")
    log(f"train (d) LoRA r=32 alpha=64 rslora on the 3B base, seq 2048, batch 1, dense "
        f"attention, no recompute: losses {' '.join(f'{x:.4f}' for x in losses)}; "
        f"{1e3 * sum(times[1:]) / 2:.1f} ms/step (steps 2-3); peak allocated "
        f"{peak / 2**30:.2f} GiB; base params bit-identical, adapters moved [{card}]")
    return lora, lc


async def serve_traces_of(runtime, prompts, seeds):
    from project_morpheus_tpu_torch.adapters import runtime as rt

    rt.set_runtime(runtime)
    try:
        _, wall, traces = await serve(list(prompts), 7 * 12, seeds)
    finally:
        await runtime.engine.close()
        rt.set_runtime(None)
    return traces, wall


def phase_train_to_serve(torch, card: str, trained, cfg, lora, lc) -> None:
    """(e) the trained 3B params merged with the adapters, saved in the
    port's format and served from ``ORPHEUS_CHECKPOINT_PATH`` (int8
    weights, int8 KV): tokens equal to a runtime handed the same params."""
    from project_morpheus_tpu_torch.adapters import runtime as rt
    from project_morpheus_tpu_torch.training.checkpoint import save_params
    from project_morpheus_tpu_torch.training.lora import merge_lora
    from project_morpheus_tpu_torch.training.pretrain import tree_leaves

    merged = merge_lora(trained, lora, lc)
    workdir = tempfile.mkdtemp(prefix="orpheus_trained_")
    try:
        t0 = time.perf_counter()
        save_params(Path(workdir, "trained"), merged, step=6, cfg=cfg)
        write_s = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(merged))
        for k in ("ORPHEUS_SNAC_PATH", "ORPHEUS_TOKENIZER_PATH"):
            os.environ.pop(k, None)  # phase 7's files are gone
        os.environ.update(ORPHEUS_CHECKPOINT_PATH=str(Path(workdir, "trained")),
                          ORPHEUS_QUANT="int8", ORPHEUS_KV_QUANT="int8", ORPHEUS_MODEL_SIZE="3b",
                          ORPHEUS_MAX_SEQ="8192", ORPHEUS_MAX_SLOTS="8")
        kw = dict(device="cuda", attn_impl="kernel", banded_sampling=True)
        loaded_rt = rt.ServingRuntime(**kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded, lcfg = loaded_rt.load_params()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if lcfg != cfg or not all(torch.equal(a, b) for a, b in
                                  zip(tree_leaves(loaded), tree_leaves(merged))):
            raise AssertionError("the port's checkpoint did not load back bit for bit")
        loaded_rt.build((loaded, lcfg))
        del loaded
        seeds = [500, 501]
        got, wall = asyncio.run(serve_traces_of(loaded_rt, CKPT_PROMPTS[:2], seeds))
        del loaded_rt
        direct_rt = rt.ServingRuntime(**kw)
        direct_rt.build((merged, cfg))
        want, _ = asyncio.run(serve_traces_of(direct_rt, CKPT_PROMPTS[:2], seeds))
        del direct_rt
        if got != want or any(len(t) == 0 for t in got):
            raise AssertionError("tokens served from the saved checkpoint differ from the params'")
        log(f"train (e) train to serve: merged 3B params saved in the port's format "
            f"({nbytes / 1e9:.3f} GB, {write_s:.2f} s), loaded from ORPHEUS_CHECKPOINT_PATH in "
            f"{load_s:.2f} s ({nbytes / 1e9 / load_s:.2f} GB/s) bit for bit; 2 seeded requests "
            f"(int8 weights, int8 KV) in {wall:.2f} s: {sum(map(len, got))} tokens, equal to a "
            f"runtime handed the params [{card}]")
    finally:
        os.environ.pop("ORPHEUS_CHECKPOINT_PATH", None)
        shutil.rmtree(workdir, ignore_errors=True)


def kill_resume_main() -> int:
    """(f), in a process of its own (``CUBLAS_WORKSPACE_CONFIG`` set, and
    ``torch.use_deterministic_algorithms``: an op without a deterministic
    form raises; the memory-efficient attention's backward switches to its
    deterministic algorithm, which it otherwise only warns about):
    Orpheus-3B widths at 4 layers,
    seq 1024, blockwise attention with recompute; 4 steps straight vs 2
    steps, ``save_train_state``, fresh objects, ``restore_train_state`` and
    2 more.  Prints one JSON line; exit code 0 when losses and params are
    equal."""
    import dataclasses
    import warnings

    import numpy as np
    import torch

    from project_morpheus_tpu_torch.model import LlamaConfig
    from project_morpheus_tpu_torch.model.llama import init_llama_params
    from project_morpheus_tpu_torch.training.pretrain import TrainConfig, train_loop, tree_leaves

    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(LlamaConfig.orpheus_3b(), num_layers=4)
    params = init_llama_params(cfg, 19, "cuda", torch.bfloat16)
    ex = train_example(np, cfg, RESUME_SEQ, 19)

    def batches():
        return iter([{"kind": ("text", "audio")[i % 2], "examples": [ex]} for i in range(4)])

    tc = TrainConfig(seq_len=RESUME_SEQ, warmup_steps=1, total_steps=4, log_every=1,
                     attn_impl="blockwise", remat="on")
    workdir = tempfile.mkdtemp(prefix="orpheus_resume_")
    runs = {"straight": [], "resumed": []}

    def losses(name):
        return lambda r: runs[name].extend(v for k, v in r.items() if k.endswith("_loss"))

    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            straight, _ = train_loop(params, cfg, batches(), tc=tc, log=losses("straight"))
            train_loop(params, cfg, batches(), tc=dataclasses.replace(tc, total_steps=2),
                       checkpoint_dir=workdir, log=losses("resumed"))
            resumed, _ = train_loop(params, cfg, batches(), tc=tc, checkpoint_dir=workdir,
                                    log=losses("resumed"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    same_params = all(torch.equal(x, y) for x, y in zip(tree_leaves(straight), tree_leaves(resumed)))
    notes = sorted({str(w.message).split(".")[0] for w in caught
                    if "determinis" in str(w.message)})
    print(json.dumps({**runs, "params_equal": same_params, "determinism_warnings": notes}),
          flush=True)
    ok = runs["straight"] == runs["resumed"] and len(runs["straight"]) == 4
    return 0 if ok and same_params else 1


def phase_train_resume(card: str) -> None:
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    res = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                          "sys.exit(chip_smoke.kill_resume_main())"],
                         capture_output=True, text=True, env=env, timeout=600)
    lines = [l for l in res.stdout.splitlines() if l.startswith("{")]
    if res.returncode != 0 or not lines:
        raise AssertionError(f"kill/resume: rc {res.returncode}\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    out = json.loads(lines[-1])
    log(f"train (f) kill/resume, 3B widths at 4 layers, seq 1024, blockwise: straight losses "
        f"{out['straight']}, killed after 2 and resumed {out['resumed']}: equal, params bit-equal, "
        f"under torch.use_deterministic_algorithms(True) (no op raised; warnings: "
        f"{out['determinism_warnings'] or 'none'}) [{card}]")


def phase_train_cli(card: str) -> None:
    """(g) ``python -m project_morpheus_tpu_torch.training pretrain`` on a
    tiny config, on the card, as a subprocess."""
    workdir = Path(tempfile.mkdtemp(prefix="orpheus_cli_"))
    try:
        for name, seed in (("text", 0), ("audio", 1)):
            rows = [[(seed * 7919 + i * 104729 + j * 31) % 1000 + 1 for j in range(16)]
                    for i in range(16)]
            (workdir / f"{name}.jsonl").write_text(
                "".join(json.dumps({"input_ids": ids}) + "\n" for ids in rows))
        (workdir / "cfg.yaml").write_text(
            f"model_size: tiny_vocab\ntext_data: {workdir}/text.jsonl\naudio_data: "
            f"{workdir}/audio.jsonl\nbatch_size: 4\ntotal_steps: 4\nseq_length: 16\n"
            f"learning_rate: 1e-3\nwarmup_steps: 1\ncheckpoint_dir: {workdir}/ckpt\n")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "project_morpheus_tpu_torch.training",
                              "pretrain", "--config", str(workdir / "cfg.yaml")],
                             capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        logs = [json.loads(l) for l in res.stdout.splitlines() if l.startswith("{")]
        if res.returncode != 0 or not any("text_loss" in r for r in logs) or \
                not (workdir / "ckpt" / "step_4" / "params.safetensors").exists():
            raise AssertionError(f"training CLI: rc {res.returncode}\n{res.stdout[-2000:]}\n"
                                 f"{res.stderr[-2000:]}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"train (g) CLI: python -m project_morpheus_tpu_torch.training pretrain (tiny_vocab, bf16, "
        f"on the card) exited 0 in {secs:.1f} s, logged {logs[0]}, saved step_4 [{card}]")


def phase_snac_encoder(torch, np, card: str) -> None:
    """(h) the SNAC encoder, snac_24khz, random weights, 2.048 s of seeded
    audio: card vs CPU in fp32 with TF32 off."""
    from project_morpheus_tpu_torch.codec import snac
    from project_morpheus_tpu_torch.codec.snac_config import SNACConfig
    from project_morpheus_tpu_torch.codec.weights import init_snac_params

    cfg = SNACConfig.snac_24khz()
    audio = (np.random.default_rng(23).standard_normal((1, ENCODE_SAMPLES)) * 0.1).astype(np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        params = init_snac_params(cfg, 5, dev)
        x = torch.tensor(audio, device=dev)
        snac.snac_encode(params, x, cfg)  # warm
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes, margins = snac.rvq_encode(params, snac.encode_latent(params, x, cfg), cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = ([c.cpu() for c in codes], [m.cpu() for m in margins],
                    1e3 * (time.perf_counter() - t0))
    (cc, cm, cpu_ms), (gc, _, card_ms) = res["cpu"], res["cuda"]
    # a code may differ where the CPU's best two cosines are within the
    # margin, or under a coarser level's code that already differed
    frames = cc[-1].shape[1] * cfg.vq_strides[-1]
    free = torch.zeros(frames, dtype=torch.bool)
    near = bad = 0
    for level, stride in enumerate(cfg.vq_strides):
        tie = cm[level][0] < ENCODE_MARGIN
        near += int(tie.sum())
        differ = cc[level][0] != gc[level][0]
        excused = tie | free[:differ.numel() * stride].view(-1, stride).any(dim=1)
        bad += int((differ & ~excused).sum())
        free |= (differ & excused).repeat_interleave(stride)[:frames]
    n = sum(c.numel() for c in cc)
    if bad:
        raise AssertionError(f"SNAC encoder: {bad} codes differ card vs CPU away from near-ties")
    log(f"train (h) SNAC encoder snac_24khz, {ENCODE_SAMPLES} samples: {n} codes, card equals "
        f"CPU except at near-ties; {near} positions within a {ENCODE_MARGIN:g} cosine margin; "
        f"card {card_ms:.2f} ms, CPU {cpu_ms:.1f} ms (fp32, TF32 off) [{card}]")


def phase_training(card: str) -> None:
    """Phase 8 (see the module docstring)."""
    import gc

    import numpy as np
    import torch

    from project_morpheus_tpu_torch.adapters import runtime as rt

    rt.set_runtime(None)  # serving runtimes of phases 4-7
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated at the start; "
        f"matmul TF32 {torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}")
    phase_train_small(torch, np, card)
    phase_train_attention(torch, card)
    trained, cfg = phase_train_3b(torch, np, card)
    gc.collect()
    torch.cuda.empty_cache()
    lora, lc = phase_train_lora(torch, np, card, trained, cfg)
    phase_train_to_serve(torch, card, trained, cfg, lora, lc)
    del trained, lora
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_resume(card)
    phase_train_cli(card)
    phase_snac_encoder(torch, np, card)


# ------------------------------------------------------------ phase 9

NATIVE_TEXT = "The native library joins these hops."
NATIVE_TOKENS = 7 * 24    # 24 hops: ~2 s of audio, enough for the watermark's z > 5
MESH_TOKENS = 84          # greedy tokens a request of the two-rank engine (12 frames)
MESH_SEQ = 1024           # its cache positions
MESH_LOGIT_TOL = 5e-2     # max |tp - unsharded| / max |unsharded| of one step's logits
# max |tp - reference| / max |unsharded|, the reference being the unsharded
# step computed at the ranks' shapes and sums (_tp_arithmetic)
MESH_TP_REF_TOL = 1e-3
MESH_FAULT = 1.01         # the planted fault: rank 1's wo scales times this
WATERMARK_KEY = (7, 3, 11, 5, 13)
# six utterances (the last five served at once): the watermark (-36 dB) needs
# ~200k samples for z > 5 on random-weight audio (z 3.2 on one 24-hop one)
WATERMARK_TEXTS = (NATIVE_TEXT, "Six streams share the engine.", "Marks hide under the signal.",
                   "Correlation finds the key.", "Random weights still make audio.",
                   "The last of six sentences.")
TRAIN_3B = {}             # phase 8's 3B losses, for phase 9 (d)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def served_by_client(base: str, more: bool):
    """One ``POST /v1/audio/speech`` and one ``/ws/tts`` utterance through
    the port's ``Client``, then, with ``more``, the rest of
    ``WATERMARK_TEXTS`` at once: (REST body, WS PCM, [more REST bodies])."""
    from project_morpheus_tpu_torch.server import Client

    client = Client(base)

    async def rest(text):
        return b"".join([c async for c in client.stream_rest(text, voice="tara")])

    body = await rest(NATIVE_TEXT)
    ws = b"".join([f async for f in client.stream_ws(NATIVE_TEXT, voice="tara")])
    others = await asyncio.gather(*[rest(t) for t in WATERMARK_TEXTS[1:]]) if more else []
    return body, ws, list(others)


async def orchestrated(events: list):
    """The same utterance pulled through an orchestrator with a PCM ring,
    its timeline events collected: (ring contents, ring on the library?)."""
    from project_morpheus_tpu_torch.adapters.local_torch import LocalTorchAdapter
    from project_morpheus_tpu_torch.model.sampling import SamplingParams
    from project_morpheus_tpu_torch.orchestrator import (
        ChunkLadder, Orchestrator, PlaybackBuffer, RingBuffer)

    ring = RingBuffer(1 << 20, 24_000)
    adapter = LocalTorchAdapter(NATIVE_TEXT, sampling=SamplingParams(
        temperature=0.0, max_tokens=NATIVE_TOKENS))
    orch = Orchestrator(adapter, PlaybackBuffer(capacity_ms=1000.0), ChunkLadder(), ring=ring)
    async for _ in orch.stream(on_event=events.append):
        pass
    return ring.read(len(ring)), ring._native is not None


async def stitched_hops(pcm: bytes, hop_bytes: int) -> bytes:
    """``pcm``'s hops joined by the stitcher with a 10 ms crossfade."""
    from project_morpheus_tpu_torch.orchestrator import AudioChunk, stitch_chunks

    async def hops():
        for i in range(0, len(pcm), hop_bytes):
            yield AudioChunk(pcm=pcm[i:i + hop_bytes], duration_ms=0.0,
                             eos=i + hop_bytes >= len(pcm))

    return b"".join([c.pcm async for c in stitch_chunks(hops(), sample_rate=24_000,
                                                       overlap_ms=10.0)])


async def phase_native_client(card: str, np) -> None:
    """9 (a): the native PCM library, the client, replay and watermark on
    the 3B int8 runtime."""
    from aiohttp import web

    from project_morpheus_tpu_torch import native
    from project_morpheus_tpu_torch.adapters import runtime as rt
    from project_morpheus_tpu_torch.server import create_app
    from project_morpheus_tpu_torch.tools.profile_serving import serving_runtime
    from project_morpheus_tpu_torch.utils import replay, watermark

    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    runtime = serving_runtime()
    fs = runtime.snac_cfg.frame_samples
    workdir = Path(tempfile.mkdtemp(prefix="orpheus_native_"))
    got = {}
    try:
        for flag in ("", "1"):
            os.environ[native.FLAG] = flag
            runner = web.AppRunner(create_app(generation={"temperature": 0.0,
                                                          "max_tokens": NATIVE_TOKENS}))
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            try:
                rest, ws, others = await served_by_client(
                    f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}", not flag)
            finally:
                await runner.cleanup()
            events = []
            ring, on_lib = await orchestrated(events)
            got[flag] = dict(rest=rest, others=others, ws=ws,
                             stitched=await stitched_hops(rest[44:], 2 * fs),
                             ring=ring, on_lib=on_lib, events=events)
    finally:
        os.environ.pop(native.FLAG, None)
    off, on = got[""], got["1"]
    if off["on_lib"] or not on["on_lib"]:
        raise AssertionError(f"ring on the library: flag unset {off['on_lib']}, set {on['on_lib']}")
    rest = off["rest"]
    if rest[:4] != b"RIFF" or rest[44:] != off["ws"]:
        raise AssertionError("REST and /ws/tts PCM differ for the same greedy utterance")
    check_pcm(np, rest[44:], NATIVE_TOKENS // 7, 2 * fs, "client REST")
    if len(on["stitched"]) != len(rest) - 44 - 2 * 240 * (NATIVE_TOKENS // 7 - 1):
        raise AssertionError(f"stitched {len(on['stitched'])} bytes of {len(rest) - 44}")
    if on["ring"] != rest[44:]:
        raise AssertionError("the orchestrator's ring holds other PCM than the server sent")
    for key in ("rest", "ws", "stitched", "ring"):
        if off[key] != on[key]:
            raise AssertionError(f"{key}: PCM differs with ORPHEUS_NATIVE_PCM=1")
    log(f"native (a): pcm_ops built with g++ in {build_s:.2f} s (0 if it was built already); "
        f"Client REST {len(rest) - 44} and "
        f"/ws/tts {len(off['ws'])} PCM bytes, equal; orchestrator ring {len(on['ring'])} bytes "
        f"and its hops stitched with a 10 ms crossfade, {len(on['stitched'])} bytes: equal with "
        f"ORPHEUS_NATIVE_PCM=1 (ring and crossfade on the C++ library) and without [{card}]")

    log_path = workdir / "timeline.jsonl"
    log_path.write_text("".join(json.dumps(e) + "\n" for e in on["events"]))
    n = replay.replay_to_wav(log_path, workdir / "replay.wav", 24_000)
    import wave

    with wave.open(str(workdir / "replay.wav")) as wf:
        frames = wf.readframes(wf.getnframes())
    shutil.rmtree(workdir, ignore_errors=True)
    if frames != on["ring"] or n != len(frames):
        raise AssertionError(f"replayed timeline: {n} bytes, the ring held {len(on['ring'])}")
    for body in off["others"]:
        check_pcm(np, body[44:], NATIVE_TOKENS // 7, 2 * fs, "client REST, concurrent")
    pcm = np.frombuffer(b"".join(b[44:] for b in [rest, *off["others"]]), np.int16)
    marked = watermark.embed(pcm, WATERMARK_KEY)
    z, z_other, z_clean = (watermark.detect(marked, WATERMARK_KEY),
                           watermark.detect(marked, watermark.DEFAULT_KEY),
                           watermark.detect(pcm, WATERMARK_KEY))
    if not watermark.verify(marked, WATERMARK_KEY) or watermark.verify(pcm, WATERMARK_KEY) \
            or watermark.verify(marked, watermark.DEFAULT_KEY):
        raise AssertionError(f"watermark: detect {z:.2f} with the key, {z_other:.2f} with "
                             f"another, {z_clean:.2f} unmarked (threshold 5)")
    rms, peak = native.meter(pcm)
    v = np.abs(pcm.astype(np.float64)) / 32768.0
    if abs(rms - float(np.sqrt(np.mean(v * v)))) > 1e-12 or peak != float(v.max()):
        raise AssertionError("native meter differs from numpy")
    log(f"native (a): timeline of {len(on['events'])} events replayed to {n} PCM bytes, equal to "
        f"the ring's; watermark on {len(WATERMARK_TEXTS)} served utterances "
        f"({pcm.size} samples): detect {z:.2f} with the key, {z_other:.2f} "
        f"with another, {z_clean:.2f} unmarked (threshold 5); meter rms {rms:.4f} peak "
        f"{peak:.4f} equal to numpy [{card}]")
    await runtime.engine.close()
    rt.set_runtime(None)


async def phase_mesh_serving(card: str, torch, records) -> None:
    """9 (b): the 3B int8 engine on a 1 x 1 mesh over NCCL, CUDA graphs
    with the collectives captured: phase 4's seeded traces must equal the
    unsharded engine's."""
    from project_morpheus_tpu_torch.adapters import runtime as rt
    from project_morpheus_tpu_torch.engine import OrpheusEngine
    from project_morpheus_tpu_torch.ops import decode_attention as da
    from project_morpheus_tpu_torch.ops import int8_gemv as ig
    from project_morpheus_tpu_torch.ops import prefill_attention as pa
    from project_morpheus_tpu_torch.ops import w8a8_gemm as wg
    from project_morpheus_tpu_torch.parallel import make_mesh
    from project_morpheus_tpu_torch.parallel.mesh import STATE
    from project_morpheus_tpu_torch.tools.profile_serving import (
        PROMPTS, TOKENS_PER_REQUEST, serving_runtime)

    mesh = make_mesh(1, 1)
    if STATE.backend != "nccl" or mesh.group("model") is None:
        raise AssertionError(f"world of one: backend {STATE.backend}, groups {mesh.groups}")
    runtime = serving_runtime()
    base = runtime.engine
    seeds = [100 + i for i in range(len(PROMPTS))]
    _, wall_b, ref = await serve(list(PROMPTS), TOKENS_PER_REQUEST, seeds)
    mesh_eng = OrpheusEngine(base.params, base.cfg, base.ecfg, codec=base._codec, mesh=mesh,
                             device="cuda")
    runtime.engine = mesh_eng
    da.reset_launch_counts()
    ig.reset_launch_counts()
    pa.reset_launch_counts()
    wg.reset_launch_counts()
    torch.cuda.synchronize()
    _, wall_m, got = await serve(list(PROMPTS), TOKENS_PER_REQUEST, seeds)
    torch.cuda.synchronize()
    launches = {**da.LAUNCHES, **ig.LAUNCHES, **pa.LAUNCHES, **wg.LAUNCHES}
    if got != ref or any(len(t) == 0 for t in ref):
        where = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                 for a, b in zip(ref, got)]
        raise AssertionError(f"mesh engine traces differ from the unsharded engine's: {where}")
    if mesh_eng.programs.captures == 0 or mesh_eng.programs.replays == 0:
        raise AssertionError("the mesh engine over NCCL captured or replayed no CUDA graph")
    prefill = {k for k in mesh_eng.programs.graph_keys if k[0] == "prefill"}
    if not prefill:
        raise AssertionError("the mesh engine over NCCL captured no prefill round")
    if min(launches[k] for k in ("decode_attention_int8_slots", "int8_gemv",
                                 "prefill_chunk_attention", "w8a8_gemm", "w8a8_quantize")) <= 0:
        raise AssertionError(f"mesh engine launches {launches}")
    records[0]["mesh_launches"] = launches["decode_attention_int8_slots"]
    records[2]["mesh_launches"] = launches["int8_gemv"]
    records[3]["mesh_launches"] = launches["prefill_chunk_attention"]
    records[4]["mesh_launches"] = launches["w8a8_gemm"]
    log(f"mesh (b): 3B int8 engine on a 1 x 1 mesh over {STATE.backend} (world of one, "
        f"collectives in the {mesh_eng.programs.captures} captured graphs, "
        f"{len(prefill)} of them prefill rounds, "
        f"{mesh_eng.programs.replays} replays): phase 4's 4 seeded traces "
        f"({sum(map(len, got))} tokens) equal the unsharded engine's; {wall_m:.2f} s vs "
        f"{wall_b:.2f} s unsharded (graphs captured on first use in both); launches {launches} "
        f"[{card}]")
    await mesh_eng.close()
    runtime.engine = base
    await base.close()
    rt.set_runtime(None)


@contextlib.contextmanager
def _tp_arithmetic(params, tp: int = 2):
    """The unsharded model computing each product as ``tp`` ranks do, cut
    from the whole weights here (not by ``parallel/``): q/k/v, gate and up
    by output-column blocks, the tied lm head by vocab-row blocks, each
    block through the same product at the rank's shape and the blocks
    joined; o and down by input-row blocks, each through the same product
    (bf16 out) and the blocks added in fp32 and cast back
    (``parallel/tensor.py: reduce``); the decode kernel and the prefill
    attention over each rank's block of kv heads.  Patches the functions
    ``model/llama.py`` and ``model/quant.py`` call, for the storages of
    ``params`` only."""
    import torch

    from project_morpheus_tpu_torch.model import llama, quant

    def ptrs(*names):
        return {params["layers"][n]["q"].untyped_storage().data_ptr() for n in names}

    cols, rows = ptrs("wq", "wk", "wv", "wg", "wu"), ptrs("wo", "wd")
    head = params["embed"]["q"].untyped_storage().data_ptr()
    blocks = lambda n: [slice(r * n // tp, (r + 1) * n // tp) for r in range(tp)]  # noqa: E731

    def product(f):
        def cut(h, q, scale, *args, **kwargs):
            ptr = q.untyped_storage().data_ptr()
            if kwargs.get("k_major") and ptr == head:  # (Vp, D): vocab rows
                return torch.cat([f(h, q[b], scale[b], *args, **kwargs)
                                  for b in blocks(q.shape[0])], -1)
            if ptr in cols:
                return torch.cat([f(h, q[:, b].contiguous(), scale[..., b].contiguous(), *args,
                                    **kwargs) for b in blocks(q.shape[1])], -1)
            if ptr in rows:
                parts = [f(h[..., b].contiguous(), q[b], scale, *args, **kwargs)
                         for b in blocks(q.shape[0])]
                return sum(p.float() for p in parts).to(parts[0].dtype)
            return f(h, q, scale, *args, **kwargs)
        return cut

    def slot_kernel(q0, k, v, scale, live, layer):
        B, H, HD = q0.shape
        KV = k.shape[-1] // HD
        one = slice(layer, layer + 1)
        out = []
        for hb, kb in zip(blocks(H), blocks(KV)):
            dims = slice(kb.start * HD, kb.stop * HD)
            sc = scale[one]
            sc = torch.cat([sc[..., kb], sc[..., KV + kb.start:KV + kb.stop]], -1)
            out.append(saved_slot(q0[:, hb].contiguous(), k[one, ..., dims].contiguous(),
                                  v[one, ..., dims].contiguous(), sc.contiguous(), live, 0))
        return torch.cat(out, 1)

    def chunk_attn(q, layer, slots, offsets, hist_bucket):
        J, C, H, HD = q.shape
        quant_kv = "scale" in layer
        KV = layer["k"].shape[-1] // HD if quant_kv else layer["k"].shape[1]
        out = []
        for hb, kb in zip(blocks(H), blocks(KV)):
            if quant_kv:
                dims = slice(kb.start * HD, kb.stop * HD)
                sc = layer["scale"]
                part = {"k": layer["k"][..., dims], "v": layer["v"][..., dims],
                        "scale": torch.cat([sc[..., kb], sc[..., KV + kb.start:KV + kb.stop]], -1)}
            else:
                part = {"k": layer["k"][:, kb], "v": layer["v"][:, kb]}
            part = {n: t.contiguous() for n, t in part.items()}
            out.append(saved_chunk(q[:, :, hb].contiguous(), part, slots, offsets, hist_bucket))
        return torch.cat(out, -1)

    saved = quant.int8_gemv, quant.dequant_matmul
    saved_slot, saved_chunk = llama.decode_attention_int8_slots, llama.prefill_chunk_attention
    quant.int8_gemv, quant.dequant_matmul = (product(f) for f in saved)
    llama.decode_attention_int8_slots, llama.prefill_chunk_attention = slot_kernel, chunk_attn
    try:
        yield
    finally:
        quant.int8_gemv, quant.dequant_matmul = saved
        llama.decode_attention_int8_slots, llama.prefill_chunk_attention = saved_slot, saved_chunk


def tp2_main(device: str = "cuda", cfg=None) -> int:
    """One rank of phase 9 (c): ``RANK``, ``WORLD_SIZE`` 2 and
    ``TP2_STORE`` / ``TP2_OUT`` set by :func:`phase_tp2`; both ranks on the
    one card over gloo.  Writes its result JSON to ``TP2_OUT``.rank.
    ``device="cpu"`` with a small ``cfg`` (or its fields as JSON in
    ``TP2_CFG``) rehearses it on the CPU (the kernels' plain twins run
    there)."""
    import torch

    from project_morpheus_tpu_torch.engine import EngineConfig, OrpheusEngine
    from project_morpheus_tpu_torch.model import LlamaConfig
    from project_morpheus_tpu_torch.model.llama import (
        init_kv_cache, init_llama_params, llama_decode_step, llama_prefill_chunk)
    from project_morpheus_tpu_torch.model.quant import quantize_params_int8
    from project_morpheus_tpu_torch.model.sampling import SamplingParams
    from project_morpheus_tpu_torch.model.tokenizer import format_prompt_ids
    from project_morpheus_tpu_torch.ops import build, decode_attention as da, int8_gemv as ig
    from project_morpheus_tpu_torch.ops import w8a8_gemm as wg
    from project_morpheus_tpu_torch.parallel import initialize_distributed, make_mesh
    from project_morpheus_tpu_torch.parallel.mesh import STATE
    from project_morpheus_tpu_torch.parallel.tensor import NO_TP

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["RANK"])
    initialize_distributed(f"file://{os.environ['TP2_STORE']}", 2, rank, device=device,
                           timeout_s=300)
    mesh = make_mesh(1, 2)
    if device == "cuda":
        build.build_all()
    if cfg is None:
        fields = os.environ.get("TP2_CFG")
        cfg = LlamaConfig(**json.loads(fields)) if fields else LlamaConfig.orpheus_3b()
    full = quantize_params_int8(init_llama_params(cfg, 17, device, torch.bfloat16))
    prompts = [format_prompt_ids(p, "tara") for p in CKPT_PROMPTS]
    ecfg = EngineConfig(max_slots=4, max_seq_len=MESH_SEQ, cache_dtype="int8",
                        attn_impl="kernel", default_stop_ids=())
    eng = OrpheusEngine(full, cfg, ecfg, mesh=mesh, device=device)
    out = {"rank": rank, "backend": STATE.backend, "graphs": eng.programs.graphs}

    # every sharded GEMV shape, M = 1 and 4, and the slot kernel at 4 kv heads
    lp, shapes = eng.params["layers"], {}
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        q, sc = lp[name]["q"][0], lp[name]["scale"][0]
        for m in (1, 4):
            h = torch.randn(m, q.shape[0], device=device).to(torch.bfloat16)
            shapes[f"{name} {tuple(q.shape)} M={m}"] = check_close(
                ig.int8_gemv(h, q, sc), ig.int8_gemv_plain(h, q, sc).float(), f"gemv {name}")
    emb = eng.params["embed"]
    for m in (1, 4):
        h = torch.randn(m, emb["q"].shape[1], device=device).to(torch.bfloat16)
        want = ig.int8_gemv_plain(h, emb["q"], emb["scale"], k_major=True)
        err = (ig.int8_gemv(h, emb["q"], emb["scale"], k_major=True) - want).abs()
        if bool((err > 1e-2 * want.abs() + 2e-3).any()):
            raise AssertionError(f"gemv lm_head shard: max err {err.max().item():.3e}")
        shapes[f"lm_head (N, K) {tuple(emb['q'].shape)} M={m}"] = err.max().item()
    out["gemv"] = shapes

    # one decode step of four slots, sharded vs unsharded (rank 0 holds both)
    def step(params, tp, ccfg):
        cache = init_kv_cache(ccfg, 4, MESH_SEQ, torch.int8, device)
        for slot, ids in enumerate(prompts):
            toks = torch.zeros(64, dtype=torch.int32, device=device)
            toks[:len(ids)] = torch.tensor(ids, device=device)
            llama_prefill_chunk(params, toks, cfg, cache, 0, slot, len(ids), hist_bucket=256,
                                tp=tp)
        lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
        toks = torch.tensor([p[-1] for p in prompts], dtype=torch.int32, device=device)
        return llama_decode_step(params, toks, cfg, cache, lengths, attn_impl="kernel",
                                 tp=tp), cache, lengths + 1

    local_cfg = eng.tp.local_cfg(cfg)
    logits, cache, live = step(eng.params, eng.tp, local_cfg)
    q0 = torch.randn(4, cfg.num_heads // 2, cfg.head_dim, device=device).to(torch.bfloat16)
    out["slot_kernel"] = check_close(
        da.decode_attention_int8_slots(q0, cache["k"], cache["v"], cache["scale"], live,
                                       cfg.num_layers - 1),
        da.decode_attention_int8_slots_plain(q0, cache["k"], cache["v"], cache["scale"], live,
                                             cfg.num_layers - 1).float(), "slot kernel, 4 kv heads")
    out["slot_kernel_shape"] = list(cache["k"].shape)
    del cache
    # the planted fault: the same step with rank 1's wo scales off by MESH_FAULT
    wo_scale = eng.params["layers"]["wo"]["scale"]
    kept = wo_scale.clone()
    if rank == 1:
        wo_scale.mul_(MESH_FAULT)
    faulty, _, _ = step(eng.params, eng.tp, local_cfg)
    wo_scale.copy_(kept)
    if rank == 0:
        ref, _, _ = step(full, NO_TP, cfg)
        with _tp_arithmetic(full):
            tp_ref, _, _ = step(full, NO_TP, cfg)
        top = ref.abs().max().item()

        def rel(a, b):
            return (a - b).abs().max().item() / top

        out["logits_err"], out["logits_max"] = (logits - ref).abs().max().item(), top
        out["argmax_equal"] = int((logits.argmax(-1) == ref.argmax(-1)).sum())
        out["tp_ref_err"] = rel(logits, tp_ref)         # tp vs the tp-arithmetic reference
        out["tp_ref_vs_ref"] = rel(tp_ref, ref)         # what the ranks' arithmetic moves
        out["fault_err"] = rel(faulty, tp_ref)          # the planted fault vs the reference
        out["fault_vs_ref"] = rel(faulty, ref)

    async def run_engine(engine):
        reqs = [await engine.submit(p, SamplingParams(temperature=0.0, max_tokens=MESH_TOKENS,
                                                      stop_token_ids=())) for p in prompts]
        traces = [[t async for t in r.tokens()] for r in reqs]
        await engine.close()
        return traces

    da.reset_launch_counts()
    ig.reset_launch_counts()
    wg.reset_launch_counts()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    traces = asyncio.run(run_engine(eng))
    sync()
    wall = time.perf_counter() - t0
    out.update(traces=traces, steps=eng.steps, wall=wall,
               launches={**da.LAUNCHES, **ig.LAUNCHES, **wg.LAUNCHES})
    if rank == 0:
        ref_eng = OrpheusEngine(full, cfg, ecfg, device=device)
        out["ref_traces"] = asyncio.run(run_engine(ref_eng))
    Path(f"{os.environ['TP2_OUT']}.{rank}").write_text(json.dumps(out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_tp2(card: str, records, device: str = "cuda", cfg=None,
              timeout_s: float = 400.0) -> dict:
    """9 (c): two ranks on the one card over gloo, Orpheus-3B at full width,
    int8 weights and KV, tp = 2, the slot kernel on each rank's heads.
    ``device="cpu"`` with a small ``cfg`` runs the same checks on the CPU,
    without the kernels' launch counts.  Returns rank 0's readings."""
    import dataclasses

    workdir = Path(tempfile.mkdtemp(prefix="orpheus_tp2_"))
    here = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    env.update(WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", TP2_STORE=str(workdir / "store"),
               TP2_OUT=str(workdir / "out"),
               PYTHONPATH=os.pathsep.join(filter(None, (here, env.get("PYTHONPATH")))))
    if cfg is not None:
        env["TP2_CFG"] = json.dumps(dataclasses.asdict(cfg))
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", "import sys, chip_smoke; "
                               f"sys.exit(chip_smoke.tp2_main({device!r}))"],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=here)
             for r in range(2)]
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.perf_counter() - t0 > timeout_s):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    secs = time.perf_counter() - t0
    try:
        if any(p.returncode != 0 for p in procs):
            tails = "\n".join(f"rank {r} (rc {p.returncode}):\n"
                              f"{(workdir / f'rank{r}.log').read_text()[-3000:]}"
                              for r, p in enumerate(procs))
            raise AssertionError(f"two-rank TP run failed after {secs:.0f} s:\n{tails}")
        res = [json.loads(Path(f"{workdir}/out.{r}").read_text()) for r in range(2)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    r0 = res[0]
    if r0["traces"] != res[1]["traces"] or any(r["backend"] != "gloo" or r["graphs"] for r in res):
        raise AssertionError(f"ranks disagree or ran graphs/backend wrongly: "
                             f"{[(r['backend'], r['graphs']) for r in res]}")
    rel = r0["logits_err"] / r0["logits_max"]
    if not rel <= MESH_LOGIT_TOL:
        raise AssertionError(f"tp=2 decode logits vs unsharded: max err {r0['logits_err']:.4e} "
                             f"of max |logit| {r0['logits_max']:.4e} (limit {MESH_LOGIT_TOL})")
    if not r0["tp_ref_err"] <= MESH_TP_REF_TOL < r0["fault_err"]:
        raise AssertionError(
            f"tp=2 logits vs the tp-arithmetic reference {r0['tp_ref_err']:.3e}, a planted "
            f"fault (rank 1's wo scales x{MESH_FAULT}) {r0['fault_err']:.3e}: the limit "
            f"{MESH_TP_REF_TOL} must lie between the two")
    agree, firsts = [], []
    for a, b in zip(r0["traces"], r0["ref_traces"]):
        if len(a) != MESH_TOKENS or len(b) != MESH_TOKENS:
            raise AssertionError(f"greedy traces of {len(a)} / {len(b)} tokens")
        agree.append(sum(x == y for x, y in zip(a, b)))
        firsts.append(next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None))
    for r in res:
        if device == "cuda" and min(r["launches"][k] for k in (
                "decode_attention_int8_slots", "int8_gemv", "w8a8_gemm", "w8a8_quantize")) <= 0:
            raise AssertionError(f"rank {r['rank']} launches {r['launches']}")
    records[0]["tp2_launches_a_rank"] = r0["launches"]["decode_attention_int8_slots"]
    records[2]["tp2_launches_a_rank"] = r0["launches"]["int8_gemv"]
    if device == "cuda":
        records[4]["tp2_launches_a_rank"] = r0["launches"]["w8a8_gemm"]
    gemv = ", ".join(f"{k} {v:.2e}" for k, v in r0["gemv"].items())
    log(f"tp2 (c): 2 ranks on one card over gloo (host-staged collectives, frame programs "
        f"eager), {'Orpheus-3B full width' if cfg is None else cfg}, int8 weights and KV, tp=2, slot kernel on 4 kv heads "
        f"a rank; run {secs:.1f} s with start-up")
    log(f"  decode step logits tp=2 vs unsharded (4 slots): max abs err {r0['logits_err']:.4e}, "
        f"{rel:.2e} of max |logit| {r0['logits_max']:.3f} (limit {MESH_LOGIT_TOL}); argmax "
        f"equal in {r0['argmax_equal']} of 4 slots [{card}]")
    log(f"  the same vs the tp-arithmetic reference (unsharded, each product and the attention "
        f"at the ranks' shapes, wo / wd halves added in fp32): {r0['tp_ref_err']:.4e} of max "
        f"|logit| (limit {MESH_TP_REF_TOL}); the reference vs unsharded "
        f"{r0['tp_ref_vs_ref']:.4e}; a planted fault, rank 1's wo scales "
        f"x{MESH_FAULT}: {r0['fault_err']:.4e} vs the reference, {r0['fault_vs_ref']:.4e} vs "
        f"unsharded [{card}]")
    log(f"  4 greedy requests x {MESH_TOKENS} tokens: tokens equal to the unsharded engine's "
        f"{agree} (first divergence at {firsts}); ranks identical; "
        f"{1e3 * r0['wall'] / max(r0['steps'], 1):.1f} ms a step over {r0['steps']} steps "
        f"(eager and host-staged: a smoke number) [{card}]")
    log(f"  rank 0 kernels vs twins: GEMV shard shapes max abs err {gemv}; slot kernel on the "
        f"rank's cache {r0['slot_kernel_shape']} max abs err {r0['slot_kernel']:.2e}; launches "
        f"in the TP engine run rank 0 {r0['launches']}, rank 1 {res[1]['launches']} [{card}]")
    return r0


def phase_mesh_training(card: str, np, torch) -> None:
    """9 (d): Orpheus-3B, seq 8192, batch 1, phase 8's seed and batches,
    2 steps of ``train_loop`` on a 1 x 1 mesh over NCCL in ``fsdp`` and
    ``fsdp_tp``: losses equal to the single-device trainer's."""
    import gc

    from project_morpheus_tpu_torch.model import LlamaConfig
    from project_morpheus_tpu_torch.model.llama import init_llama_params
    from project_morpheus_tpu_torch.parallel import make_mesh
    from project_morpheus_tpu_torch.training.pretrain import TrainConfig, train_loop

    cfg = LlamaConfig.orpheus_3b()
    ex = train_example(np, cfg, TRAIN_SEQ, 13)
    batches = [{"kind": ("text", "audio")[i % 2], "examples": [ex]} for i in range(2)]
    tc = TrainConfig(seq_len=TRAIN_SEQ, warmup_steps=1, log_every=1)  # phase 8's
    want = TRAIN_3B["losses"][:2]
    mesh = make_mesh(1, 1)
    for mode in ("fsdp", "fsdp_tp"):
        params = init_llama_params(cfg, 13, "cuda", torch.bfloat16)
        logs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trained, _ = train_loop(params, cfg, iter(batches), tc=tc, mesh=mesh, shard_mode=mode,
                                log=logs.append)
        torch.cuda.synchronize()
        del params, trained
        gc.collect()
        torch.cuda.empty_cache()
        losses = [r.get("text_loss", r.get("audio_loss")) for r in logs]
        if losses != want:
            raise AssertionError(f"mesh training {mode}: losses {losses}, single device {want}")
        log(f"mesh (d) train Orpheus-3B seq 8192 batch 1 on a 1 x 1 mesh over NCCL, {mode}: "
            f"losses {losses} equal to the single-device trainer's; step 2 "
            f"{1e3 * (logs[1]['elapsed_s'] - logs[0]['elapsed_s']):.1f} ms (single device "
            f"{TRAIN_3B['ms_step']:.1f} ms/step over steps 2-6); peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")


def start_torchrun_cli():
    """9 (e): start the training CLI under ``torchrun --nproc_per_node 1``
    in the background; :func:`finish_torchrun_cli` checks it."""
    workdir = Path(tempfile.mkdtemp(prefix="orpheus_torchrun_"))
    for name, seed in (("text", 0), ("audio", 1)):
        rows = [[(seed * 7919 + i * 104729 + j * 31) % 1000 + 1 for j in range(16)]
                for i in range(16)]
        (workdir / f"{name}.jsonl").write_text(
            "".join(json.dumps({"input_ids": ids}) + "\n" for ids in rows))
    (workdir / "cfg.yaml").write_text(
        f"model_size: tiny_vocab\ntext_data: {workdir}/text.jsonl\naudio_data: "
        f"{workdir}/audio.jsonl\nbatch_size: 4\ntotal_steps: 4\nseq_length: 16\n"
        f"learning_rate: 1e-3\nwarmup_steps: 1\ncheckpoint_dir: {workdir}/ckpt\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node", "1", "-m", "project_morpheus_tpu_torch.training",
                             "pretrain", "--config", str(workdir / "cfg.yaml")],
                            stdout=open(workdir / "out.txt", "w"),
                            stderr=open(workdir / "err.txt", "w"), env=env)
    return proc, workdir, time.perf_counter()


def finish_torchrun_cli(card: str, started) -> None:
    proc, workdir, t0 = started
    try:
        try:
            rc = proc.wait(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError("torchrun CLI: still running after 300 s")
        secs = time.perf_counter() - t0
        out = (workdir / "out.txt").read_text()
        logs = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
        if rc != 0 or not any("text_loss" in r for r in logs) or \
                not (workdir / "ckpt" / "step_4" / "params.safetensors").exists():
            raise AssertionError(f"torchrun CLI: rc {rc}\n{out[-2000:]}\n"
                                 f"{(workdir / 'err.txt').read_text()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"mesh (e) torchrun --nproc_per_node 1 -m project_morpheus_tpu_torch.training pretrain "
        f"(a 1 x 1 mesh, fsdp, NCCL; run beside (c) and (d)): exited 0 after {secs:.1f} s, "
        f"logged {logs[0]}, saved step_4 [{card}]")


def phase_parallel(card: str, records) -> None:
    """Phase 9 (see the module docstring)."""
    import gc

    import numpy as np
    import torch

    from project_morpheus_tpu_torch.parallel import initialize_distributed, shutdown_distributed

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    asyncio.run(phase_native_client(card, np))
    initialize_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, device="cuda")
    cli = None
    try:
        asyncio.run(phase_mesh_serving(card, torch, records))
        gc.collect()
        torch.cuda.empty_cache()
        cli = start_torchrun_cli()
        phase_tp2(card, records)
        phase_mesh_training(card, np, torch)
        finish_torchrun_cli(card, cli)
    finally:
        if cli is not None and cli[0].poll() is None:  # a phase before it raised
            cli[0].kill()
            cli[0].wait()
            shutil.rmtree(cli[1], ignore_errors=True)
        shutdown_distributed()
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")


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
    phase_prefill_kv_heads(torch, dev)
    records.append(phase_gemv(torch, dev))
    records.append(phase_prefill_kernel(torch, dev))
    records.extend(phase_w8a8(torch, dev))
    phase_int8_scales(torch, dev)
    phase_reference(torch, dev)
    phase_graphs(torch, dev)

    gemv_line = asyncio.run(serving_phases(card, records))
    asyncio.run(phase_checkpoint(card, records))
    phase_training(card)
    phase_parallel(card, records)
    log(f"chip_smoke total: {time.perf_counter() - _T0:.1f} s")

    print(gemv_line)
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


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
