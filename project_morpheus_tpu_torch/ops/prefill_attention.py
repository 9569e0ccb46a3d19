"""Chunk-prefill attention over the slot KV cache (CUDA).

The JAX package computes a prefill chunk's attention with
``_chunk_streaming_attn`` (``project_morpheus_tpu/model/llama.py:643``),
plain ``jnp`` that XLA fuses into the jitted prefill program and vmaps
over the J jobs of a lockstep round.  It is not a Pallas kernel.  The port
writes it as one hand-written kernel, ``csrc/prefill_chunk_attention.cu``
(built by ``ops/build.py``), so that a prefill round is a handful of
launches a layer and captures as a CUDA graph (``engine/graphs.py``): the
per-job Python loop of 256-key einsum blocks it replaces made ~90,000
launches a round at the serving shapes.

:func:`prefill_chunk_attention` takes one layer of the cache in either
layout of ``model/llama.py``:

- int8, position-major: ``k``/``v`` ``(B, S, KV*HD)`` and fp32 ``scale``
  ``(B, S, 2KV)`` (k scales first);
- bf16, head-major: ``k``/``v`` ``(B, KV, S, HD)``.

Job ``j`` attends its chunk's queries ``(C, H, HD)`` at positions
``offsets[j] + c`` over positions ``0 .. offsets[j] + c`` of lane
``slots[j]``, read no further than ``hist_bucket``; the chunk's own K/V is
already written.  Both indices are device tensors, so a captured round
replays with any offsets and slots.  It rounds as the JAX function does:
``q * HD**-0.5`` rounded to the dot dtype, int8 history exact in bf16,
k scales on the scores, v scales on the probabilities before they round to
the dot dtype for P.V, fp32 sums.

The kernel (Hopper: wgmma on TMA-fed tiles, int8 tiles converted by the
copying warpgroup, heaviest row tiles first; its source says how) takes
head dims 64 and 128 and any number of kv heads, one included (a
tensor-parallel rank's share of Orpheus-3B's eight at tp = 8): a tile's
int8 scale rows are one contiguous run of the lane, copied whole.

The wrapper sends CPU tensors to the plain twin, that function applied
job by job, and launches the kernel for CUDA tensors, or raises: nothing
falls back.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build

# kernel launches (never counts a plain-twin call)
LAUNCHES = {"prefill_chunk_attention": 0}

_SRC = "prefill_chunk_attention.cu"


def reset_launch_counts() -> None:
    LAUNCHES["prefill_chunk_attention"] = 0


def _dot_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.float32 if dt == torch.float16 else dt


# ------------------------------------------------------------- plain twin


def _chunk_streaming_attn(
    qg: torch.Tensor,      # (S, KV, G, HD) chunk queries
    k_s: torch.Tensor,     # (KV, hist, HD) history keys (bf16 or int8)
    v_s: torch.Tensor,
    ks_s: Optional[torch.Tensor],  # (KV, hist) fp32 scales or None
    vs_s: Optional[torch.Tensor],
    positions: torch.Tensor,       # (S,) absolute positions of the queries
    hist_bucket: int,
    block_k: int = 256,
    n_live: Optional[int] = None,  # live-history frontier: later blocks skipped
) -> torch.Tensor:
    """Online-softmax attention of a prompt chunk over its history, block by
    block (temporaries stay at block size; int8 history dequantises per
    block, with its scales applied to scores and probs)."""
    S, KV, G, HD = qg.shape
    block_k = min(block_k, hist_bucket)
    nk = hist_bucket // block_k
    assert nk * block_k == hist_bucket, "context buckets are 256-multiples"
    quant = ks_s is not None
    dot_dt = _dot_dtype(qg.dtype)
    qb = (qg.float() * HD**-0.5).to(dot_dt).float()
    n_blocks = nk if n_live is None else min(-(-n_live // block_k), nk)

    m = torch.full((KV, G, S), -1e30, dtype=torch.float32, device=qg.device)
    l = torch.zeros((KV, G, S), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((KV, G, S, HD), dtype=torch.float32, device=qg.device)
    for blk in range(n_blocks):
        sl = slice(blk * block_k, (blk + 1) * block_k)
        kb = k_s[:, sl].to(dot_dt).float()
        vb = v_s[:, sl].to(dot_dt).float()
        s = torch.einsum("skgd,kbd->kgsb", qb, kb)  # (KV, G, S, block_k)
        if quant:
            s = s * ks_s[:, None, None, sl]
        kp = blk * block_k + torch.arange(block_k, device=qg.device)
        valid = kp[None, None, None, :] <= positions[None, None, :, None]
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if quant:
            p = p * vs_s[:, None, None, sl]
        acc = acc * alpha[..., None] + torch.einsum(
            "kgsb,kbd->kgsd", p.to(dot_dt).float(), vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (KV, G, S, HD)
    return out.permute(2, 0, 1, 3).reshape(S, KV * G * HD)


def _layout(layer: Dict[str, torch.Tensor], HD: int):
    """(quant, B, S, KV) of one layer of the cache."""
    quant = "scale" in layer
    if quant:
        B, S, DKV = layer["k"].shape
        return True, B, S, DKV // HD
    B, KV, S, _ = layer["k"].shape
    return False, B, S, KV


def prefill_chunk_attention_plain(q, layer, slots, offsets, hist_bucket: int) -> torch.Tensor:
    """Plain twin of :func:`prefill_chunk_attention`: ``_chunk_streaming_attn``
    for each job over its lane's history views, each job's blocks past its
    own frontier skipped (exact: those keys are masked).  Returns
    ``(J, C, H*HD)`` in ``q.dtype``."""
    J, C, H, HD = q.shape
    quant, _B, S, KV = _layout(layer, HD)
    outs = []
    for j, (slot, off) in enumerate(zip(slots.tolist(), offsets.tolist())):
        # the chunk was written at [off, off + C) of a lane of S positions
        assert 0 <= off and off + C <= S, f"chunk [{off}, {off + C}) outside the cache's {S}"
        if quant:
            k_s = layer["k"][slot, :hist_bucket].reshape(hist_bucket, KV, HD).transpose(0, 1)
            v_s = layer["v"][slot, :hist_bucket].reshape(hist_bucket, KV, HD).transpose(0, 1)
            sc = layer["scale"][slot, :hist_bucket]
            ks_s, vs_s = sc[:, :KV].T, sc[:, KV:].T
        else:
            k_s = layer["k"][slot, :, :hist_bucket]
            v_s = layer["v"][slot, :, :hist_bucket]
            ks_s = vs_s = None
        positions = off + torch.arange(C, dtype=torch.int32, device=q.device)
        outs.append(_chunk_streaming_attn(q[j].reshape(C, KV, H // KV, HD), k_s, v_s, ks_s,
                                          vs_s, positions, hist_bucket, n_live=off + C))
    return torch.stack(outs).to(q.dtype)


# ---------------------------------------------------------------- wrapper


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# pointers: q k v scale slots offsets out; ints B J C H KV HD S hist quant; scale; stream
_ARGTYPES = [_P] * 7 + [_I] * 9 + [_F, _P]


def prefill_chunk_attention(
    q: torch.Tensor,                    # (J, C, H, HD) chunk queries, RoPE applied
    layer: Dict[str, torch.Tensor],     # one layer of the cache (module docstring)
    slots: torch.Tensor,                # (J,) int32 cache lanes
    offsets: torch.Tensor,              # (J,) int32 chunk start positions
    hist_bucket: int,                   # attention reads positions [0, hist_bucket)
) -> torch.Tensor:
    """Each job's chunk over its own lane's history: ``(J, C, H*HD)`` in
    ``q.dtype``."""
    tensors = (q, slots, offsets, *layer.values())
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return prefill_chunk_attention_plain(q, layer, slots, offsets, hist_bucket)
    _require(devs == {"cuda"}, f"prefill attention takes tensors all on cpu or cuda, got {devs}")
    J, C, H, HD = q.shape
    quant, B, S, KV = _layout(layer, HD)
    k, v = layer["k"], layer["v"]
    _require(q.dtype == torch.bfloat16 and q.is_contiguous(), "q must be contiguous bfloat16")
    _require(H % KV == 0, "query heads must be a multiple of kv heads")
    _require(k.dtype == v.dtype == (torch.int8 if quant else torch.bfloat16),
             "cache must be int8 with scales, or bfloat16")
    _require(k.shape == v.shape and k.is_contiguous() and v.is_contiguous(),
             "k and v must be contiguous and of one shape")
    if quant:
        sc = layer["scale"]
        _require(sc.dtype == torch.float32 and sc.shape == (B, S, 2 * KV) and sc.is_contiguous(),
                 "scale must be contiguous fp32 (B, S, 2KV)")
    else:
        _require(k.shape == (B, KV, S, HD), "bf16 cache must be (B, KV, S, HD)")
    for t, name in ((slots, "slots"), (offsets, "offsets")):
        _require(t.dtype == torch.int32 and t.shape == (J,) and t.is_contiguous(),
                 f"{name} must be contiguous int32 of shape (J,)")
    _require(0 < hist_bucket <= S, f"hist_bucket {hist_bucket} outside (0, {S}]")
    out = torch.empty((J, C, H, HD), dtype=q.dtype, device=q.device)
    lib = build.load(_SRC)
    fn = lib.mp_prefill_chunk_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    layer["scale"].data_ptr() if quant else 0,
                    slots.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                    B, J, C, H, KV, HD, S, int(hist_bucket), int(quant), HD**-0.5, stream)
    if status != 0:
        raise RuntimeError(
            f"prefill_chunk_attention launch failed: {lib.mp_error_string(status).decode()}")
    LAUNCHES["prefill_chunk_attention"] += 1
    return out.view(J, C, H * HD)
