"""Llama-3.2-class decoder forward for serving (port of model/llama.py).

Inference only: chunked prefill into the slot KV cache and the per-token
decode step, with the JAX package's parameter tree and cache layouts kept
byte-identical so the tests hold both packages to the same numbers:

- params: ``{"embed", "layers": {stacked (L, ...) leaves}, "ln_f"[,
  "lm_head"]}``; a weight is a tensor or an int8 leaf ``{"q", "scale"}``
  (``model/quant.py``), fused ``wqkv``/``wgu`` or separate.
- int8 cache: flat position-major ``k``/``v`` ``(L, B, S, KV*HD)`` plus
  ``scale`` ``(L, B, S, 2KV)`` (k scales first); bf16 cache: head-major
  ``(L, B, KV, S, HD)``.

Where JAX threads an immutable cache through a layer loop, the port
updates the cache tensors IN PLACE (so a captured CUDA graph of the decode
step writes the engine's cache where it lies); the decode-attention kernels read the
cache where it lies (see ``ops/decode_attention.py``).  Dots that JAX runs
with ``preferred_element_type=float32`` run here on operands rounded to
the model dtype and then widened to fp32, so both packages round at the
same points and differ only in summation order.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.decode_attention import (
    decode_attention_int8_slots,
    decode_attention_layered,
)
from .config import LlamaConfig
from .quant import (
    embed_lookup,
    is_quantized,
    matmul_maybe_quant,
    matmul_w8a8,
    tied_lm_head_logits,
)

Params = Dict[str, object]
KVCache = Dict[str, torch.Tensor]


# ------------------------------------------------------------------ helpers


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_inv_freqs(cfg: LlamaConfig, device=None) -> torch.Tensor:
    """Inverse RoPE frequencies with llama-3 long-context scaling."""
    d = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    if cfg.rope_scaling_factor == 1.0:
        return inv
    low_wl = cfg.rope_original_max_pos / cfg.rope_low_freq_factor
    high_wl = cfg.rope_original_max_pos / cfg.rope_high_freq_factor
    wavelen = 2.0 * math.pi / inv
    smooth = (cfg.rope_original_max_pos / wavelen - cfg.rope_low_freq_factor) / (
        cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
    )
    return torch.where(
        wavelen < high_wl,
        inv,
        torch.where(
            wavelen > low_wl,
            inv / cfg.rope_scaling_factor,
            (1.0 - smooth) * inv / cfg.rope_scaling_factor + smooth * inv,
        ),
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freqs: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` of shape (B, S, H, D) by per-token ``positions`` (B, S)."""
    angles = positions[..., None].float() * inv_freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> KVCache:
    """Slot-table KV cache in the JAX package's layouts (module docstring)."""
    S = max_len or cfg.max_seq_len
    L, KV, HD = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    if dtype == torch.int8:
        shape = (L, batch, S, KV * HD)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "scale": torch.zeros((L, batch, S, 2 * KV), dtype=torch.float32, device=device),
        }
    shape = (L, batch, KV, S, HD)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_is_quantized(cache: KVCache) -> bool:
    return "scale" in cache


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position symmetric int8 over the last axis: (int8, fp32 scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _layer(lp: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the stacked layer weights (views, no copies)."""
    return {
        k: ({"q": w["q"][i], "scale": w["scale"][i]} if is_quantized(w) else w[i])
        for k, w in lp.items()
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _project_qkv(h, wl, cfg: LlamaConfig, mm=matmul_maybe_quant):
    """Q/K/V projections, from a fused ``wqkv`` leaf when present."""
    HD, KV, H = cfg.head_dim, cfg.num_kv_heads, cfg.num_heads
    if "wqkv" in wl:
        qkv = mm(h, wl["wqkv"])
        nq = H * HD
        return (_split_heads(qkv[..., :nq], H, HD),
                _split_heads(qkv[..., nq:nq + KV * HD], KV, HD),
                _split_heads(qkv[..., nq + KV * HD:], KV, HD))
    return (_split_heads(mm(h, wl["wq"]), H, HD),
            _split_heads(mm(h, wl["wk"]), KV, HD),
            _split_heads(mm(h, wl["wv"]), KV, HD))


def _mlp(h, wl, cfg: LlamaConfig, mm=matmul_maybe_quant):
    """SwiGLU MLP, from a fused ``wgu`` leaf when present."""
    if "wgu" in wl:
        gu = mm(h, wl["wgu"])
        F_ = cfg.intermediate_size
        act = F.silu(gu[..., :F_]) * gu[..., F_:]
    else:
        act = F.silu(mm(h, wl["wg"])) * mm(h, wl["wu"])
    return mm(act, wl["wd"])


def _logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params.get("lm_head")
    if head is None:
        return tied_lm_head_logits(x, params["embed"])
    return matmul_maybe_quant(x, head).float()


def _dot_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.float32 if dt == torch.float16 else dt


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


# ------------------------------------------------------------------ prefill


@torch.no_grad()
def llama_prefill_chunk(
    params: Params,
    tokens: torch.Tensor,   # (S,) int — one (padded) chunk of one slot's prompt
    cfg: LlamaConfig,
    cache: KVCache,         # updated in place
    offset: int,            # chunk start position in the context
    slot: int,              # target cache lane
    length: int,            # real tokens in this chunk
    *,
    hist_bucket: int,       # attention reads cache[:hist_bucket]
    w8a8: bool = False,     # int8-activation projections/MLP
) -> torch.Tensor:
    """One prompt chunk against the KV history already in the cache.

    Writes the chunk's K/V at ``offset`` of lane ``slot`` and returns the
    fp32 logits ``(padded_vocab,)`` of the chunk's last real position: the
    batched round of :func:`llama_prefill_chunk_batch` with one job."""
    return llama_prefill_chunk_batch(
        params, tokens[None], cfg, cache, [offset], [slot], [length],
        hist_bucket=hist_bucket, w8a8=w8a8)[0]


@torch.no_grad()
def llama_prefill_chunk_batch(
    params: Params,
    tokens: torch.Tensor,       # (J, C) int — one (padded) chunk from each of J slots
    cfg: LlamaConfig,
    cache: KVCache,             # updated in place
    offsets: Sequence[int],     # (J,) chunk start positions
    slots: Sequence[int],       # (J,) target cache lanes
    lengths: Sequence[int],     # (J,) real tokens in each chunk
    *,
    hist_bucket: int,           # attention reads cache[:hist_bucket]
    w8a8: bool = False,
) -> torch.Tensor:
    """One prompt chunk from EACH of J slots in one pass: the projections
    and MLP run on ``(J * C, D)`` rows, and each chunk attends only to its
    own slot's history, so the result equals J sequential single-chunk
    calls.  Offsets, slots and lengths are host integers (the engine's
    chunk plan).  Returns the fp32 logits ``(J, padded_vocab)`` of each
    chunk's last real position."""
    J, C = tokens.shape
    KV, HD = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV
    quant = kv_cache_is_quantized(cache)
    dev = tokens.device
    inv_freqs = rope_inv_freqs(cfg, dev)
    steps = torch.arange(C, dtype=torch.int32, device=dev)
    positions = torch.stack([off + steps for off in offsets])  # (J, C)
    n_live = max(offsets) + C
    x = embed_lookup(params["embed"], tokens, params["ln_f"].dtype)  # (J, C, D)
    mm = matmul_w8a8 if w8a8 else matmul_maybe_quant
    lp = params["layers"]
    for i in range(cfg.num_layers):
        wl = _layer(lp, i)
        h = rmsnorm(x, wl["ln1"], cfg.rms_eps)
        q, k, v = _project_qkv(h, wl, cfg, mm)  # (J, C, H/KV, HD)
        q = apply_rope(q, positions, inv_freqs)
        k = apply_rope(k, positions, inv_freqs)
        if quant:
            kq, ksc = quantize_kv(k)  # (J, C, KV, HD), (J, C, KV)
            vq, vsc = quantize_kv(v)
            sc = torch.cat([ksc, vsc], dim=-1)
        attn = []
        for j, (off, slot) in enumerate(zip(offsets, slots)):
            w = slice(off, off + C)
            if quant:
                cache["k"][i, slot, w] = kq[j].reshape(C, KV * HD)
                cache["v"][i, slot, w] = vq[j].reshape(C, KV * HD)
                cache["scale"][i, slot, w] = sc[j]
                k_s = cache["k"][i, slot, :hist_bucket].reshape(hist_bucket, KV, HD).transpose(0, 1)
                v_s = cache["v"][i, slot, :hist_bucket].reshape(hist_bucket, KV, HD).transpose(0, 1)
                sc_s = cache["scale"][i, slot, :hist_bucket]
                ks_s, vs_s = sc_s[:, :KV].T, sc_s[:, KV:].T
            else:
                cache["k"][i, slot, :, w] = k[j].transpose(0, 1).to(cache["k"].dtype)
                cache["v"][i, slot, :, w] = v[j].transpose(0, 1).to(cache["v"].dtype)
                k_s = cache["k"][i, slot, :, :hist_bucket]
                v_s = cache["v"][i, slot, :, :hist_bucket]
                ks_s = vs_s = None
            attn.append(_chunk_streaming_attn(
                q[j].reshape(C, KV, G, HD), k_s, v_s, ks_s, vs_s, positions[j],
                hist_bucket, n_live=n_live))
        attn = torch.stack(attn).reshape(J, C, cfg.num_heads * HD).to(x.dtype)
        x = x + mm(attn, wl["wo"])
        h = rmsnorm(x, wl["ln2"], cfg.rms_eps)
        x = x + _mlp(h, wl, cfg, mm)
    x_last = torch.stack([x[j, n - 1] for j, n in enumerate(lengths)])  # (J, D)
    return _logits(params, rmsnorm(x_last, params["ln_f"], cfg.rms_eps))


# ------------------------------------------------------------------- decode


def _int_dot(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """Exact integer einsum of int8 operands: float64 holds every partial
    sum exactly (|sum| < 2**53), so no int8 batched product is needed."""
    return torch.einsum(eq, a.double(), b.double())


@torch.no_grad()
def llama_decode_step(
    params: Params,
    tokens: torch.Tensor,   # (B,) int — one new token per slot
    cfg: LlamaConfig,
    cache: KVCache,         # updated in place
    lengths: torch.Tensor,  # (B,) int32 current context length per slot
    *,
    active: Optional[torch.Tensor] = None,  # (B,) bool; inactive logits zeroed
    attn_impl: str = "dense",  # "dense" | "kernel" (the CUDA flash kernels)
    bucket: Optional[int] = None,  # dense attention reads cache[:bucket]
) -> torch.Tensor:
    """One decode step for every slot: writes each token's K/V at
    ``lengths[b]`` and attends positions ``<= lengths[b]``.  Returns fp32
    logits ``(B, padded_vocab)``.

    Three attention branches, as in the JAX step: ``kernel`` (the slot
    int8 kernel on an int8 cache, the layered kernel on a bf16 one), dense
    int8 (int8 q.k and requantised probs, exact integer dots), dense bf16.
    """
    B = tokens.shape[0]
    quant = kv_cache_is_quantized(cache)
    S = cache["k"].shape[2 if quant else 3]
    KV, HD = cfg.num_kv_heads, cfg.head_dim
    DKV, G = KV * HD, cfg.num_heads // KV
    bkt = min(bucket or S, S)
    dev = tokens.device
    inv_freqs = rope_inv_freqs(cfg, dev)
    x = embed_lookup(params["embed"], tokens[:, None], params["ln_f"].dtype)  # (B, 1, D)
    positions = lengths[:, None]
    pos_l = lengths.long()
    slots = torch.arange(B, device=dev)
    key_mask = torch.arange(bkt, device=dev)[None, :] <= lengths[:, None]  # (B, bkt)
    live = lengths + 1  # positions each kernel attends, the new token's included
    lp = params["layers"]
    for i in range(cfg.num_layers):
        wl = _layer(lp, i)
        h = rmsnorm(x, wl["ln1"], cfg.rms_eps)
        q, k, v = _project_qkv(h, wl, cfg)
        q = apply_rope(q, positions, inv_freqs)
        k = apply_rope(k, positions, inv_freqs)
        # every slot's new K/V at lengths[b], one indexed write per tensor
        if quant:
            kq, ksc = quantize_kv(k[:, 0])  # (B, KV, HD), (B, KV)
            vq, vsc = quantize_kv(v[:, 0])
            cache["k"][i, slots, pos_l] = kq.reshape(B, DKV)
            cache["v"][i, slots, pos_l] = vq.reshape(B, DKV)
            cache["scale"][i, slots, pos_l] = torch.cat([ksc, vsc], dim=-1)
        else:
            cache["k"][i, slots, :, pos_l] = k[:, 0].to(cache["k"].dtype)
            cache["v"][i, slots, :, pos_l] = v[:, 0].to(cache["v"].dtype)

        if attn_impl == "kernel":
            q0 = q[:, 0].contiguous()
            if quant:
                attn = decode_attention_int8_slots(
                    q0, cache["k"], cache["v"], cache["scale"], live, i)
            else:
                attn = decode_attention_layered(q0, cache["k"], cache["v"], live, i)
            attn = attn.reshape(B, 1, cfg.num_heads * HD).to(x.dtype)
        elif quant:
            k_s = cache["k"][i, :, :bkt].reshape(B, bkt, KV, HD)
            v_s = cache["v"][i, :, :bkt].reshape(B, bkt, KV, HD)
            sc_s = cache["scale"][i, :, :bkt]  # (B, bkt, 2KV)
            ks_s = sc_s[..., :KV].transpose(1, 2)  # (B, KV, bkt)
            vs_s = sc_s[..., KV:].transpose(1, 2)
            qg = q.reshape(B, KV, G, HD).float()
            qsc = torch.clamp(qg.abs().amax(dim=-1), min=1e-8) / 127.0  # (B, KV, G)
            q8 = torch.clamp(torch.round(qg / qsc[..., None]), -127, 127)
            s32 = _int_dot(q8, k_s, "bkgd,bskd->bkgs")
            scores = s32.float() * qsc[..., None] * ks_s[:, :, None, :] * (HD**-0.5)
            scores = torch.where(key_mask[:, None, None, :], scores, torch.full_like(scores, -1e30))
            probs = torch.softmax(scores, dim=-1)
            pv = probs * vs_s[:, :, None, :]
            psc = torch.clamp(pv.amax(dim=-1), min=1e-30) / 127.0
            p8 = torch.clamp(torch.round(pv / psc[..., None]), -127, 127)
            o32 = _int_dot(p8, v_s, "bkgs,bskd->bkgd")
            attn = (o32.float() * psc[..., None]).reshape(B, 1, cfg.num_heads * HD).to(x.dtype)
        else:
            k_s = cache["k"][i, :, :, :bkt]
            v_s = cache["v"][i, :, :, :bkt]
            dt = x.dtype
            qg = q.reshape(B, KV, G, HD)
            scores = torch.einsum("bkgd,bksd->bkgs", qg.float(), k_s.to(dt).float()) * (HD**-0.5)
            scores = torch.where(key_mask[:, None, None, :], scores, torch.full_like(scores, -1e30))
            probs = torch.softmax(scores, dim=-1)
            attn = torch.einsum(
                "bkgs,bksd->bkgd", probs.to(dt).float(), v_s.to(dt).float()
            ).reshape(B, 1, cfg.num_heads * HD).to(dt)
        x = x + matmul_maybe_quant(attn, wl["wo"])
        h = rmsnorm(x, wl["ln2"], cfg.rms_eps)
        x = x + _mlp(h, wl, cfg)
    x = rmsnorm(x[:, 0], params["ln_f"], cfg.rms_eps)
    logits = _logits(params, x)
    if active is not None:
        logits = torch.where(active[:, None], logits, torch.zeros_like(logits))
    return logits


# --------------------------------------------------------------------- init


@torch.no_grad()
def init_llama_params(cfg: LlamaConfig, seed: int = 0, device="cuda",
                      dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random weights drawn on ``device`` in ``dtype`` from a seeded
    generator, in the JAX package's layer-stacked layout and scales (the
    numbers differ from ``jax.random``'s; tests carry weights across with
    ``model/bridge.py`` instead)."""
    L, D, F_ = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=device, dtype=dtype) * scale

    params: Params = {
        "embed": normal((cfg.padded_vocab, D), 0.02),
        "layers": {
            "ln1": torch.ones((L, D), dtype=dtype, device=device),
            "wq": normal((L, D, H * HD), D**-0.5),
            "wk": normal((L, D, KV * HD), D**-0.5),
            "wv": normal((L, D, KV * HD), D**-0.5),
            "wo": normal((L, H * HD, D), (H * HD) ** -0.5),
            "ln2": torch.ones((L, D), dtype=dtype, device=device),
            "wg": normal((L, D, F_), D**-0.5),
            "wu": normal((L, D, F_), D**-0.5),
            "wd": normal((L, F_, D), F_**-0.5),
        },
        "ln_f": torch.ones((D,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, cfg.padded_vocab), D**-0.5)
    return params
