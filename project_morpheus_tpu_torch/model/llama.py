"""Llama-3.2-class decoder forward (port of model/llama.py).

Serving: chunked prefill into the slot KV cache and the per-token decode
step; training: the full-sequence forward (dense or blockwise attention,
LoRA, per-layer recompute), which also prefills a cache.  The JAX
package's parameter tree and cache layouts are kept byte-identical so the
tests hold both packages to the same numbers:

- params: ``{"embed", "layers": {stacked (L, ...) leaves}, "ln_f"[,
  "lm_head"]}``; a weight is a tensor or an int8 leaf ``{"q", "scale"}``
  (``model/quant.py``), fused ``wqkv``/``wgu`` or separate.
- int8 cache: flat position-major ``k``/``v`` ``(L, B, S, KV*HD)`` plus
  ``scale`` ``(L, B, S, 2KV)`` (k scales first); bf16 cache: head-major
  ``(L, B, KV, S, HD)``.

Tensor parallelism (``tp=``, a ``parallel.tensor.TensorParallel``): a
rank's params hold the ``tp`` shards of ``parallel/sharding.py`` and its
cache its own kv heads; the functions add the Megatron collectives (the
embedding and row-split partial sums summed over the group, the logits
gathered) and, without a group, compute exactly the unsharded path.

Where JAX threads an immutable cache through a layer loop, the port
updates the cache tensors IN PLACE (so a captured CUDA graph of the decode
step writes the engine's cache where it lies); the decode and chunk-prefill
attention kernels read the cache where it lies (see ``ops/decode_attention.py``
and ``ops/prefill_attention.py``).  Dots that JAX runs
with ``preferred_element_type=float32`` run here on operands rounded to
the model dtype and then widened to fp32, so both packages round at the
same points and differ only in summation order.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.decode_attention import (
    decode_attention_int8_slots,
    decode_attention_layered,
)
from ..ops.prefill_attention import prefill_chunk_attention
from ..parallel.tensor import as_tp
from .config import LlamaConfig
from .quant import (
    div127,
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
    scale = torch.clamp(div127(xf.abs().amax(dim=-1)), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def int8_q_scale(qg: torch.Tensor) -> torch.Tensor:
    """The dense int8 branch's per-row query scales (fp32 ``qg``, rows on
    the last axis)."""
    return div127(torch.clamp(qg.abs().amax(dim=-1), min=1e-8))


def int8_p_scale(pv: torch.Tensor) -> torch.Tensor:
    """The dense int8 branch's per-row scales of the v-scaled probabilities."""
    return div127(torch.clamp(pv.amax(dim=-1), min=1e-30))


def _layer(lp: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the stacked layer weights (views, no copies;
    an int8 leaf keeps its K-major copy ``qt`` where it has one)."""
    return {k: ({n: t[i] for n, t in w.items()} if is_quantized(w) else w[i])
            for k, w in lp.items()}


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


def _mlp(h, wl, cfg: LlamaConfig, mm=matmul_maybe_quant, mm_down=None):
    """SwiGLU MLP, from a fused ``wgu`` leaf when present; ``mm_down``
    (default ``mm``) multiplies the down projection."""
    if "wgu" in wl:
        gu = mm(h, wl["wgu"])
        F_ = cfg.intermediate_size
        act = F.silu(gu[..., :F_]) * gu[..., F_:]
    else:
        act = F.silu(mm(h, wl["wg"])) * mm(h, wl["wu"])
    return (mm_down or mm)(act, wl["wd"])


def lm_head_logits(params: Params, h: torch.Tensor, tp=None) -> torch.Tensor:
    """Final hidden -> fp32 logits over ``padded_vocab`` (tied embedding or
    a separate lm_head); the chunked-vocab training loss applies it to one
    sequence chunk at a time.  Under ``tp``: this rank's vocab columns."""
    h = as_tp(tp).enter(h)
    head = params.get("lm_head")
    if head is None:
        return tied_lm_head_logits(h, params["embed"])
    return matmul_maybe_quant(h, head).float()


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
    tp=None,                # tensor parallelism (module docstring)
) -> torch.Tensor:
    """One prompt chunk against the KV history already in the cache.

    Writes the chunk's K/V at ``offset`` of lane ``slot`` and returns the
    fp32 logits ``(padded_vocab,)`` of the chunk's last real position: the
    batched round of :func:`llama_prefill_chunk_batch` with one job."""
    return llama_prefill_chunk_batch(
        params, tokens[None], cfg, cache, [offset], [slot], [length],
        hist_bucket=hist_bucket, w8a8=w8a8, tp=tp)[0]


IndexLike = Union[torch.Tensor, Sequence[int]]


@torch.no_grad()
def llama_prefill_chunk_batch(
    params: Params,
    tokens: torch.Tensor,       # (J, C) int — one (padded) chunk from each of J slots
    cfg: LlamaConfig,
    cache: KVCache,             # updated in place
    offsets: IndexLike,         # (J,) chunk start positions
    slots: IndexLike,           # (J,) target cache lanes
    lengths: IndexLike,         # (J,) real tokens in each chunk
    *,
    hist_bucket: int,           # attention reads cache[:hist_bucket]
    w8a8: bool = False,
    tp=None,
) -> torch.Tensor:
    """One prompt chunk from EACH of J slots in one pass: the projections
    and MLP run on ``(J * C, D)`` rows, and each chunk attends only to its
    own slot's history (``ops/prefill_attention.py``), so the result equals
    J sequential single-chunk calls.  Returns the fp32 logits
    ``(J, padded_vocab)`` of each chunk's last real position.

    Offsets, slots and lengths are ``(J,)`` int32 tensors on the cache's
    device, as in JAX, or sequences of ints (made into such tensors).  Every
    index is device arithmetic, with no host read-back, so the engine
    captures a round as a CUDA graph and replays it for any jobs: the
    cache writes are indexed copies over a flattened ``(B*S)`` view of the
    layer, the last real positions a gather.  A chunk must lie inside the
    cache (``offset + C <= S``, asserted where the offsets are host values);
    the engine's chunk plans keep it inside its history bucket too."""
    J, C = tokens.shape
    tp = as_tp(tp)
    cfg = tp.local_cfg(cfg)
    KV, HD = cfg.num_kv_heads, cfg.head_dim
    quant = kv_cache_is_quantized(cache)
    S = cache["k"].shape[2 if quant else 3]
    dev = tokens.device
    if not isinstance(offsets, torch.Tensor):
        assert all(0 <= o and o + C <= S for o in offsets), f"chunks {offsets} + {C} past {S}"
    offsets, slots, lengths = (torch.as_tensor(t, dtype=torch.int32, device=dev)
                               for t in (offsets, slots, lengths))
    inv_freqs = rope_inv_freqs(cfg, dev)
    steps = torch.arange(C, dtype=torch.int32, device=dev)
    positions = offsets[:, None] + steps[None, :]  # (J, C)
    # rows of the layer's flattened cache each chunk position writes
    lane_pos = (slots.long()[:, None] * S + positions.long()).reshape(J * C)
    if not quant:  # head-major (B, KV, S, HD): one row per kv head
        heads = torch.arange(KV, device=dev)
        lane_pos = (slots.long()[:, None, None] * KV + heads[None, :, None]) * S \
            + positions.long()[:, None, :]  # (J, KV, C)
        lane_pos = lane_pos.reshape(J * KV * C)
    x = tp.embed(params["embed"], tokens, params["ln_f"].dtype)  # (J, C, D)
    mm = matmul_w8a8 if w8a8 else matmul_maybe_quant
    # row-split inputs take their per-token int8 scale over the whole row
    mm_row = (lambda h, w: matmul_w8a8(h, w, amax=tp.amax)) if w8a8 else matmul_maybe_quant
    lp = params["layers"]
    for i in range(cfg.num_layers):
        wl = _layer(lp, i)
        h = rmsnorm(x, wl["ln1"], cfg.rms_eps)
        q, k, v = _project_qkv(tp.enter(h), wl, cfg, mm)  # (J, C, H/KV, HD)
        q = apply_rope(q, positions, inv_freqs)
        k = apply_rope(k, positions, inv_freqs)
        layer = {name: t[i] for name, t in cache.items()}
        if quant:
            kq, ksc = quantize_kv(k)  # (J, C, KV, HD), (J, C, KV)
            vq, vsc = quantize_kv(v)
            rows = {"k": kq.reshape(J * C, KV * HD), "v": vq.reshape(J * C, KV * HD),
                    "scale": torch.cat([ksc, vsc], dim=-1).reshape(J * C, 2 * KV)}
        else:
            rows = {"k": k.transpose(1, 2).reshape(J * KV * C, HD),
                    "v": v.transpose(1, 2).reshape(J * KV * C, HD)}
        for name, val in rows.items():
            t = layer[name]
            t.view(-1, t.shape[-1]).index_copy_(0, lane_pos, val.to(t.dtype))
        attn = prefill_chunk_attention(q.contiguous(), layer, slots, offsets, hist_bucket)
        attn = attn.to(x.dtype)
        x = x + tp.reduce(mm_row(attn, wl["wo"]))
        h = rmsnorm(x, wl["ln2"], cfg.rms_eps)
        x = x + tp.reduce(_mlp(tp.enter(h), wl, cfg, mm, mm_row))
    # each chunk's last real position (-1, an empty chunk, is its last, as in JAX)
    last = torch.remainder(lengths.long() - 1, C)
    x_last = x.gather(1, last[:, None, None].expand(J, 1, x.shape[-1]))[:, 0]  # (J, D)
    return tp.gather_vocab(lm_head_logits(params, rmsnorm(x_last, params["ln_f"], cfg.rms_eps),
                                          tp))


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
    tp=None,                # tensor parallelism (module docstring)
) -> torch.Tensor:
    """One decode step for every slot: writes each token's K/V at
    ``lengths[b]`` and attends positions ``<= lengths[b]``.  Returns fp32
    logits ``(B, padded_vocab)``.

    Three attention branches, as in the JAX step: ``kernel`` (the slot
    int8 kernel on an int8 cache, the layered kernel on a bf16 one), dense
    int8 (int8 q.k and requantised probs, exact integer dots), dense bf16.
    """
    B = tokens.shape[0]
    tp = as_tp(tp)
    cfg = tp.local_cfg(cfg)
    quant = kv_cache_is_quantized(cache)
    S = cache["k"].shape[2 if quant else 3]
    KV, HD = cfg.num_kv_heads, cfg.head_dim
    DKV, G = KV * HD, cfg.num_heads // KV
    bkt = min(bucket or S, S)
    dev = tokens.device
    inv_freqs = rope_inv_freqs(cfg, dev)
    x = tp.embed(params["embed"], tokens[:, None], params["ln_f"].dtype)  # (B, 1, D)
    positions = lengths[:, None]
    pos_l = lengths.long()
    slots = torch.arange(B, device=dev)
    key_mask = torch.arange(bkt, device=dev)[None, :] <= lengths[:, None]  # (B, bkt)
    live = lengths + 1  # positions each kernel attends, the new token's included
    lp = params["layers"]
    for i in range(cfg.num_layers):
        wl = _layer(lp, i)
        h = rmsnorm(x, wl["ln1"], cfg.rms_eps)
        q, k, v = _project_qkv(tp.enter(h), wl, cfg)
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
            qsc = int8_q_scale(qg)  # (B, KV, G)
            q8 = torch.clamp(torch.round(qg / qsc[..., None]), -127, 127)
            s32 = _int_dot(q8, k_s, "bkgd,bskd->bkgs")
            scores = s32.float() * qsc[..., None] * ks_s[:, :, None, :] * (HD**-0.5)
            scores = torch.where(key_mask[:, None, None, :], scores, torch.full_like(scores, -1e30))
            probs = torch.softmax(scores, dim=-1)
            pv = probs * vs_s[:, :, None, :]
            psc = int8_p_scale(pv)
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
        x = x + tp.reduce(matmul_maybe_quant(attn, wl["wo"]))
        h = rmsnorm(x, wl["ln2"], cfg.rms_eps)
        x = x + tp.reduce(_mlp(tp.enter(h), wl, cfg))
    x = rmsnorm(x[:, 0], params["ln_f"], cfg.rms_eps)
    logits = tp.gather_vocab(lm_head_logits(params, x, tp))
    if active is not None:
        logits = torch.where(active[:, None], logits, torch.zeros_like(logits))
    return logits


# ---------------------------------------------- full-sequence forward (training)

NEG = -1e30


def _per_layer(tree) -> List:
    """Per-layer views of a stacked ``(L, ...)`` tree, dict nesting kept
    (int8 ``{"q", "scale"}`` leaves and LoRA ``{"a", "b"}`` pairs too).

    ``unbind`` (or ``squeeze`` for a one-layer group), not indexing: the
    backward of ``w[i]`` writes a zero-filled copy of the whole stack for
    every layer (28 x 5.6 GB of traffic at 3B), where these give one
    stacked gradient, or none to copy for a one-layer group."""
    if isinstance(tree, dict):
        parts = {k: _per_layer(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return [tree.squeeze(0)] if tree.shape[0] == 1 else list(tree.unbind(0))


def _layer_list(lp) -> List[Dict]:
    """Per-layer weights from the canonical stacked dict or from the
    grouped layout (a list of ``(L/groups, ...)`` dicts)."""
    groups = lp if isinstance(lp, (list, tuple)) else [lp]
    return [wl for g in groups for wl in _per_layer(g)]


def _attn_full(q, k, v, mask, cfg: LlamaConfig) -> torch.Tensor:
    """Dense causal GQA attention: ``(B, S, H, HD)`` queries over
    ``(B, S, KV, HD)`` keys and values, ``mask`` (B, S, S) True = visible;
    fp32 scores, the -1e30 fill, probabilities rounded to V's dtype."""
    KV, HD = cfg.num_kv_heads, cfg.head_dim
    B, S = q.shape[:2]
    qg = q.reshape(B, S, KV, cfg.num_heads // KV, HD)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * HD**-0.5
    scores = scores.masked_fill(~mask[:, None, None], NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, S, cfg.num_heads * HD).to(q.dtype)


def _proj(h, wl, ll, name: str, lora_scale: float) -> torch.Tensor:
    """``h @ W`` plus the low-rank delta ``scale * (h @ A) @ B``: the
    adapters' dtype sets the delta's (JAX promotes bf16 ``h`` against fp32
    adapters), which is then rounded to the output's."""
    y = matmul_maybe_quant(h, wl[name])
    if ll is not None and name in ll:
        a, b = ll[name]["a"], ll[name]["b"]
        y = y + lora_scale * ((h.to(a.dtype) @ a) @ b).to(y.dtype)
    return y


def _train_layer(x, wl, ll, positions, inv_freqs, attn_mask, mask, cfg: LlamaConfig,
                 attn_impl: str, lora_scale: float, tp=None, gather_layer=None):
    """One decoder layer of the full-sequence forward: ``(x, k, v)``.
    ``gather_layer`` turns a rank's ZeRO-3 shards of the layer's weights
    into the weights it computes with (inside a recomputed layer, so they
    are gathered again in the backward and not kept)."""
    from ..ops.blockwise_attention import blockwise_causal_attention

    tp = as_tp(tp)
    if gather_layer is not None:
        wl = gather_layer(wl)
    cfg = tp.local_cfg(cfg)
    B, S = x.shape[:2]
    H, KV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = tp.enter(rmsnorm(x, wl["ln1"], cfg.rms_eps))
    if ll is None:
        q, k, v = _project_qkv(h, wl, cfg)  # fused-aware
    else:
        q = _split_heads(_proj(h, wl, ll, "wq", lora_scale), H, HD)
        k = _split_heads(_proj(h, wl, ll, "wk", lora_scale), KV, HD)
        v = _split_heads(_proj(h, wl, ll, "wv", lora_scale), KV, HD)
    q = apply_rope(q, positions, inv_freqs)
    k = apply_rope(k, positions, inv_freqs)
    if attn_impl == "blockwise":
        attn = blockwise_causal_attention(q, k, v, attn_mask).reshape(B, S, H * HD)
    else:
        attn = _attn_full(q, k, v, mask, cfg)
    x = x + tp.reduce(_proj(attn, wl, ll, "wo", lora_scale))
    h = tp.enter(rmsnorm(x, wl["ln2"], cfg.rms_eps))
    if ll is None:
        return x + tp.reduce(_mlp(h, wl, cfg)), k, v
    act = F.silu(_proj(h, wl, ll, "wg", lora_scale)) * _proj(h, wl, ll, "wu", lora_scale)
    return x + _proj(act, wl, ll, "wd", lora_scale), k, v


@torch.no_grad()
def _write_cache(cache: KVCache, ks, vs, offsets, lanes) -> KVCache:
    """Write ``(L, B, S, KV, HD)`` keys and values into ``cache`` in place,
    row ``b`` at lane ``lanes[b]`` from position ``offsets[b]``.  One row
    is written whole, its start clamped into the cache (as JAX's
    ``dynamic_update_slice``); several rows drop positions past the end
    (as JAX's scatter)."""
    quant = kv_cache_is_quantized(cache)
    L, B, S = ks.shape[:3]
    Smax = cache["k"].shape[2 if quant else 3]
    if quant:
        kq, ksc = quantize_kv(ks)
        vq, vsc = quantize_kv(vs)
        vals = {"k": kq.reshape(L, B, S, -1), "v": vq.reshape(L, B, S, -1),
                "scale": torch.cat([ksc, vsc], dim=-1)}
    else:
        vals = {"k": ks.transpose(2, 3), "v": vs.transpose(2, 3)}  # (L, B, KV, S, HD)
    for b, (lane, off) in enumerate(zip(lanes.tolist(), offsets.tolist())):
        n = S
        if B == 1:
            off = min(max(off, 0), Smax - S)
        else:
            n = max(0, min(S, Smax - off))
        for name, val in vals.items():
            if quant:
                cache[name][:, lane, off:off + n] = val[:, b, :n]
            else:
                cache[name][:, lane, :, off:off + n] = val[:, b, :, :n].to(cache[name].dtype)
    return cache


def llama_forward(
    params: Params,
    tokens: torch.Tensor,                         # (B, S) int
    cfg: LlamaConfig,
    *,
    positions: Optional[torch.Tensor] = None,     # (B, S); default arange
    attn_mask: Optional[torch.Tensor] = None,     # (B, S) bool, True = real token
    cache: Optional[KVCache] = None,              # written in place
    cache_offset: Optional[torch.Tensor] = None,  # (B,) write offsets
    cache_slots: Optional[torch.Tensor] = None,   # (B,) cache lanes to write
    lora: Optional[Params] = None,                # adapters (training/lora.py)
    lora_scale: float = 1.0,
    attn_impl: str = "dense",                     # "dense" | "blockwise"
    remat: bool = False,                          # recompute each layer in the backward
    return_hidden: bool = False,                  # (B, S, D) normed hidden, no lm head
    scan_layers: bool = True,
    accum_stack_grads: bool = False,
    tp=None,                                      # tensor parallelism (module docstring)
    gather_layer=None,                            # a layer's ZeRO-3 shards -> its weights
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full-sequence forward (training, and prefill into a cache).

    Returns fp32 logits ``(B, S, padded_vocab)`` (or, with
    ``return_hidden``, the final normed hidden states for a chunked lm
    head) and, with ``cache``, the cache holding this sequence's K/V.

    ``params["layers"]`` is the canonical stacked dict or the grouped
    layout of ``model.bridge.group_layer_params`` (the trainer keeps one
    group per layer, so each layer's weights are leaves of their own).
    ``remat`` runs each layer under a non-reentrant
    ``torch.utils.checkpoint``: only layer inputs stay live for the
    backward.  Two options of the JAX function exist there for XLA and
    keep their contract here:

    - ``scan_layers=False`` unrolled the layer loop, because a
      ``lax.scan`` backward double-buffers its stacked gradient outputs;
      here the loop is always a Python loop, so it changes nothing;
    - ``accum_stack_grads`` carried the stacked gradient through a reverse
      scan (one gradient copy, each layer recomputed); here it is the
      per-layer recompute over the unbound leaves (``remat``), and, as in
      JAX, takes neither LoRA, a cache nor the grouped layout.

    Sharded training (``training/pretrain.py`` on a mesh) passes ``tp``
    and ``gather_layer`` with the embedding, final norm and head already
    gathered; the logits are then this rank's vocab columns.
    """
    B, S = tokens.shape
    dev = tokens.device
    grouped = isinstance(params["layers"], (list, tuple))
    if accum_stack_grads and (lora is not None or cache is not None or grouped):
        raise ValueError("accum_stack_grads is a training path over the canonical stacked "
                         "layout, without LoRA or a cache")
    if grouped and (lora is not None or cache is not None):
        raise ValueError("the grouped layer layout is a training path without LoRA or a cache")
    remat = remat or accum_stack_grads
    tp = as_tp(tp)
    if lora is not None and tp.size > 1:
        raise ValueError("LoRA adapters are not split for tensor parallelism")
    if positions is None:
        positions = torch.arange(S, device=dev).expand(B, S)
    if attn_mask is None:
        attn_mask = torch.ones((B, S), dtype=torch.bool, device=dev)
    attn_mask = attn_mask.bool()
    mask = None
    if attn_impl != "blockwise":  # blockwise derives causality from positions
        causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
        mask = causal[None] & attn_mask[:, None, :]

    inv_freqs = rope_inv_freqs(cfg, dev)
    x = tp.embed(params["embed"], tokens, params["ln_f"].dtype)
    layers = _layer_list(params["layers"])
    adapters = _per_layer(lora["layers"]) if lora is not None else [None] * len(layers)
    ks, vs = [], []
    for wl, ll in zip(layers, adapters):
        args = (x, wl, ll, positions, inv_freqs, attn_mask, mask, cfg, attn_impl, lora_scale,
                tp, gather_layer)
        if remat and torch.is_grad_enabled():
            x, k, v = checkpoint(_train_layer, *args, use_reentrant=False)
        else:
            x, k, v = _train_layer(*args)
        if cache is not None:
            ks.append(k)
            vs.append(v)
    x = rmsnorm(x, params["ln_f"], cfg.rms_eps)
    out = x if return_hidden else lm_head_logits(params, x, tp)
    if cache is None:
        return out, None
    offsets = cache_offset if cache_offset is not None else torch.zeros(B, dtype=torch.int64)
    lanes = cache_slots if cache_slots is not None else torch.arange(B)
    return out, _write_cache(cache, torch.stack(ks), torch.stack(vs), offsets, lanes)


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
