"""Blockwise causal attention for training (port of ops/blockwise_attention.py).

The JAX function is a ``lax.scan`` online softmax over 256 x 256 blocks
under ``jax.checkpoint``, not a Pallas kernel, so no TPU kernel stands
behind it and a library call may take its place on the card:

- a CPU tensor goes to :func:`blockwise_attention_twin`, the same loop in
  plain PyTorch (each query block under a non-reentrant
  ``torch.utils.checkpoint``, so the backward recomputes one block's
  scores at a time);
- a CUDA tensor goes to ``F.scaled_dot_product_attention`` with the
  backend named in ``SDPA_BACKEND`` through ``sdpa_kernel``: if that
  backend cannot run these inputs the call raises, instead of falling back
  to the math backend, which would materialise ``S x S`` fp32 scores per
  head.  The memory-efficient backend takes the boolean causal &
  key-padding mask; K/V are expanded to the query heads (GQA) first.

Both give the JAX function's output on every row, padded rows included.
A query row with no valid key at all (its sequence starts with padding;
``pad_collate`` right-pads, so training never makes one) gets what the
JAX loop gives there: every score is the -1e30 fill, so each visible key
block weighs 1 and the row is the mean of V over the key blocks its query
block visits.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30

# the SDPA backend used on the card (a member name of
# torch.nn.attention.SDPBackend): the one that takes an arbitrary mask
SDPA_BACKEND = "EFFICIENT_ATTENTION"


def _block_sizes(S: int, block_q: int, block_k: int):
    block_q, block_k = min(block_q, S), min(block_k, S)
    if S % block_q or S % block_k:
        raise ValueError(f"seq len {S} must be divisible by blocks {block_q}/{block_k}")
    return block_q, block_k


def _visible_blocks(qi: int, block_q: int, block_k: int, nk: int) -> int:
    """Key blocks the JAX loop visits for query block ``qi``."""
    return min(qi * block_q // block_k + -(-block_q // block_k), nk)


def _query_block(qb, k, v, attn_mask, q0: int, n_vis: int, block_k: int):
    """One query block's online softmax over its visible key blocks:
    ``qb`` (B, bq, KV, G, HD) fp32-scaled -> (B, bq, KV, G, HD) fp32."""
    B, bq, KV, G, HD = qb.shape
    dev = qb.device
    q_pos = torch.arange(q0, q0 + bq, device=dev)
    m = torch.full((B, KV, G, bq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, bq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, bq, HD), dtype=torch.float32, device=dev)
    for j in range(n_vis):
        sl = slice(j * block_k, (j + 1) * block_k)
        kb, vb = k[:, sl], v[:, sl]
        s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb.float())
        k_pos = torch.arange(sl.start, sl.stop, device=dev)
        valid = (q_pos[:, None] >= k_pos[None, :])[None, None, None] \
            & attn_mask[:, sl][:, None, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)


def blockwise_attention_twin(q, k, v, attn_mask=None, *, block_q: int = 256,
                             block_k: int = 256) -> torch.Tensor:
    """The JAX loop in plain PyTorch, on any device: ``(B, S, H, HD)``
    queries, ``(B, S, KV, HD)`` keys and values -> ``(B, S, H, HD)`` in the
    query dtype.  Queries are scaled in fp32 and meet the keys in fp32;
    probabilities round to V's dtype before the PV product, as in JAX."""
    B, S, H, HD = q.shape
    KV = k.shape[2]
    G = H // KV
    block_q, block_k = _block_sizes(S, block_q, block_k)
    if attn_mask is None:
        attn_mask = torch.ones((B, S), dtype=torch.bool, device=q.device)
    nk = S // block_k
    qs = q.reshape(B, S, KV, G, HD).float() * HD**-0.5
    outs = []
    for qi in range(S // block_q):
        q0 = qi * block_q
        n_vis = _visible_blocks(qi, block_q, block_k, nk)
        qb = qs[:, q0:q0 + block_q]
        if torch.is_grad_enabled() and (qb.requires_grad or k.requires_grad or v.requires_grad):
            o = checkpoint(_query_block, qb, k, v, attn_mask, q0, n_vis, block_k,
                           use_reentrant=False)
        else:
            o = _query_block(qb, k, v, attn_mask, q0, n_vis, block_k)
        outs.append(o)
    return torch.cat(outs, dim=1).reshape(B, S, H, HD).to(q.dtype)


def _no_key_rows(v, attn_mask, block_q: int, block_k: int):
    """(rows with no valid key (B, S), their output (B, S, KV, HD) fp32):
    the mean of V over the key blocks each row's query block visits."""
    B, S, KV, HD = v.shape
    nk = S // block_k
    no_key = torch.cumsum(attn_mask.int(), dim=1) == 0
    qi = torch.arange(S // block_q, device=v.device)  # _visible_blocks, on the device
    n_vis = torch.clamp(qi * block_q // block_k + -(-block_q // block_k), max=nk)
    # per-block sums, then a running sum over the few blocks: a cumsum over
    # all S positions runs S dependent steps per lane on the card
    blocks = v.float().reshape(B, nk, block_k, KV, HD).sum(dim=2).cumsum(dim=1)
    mean = blocks[:, n_vis - 1] / (n_vis * block_k)[None, :, None, None]
    return no_key, mean.repeat_interleave(block_q, dim=1)


def sdpa_attention(q, k, v, attn_mask=None, *, block_q: int = 256, block_k: int = 256,
                   backend: Optional[str] = None) -> torch.Tensor:
    """The card's path: ``F.scaled_dot_product_attention`` under
    ``sdpa_kernel(backend)`` (``SDPA_BACKEND`` by default), with a boolean
    causal & key-padding mask and K/V expanded to the query heads.  Rows
    without a valid key get the JAX loop's output (module docstring);
    their mask keeps key 0 so the backend never sees an empty row."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, S, H, HD = q.shape
    KV = k.shape[2]
    G = H // KV
    block_q, block_k = _block_sizes(S, block_q, block_k)
    if attn_mask is None:
        attn_mask = torch.ones((B, S), dtype=torch.bool, device=q.device)
    no_key, fill = _no_key_rows(v, attn_mask, block_q, block_k)
    pos = torch.arange(S, device=q.device)
    mask = (pos[:, None] >= pos[None, :])[None] & attn_mask[:, None, :]
    mask = mask | (no_key[:, :, None] & (pos == 0)[None, None, :])
    kx = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vx = v.repeat_interleave(G, dim=2).transpose(1, 2)
    with sdpa_kernel([getattr(SDPBackend, backend or SDPA_BACKEND)]):
        out = F.scaled_dot_product_attention(q.transpose(1, 2), kx, vx, attn_mask=mask[:, None])
    out = out.transpose(1, 2)
    fill = fill.repeat_interleave(G, dim=2).to(out.dtype)
    return torch.where(no_key[:, :, None, None], fill, out)


def blockwise_causal_attention(q, k, v, attn_mask=None, *, block_q: int = 256,
                               block_k: int = 256) -> torch.Tensor:
    """Causal GQA attention without an ``S x S`` score tensor in memory:
    ``(B, S, H, HD)`` queries, ``(B, S, KV, HD)`` keys and values, a
    ``(B, S)`` padding mask (True = real token) -> ``(B, S, H, HD)`` in the
    query dtype.  The sequence length must divide by the block sizes
    (clamped to it).  CPU tensors run the plain twin, CUDA tensors SDPA."""
    if q.is_cuda:
        return sdpa_attention(q, k, v, attn_mask, block_q=block_q, block_k=block_k)
    return blockwise_attention_twin(q, k, v, attn_mask, block_q=block_q, block_k=block_k)
