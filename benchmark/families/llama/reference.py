"""Plain reference of the llama family's decoder, in fp32 PyTorch.

A Llama-architecture decoder as the configuration files state it (the
Mistral-7B-v0.3 and SmolLM2-1.7B blocks: RMSNorm, rotary embeddings on
the two halves of each head, grouped-query causal attention, a SwiGLU
MLP, a tied or separate head), computed over a whole sequence at once,
with no cache, no batching and no kernel.

It runs the precisions the configuration states and works out their
numbers itself from the bf16 weights: int8 weights, symmetric per output
column (the embedding per row), dequantized exactly into fp32; on prompt
positions the projections take per-token int8 activations (``w8a8``);
every sum and the attention are fp32 (the caller turns TF32 off).
``weight_bits=4`` is the control: the same with int4 weights.  Imports
nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE division by a constant (a tensor divisor: CUDA multiplies by
    the reciprocal of a Python number)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize(w: torch.Tensor, bits: int, dim: int):
    """Symmetric integer codes of ``w`` over ``dim``: (codes as fp32,
    fp32 scales with ``dim`` kept)."""
    qmax = 2 ** (bits - 1) - 1
    wf = w.float()
    scale = torch.clamp(_div(wf.abs().amax(dim=dim, keepdim=True), qmax), min=1e-12)
    return torch.clamp(torch.round(wf / scale), -qmax, qmax), scale


def dequant(w: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    q, s = quantize(w, bits, dim)
    return q * s


def w8a8(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Per-token int8 rows times integer weight codes, both scales after."""
    hsc = _div(torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8), 127.0)
    x8 = torch.clamp(torch.round(x / hsc), -127, 127)
    return (x8 @ wq) * hsc * ws


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (S, heads, HD) by positions 0..S-1 (halves of each head)."""
    S, _, HD = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, HD, 2, dtype=torch.float32, device=x.device) / HD))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : HD // 2], x[..., HD // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v) -> torch.Tensor:
    """(S, H, HD) queries over (S, KV, HD) keys and values, GQA."""
    S, H, HD = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * HD ** -0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * HD)


@torch.no_grad()
def logits(weights: Dict, d: Dict, seqs: Sequence[Dict], weight_bits: int = 8) -> List:
    """fp32 logits ``(n, Vp)`` of each sequence at its positions ``want``.

    ``seqs``: ``{"ids": all token ids, "prompt": prompt length, "want":
    positions}``; rows ``< prompt`` are prompt positions (w8a8), the rest
    decoded ones.  Runs layer by layer over all sequences, one layer's
    dequantized weights alive at a time."""
    dev = weights["embed"].device
    emb_q, emb_s = quantize(weights["embed"], 8, 1)
    xs = [(emb_q[torch.as_tensor(s["ids"], device=dev)] * emb_s[torch.as_tensor(s["ids"],
                                                                                  device=dev)])
          for s in seqs]
    del emb_q
    L, H, KV, HD = d["L"], d["H"], d["KV"], d["HD"]
    lw = weights["layers"]
    for i in range(L):
        w = {}
        for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
            w[name] = quantize(lw[name][i], weight_bits, 0)
        for j, s in enumerate(seqs):
            P, x = s["prompt"], xs[j]

            def proj(h, name):
                q, sc = w[name]
                return torch.cat([w8a8(h[:P], q, sc), h[P:] @ (q * sc)], dim=0)

            h = rmsnorm(x, lw["ln1"][i], d["eps"])
            S = h.shape[0]
            q = rope(proj(h, "wq").reshape(S, H, HD), d["theta"])
            k = rope(proj(h, "wk").reshape(S, KV, HD), d["theta"])
            v = proj(h, "wv").reshape(S, KV, HD)
            x = x + proj(causal_attention(q, k, v), "wo")
            h = rmsnorm(x, lw["ln2"][i], d["eps"])
            x = x + proj(torch.nn.functional.silu(proj(h, "wg")) * proj(h, "wu"), "wd")
            xs[j] = x
        del w
    head = (dequant(weights["embed"], 8, 1).T if d["tied"]
            else dequant(weights["lm_head"], weight_bits, 0))
    out = []
    for j, s in enumerate(seqs):
        h = rmsnorm(xs[j][torch.as_tensor(s["want"], device=dev)], weights["ln_f"], d["eps"])
        out.append(h @ head)
    return out
