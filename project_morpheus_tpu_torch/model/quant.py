"""Int8 weight-only quantization for serving (port of model/quant.py).

A quantized weight is the dict leaf ``{"q": int8 (in, out), "scale": f32
(out,)}``; ``matmul_maybe_quant`` dispatches on the leaf so the same forward
code serves both representations.  Where XLA fuses the weight-only dequant
into the dot for the JAX package, activations of at most
``int8_gemv.MAX_ROWS`` rows on the card (the whole decode step and the
prefill's last-position logits) go to the hand-written int8 GEMV
(``ops/int8_gemv.py``); other weight-only products are a plain library
matmul (dequant into the activation dtype, :func:`dequant_matmul`, the
GEMV's plain twin).  The int8 x int8 (w8a8) chunk prefill runs the
hand-written per-token quantize and int8 GEMM (``ops/w8a8_gemm.py``) on
the card, from a K-major copy ``"qt": int8 (out, in)`` of each weight
that :func:`add_k_major_copies` adds there; the CPU computes the same
bits from ``"q"``.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from ..ops.int8_gemv import MAX_ROWS, int8_gemv
from ..ops.w8a8_gemm import quantize_rows, w8a8_gemm

QLeaf = Dict[str, torch.Tensor]
Weight = Union[torch.Tensor, QLeaf]

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "wqkv", "wgu")


def is_quantized(w: Weight) -> bool:
    return isinstance(w, dict) and "q" in w


_C127: Dict[torch.device, torch.Tensor] = {}


def div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as an IEEE division on every device, as the CPU and the
    JAX package run op by op compute it: PyTorch's CUDA division by a Python
    number multiplies by its reciprocal, which moves some quotients by an
    ulp.  The divisor is a tensor on ``x``'s device, made once outside any
    graph capture and kept (a capture that finds none makes its own with a
    fill kernel: never a copy from the host)."""
    c = _C127.get(x.device)
    if c is None:
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            return x / x.new_full((), 127.0)
        with torch.inference_mode(False):
            c = torch.full((), 127.0, dtype=torch.float32, device=x.device)
        _C127[x.device] = c
    return x / c


def _quant_2d(w: torch.Tensor) -> QLeaf:
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(div127(amax), min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale[0]}


def _quant_rows(part: torch.Tensor):
    """Per-row int8 of an embedding chunk: (int8 rows, fp32 scales)."""
    part = part.float()
    amax = part.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(div127(amax), min=1e-12)
    return torch.clamp(torch.round(part / scale), -127, 127).to(torch.int8), scale[:, 0]


def quantize_weight(w: torch.Tensor, axis: int = -2) -> QLeaf:
    """Symmetric per-output-channel int8 over the contraction axis (the
    second last, the only one taken); stacked (layers, in, out) weights
    quantize one layer slice at a time."""
    if axis not in (-2, w.ndim - 2):
        raise ValueError(f"quantize_weight reduces over axis -2, not {axis}")
    if w.ndim == 3:
        parts = [_quant_2d(w[i]) for i in range(w.shape[0])]
        return {
            "q": torch.stack([p["q"] for p in parts]),
            "scale": torch.stack([p["scale"] for p in parts]),
        }
    return _quant_2d(w)


def dequantize_weight(leaf: QLeaf, dtype=torch.bfloat16, axis: int = -2) -> torch.Tensor:
    """``q * scale`` in fp32, cast to ``dtype``; 2-D or stacked leaves (a
    K-major copy ``"qt"`` is not read)."""
    return (leaf["q"].float() * leaf["scale"].unsqueeze(axis)).to(dtype)


def _gemv_rows(h: torch.Tensor) -> bool:
    """Whether ``h`` goes to the int8 GEMV kernel: on the card, at most
    ``MAX_ROWS`` rows (the kernel raises on an activation that is not
    bf16)."""
    return h.is_cuda and h.numel() <= MAX_ROWS * h.shape[-1]


def dequant_matmul(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(h @ q) * scale`` by a cast of the int8 weight to ``h.dtype``."""
    y = h @ q.to(h.dtype)
    return y * scale.to(y.dtype)


def dequant_matmul_t(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x @ q.T) * scale`` in fp32 by a cast of the int8 table."""
    y = x @ q.T.to(x.dtype)
    return y.float() * scale


def matmul_maybe_quant(h: torch.Tensor, w: Weight) -> torch.Tensor:
    """``h @ w`` for plain and int8 leaves (weight-only dequant)."""
    if not is_quantized(w):
        return h @ w
    if _gemv_rows(h):
        return int8_gemv(h, w["q"], w["scale"])
    return dequant_matmul(h, w["q"], w["scale"])


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of 2-D int8 matrices: a float64 product, exact
    for these sums (< 2**53) on the CPU and on the card (the w8a8 GEMM's
    plain version)."""
    return (a.double() @ b.double()).to(torch.int32)


def matmul_w8a8(h: torch.Tensor, w: Weight, amax=None) -> torch.Tensor:
    """``h @ w`` with per-token int8 activations and an int8 x int8 product
    (the chunk-prefill projections); plain weights use the dtype matmul.
    ``amax`` maps the per-token absolute maxima of ``h`` to those of the
    whole row (a tensor-parallel rank holds part of a row-split input).
    On the card the leaf must hold its K-major copy (:func:`add_k_major_copies`)."""
    if not is_quantized(w):
        return h @ w
    qt = w.get("qt")
    if qt is None:
        if h.is_cuda:
            raise ValueError("a w8a8 product on the card needs the weight's K-major copy "
                             "'qt': call add_k_major_copies on the params first")
        qt = w["q"].T
    h8, hsc = quantize_rows(h, amax)
    return w8a8_gemm(h8, hsc, qt, w["scale"], h.dtype)


def add_k_major_copies(params: Dict) -> Dict:
    """``params`` with a K-major copy ``"qt"`` (..., out, in), contiguous,
    beside ``"q"`` in each int8 layer leaf on the card, for the w8a8 GEMM
    (8-bit wgmma reads both operands K-major).  A copy is made on the card,
    once; leaves on the CPU, plain leaves and leaves that have one are
    kept as they are.  The copies are not part of a checkpoint or a shard
    spec: a mesh rank makes them from its own shards."""
    layers = dict(params["layers"])
    for key, w in layers.items():
        if is_quantized(w) and w["q"].is_cuda and "qt" not in w:
            layers[key] = {**w, "qt": w["q"].transpose(-1, -2).contiguous()}
    out = dict(params)
    out["layers"] = layers
    return out


def quantize_params_int8(params: Dict) -> Dict:
    """Quantize the projection matrices, the embedding (per row, so the
    tied lm_head dequantizes per logit column) and any lm_head."""
    out = dict(params)
    layers = dict(params["layers"])
    for key in _QUANT_KEYS:
        if key in layers and not is_quantized(layers[key]):
            layers[key] = quantize_weight(layers[key])
    out["layers"] = layers
    embed = params["embed"]
    chunks, scales = [], []
    n = embed.shape[0]
    step = max(1, n // 8)
    for lo in range(0, n, step):
        q, scale = _quant_rows(embed[lo : lo + step])
        chunks.append(q)
        scales.append(scale)
    out["embed"] = {"q": torch.cat(chunks), "scale": torch.cat(scales)}
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def _concat_weights(leaves):
    if is_quantized(leaves[0]):
        return {
            "q": torch.cat([l["q"] for l in leaves], dim=-1),
            "scale": torch.cat([l["scale"] for l in leaves], dim=-1),
        }
    return torch.cat(leaves, dim=-1)


def fuse_layer_weights(params: Dict) -> Dict:
    """Serving-time projection fusion: wq|wk|wv -> wqkv, wg|wu -> wgu
    (bit-identical: int8 scales are per output column).  Idempotent."""
    layers = dict(params["layers"])
    if "wqkv" not in layers:
        layers["wqkv"] = _concat_weights(
            [layers.pop("wq"), layers.pop("wk"), layers.pop("wv")]
        )
    if "wgu" not in layers:
        layers["wgu"] = _concat_weights([layers.pop("wg"), layers.pop("wu")])
    out = dict(params)
    out["layers"] = layers
    return out


def embed_lookup(embed: Weight, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token embedding lookup for plain or quantized tables."""
    if not is_quantized(embed):
        return embed[tokens]
    rows = embed["q"][tokens].float()
    scales = embed["scale"][tokens][..., None]
    return (rows * scales).to(dtype)


def tied_lm_head_logits(x: torch.Tensor, embed: Weight) -> torch.Tensor:
    """``x @ embed.T`` in fp32 for plain or quantized embedding tables."""
    if not is_quantized(embed):
        return (x @ embed.T).float()
    if _gemv_rows(x):
        return int8_gemv(x, embed["q"], embed["scale"], k_major=True)
    return dequant_matmul_t(x, embed["q"], embed["scale"])
