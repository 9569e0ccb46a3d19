"""SNAC decoder on ``(B, T, C)`` tensors (port of codec/snac_jax.py, decode).

Same formulation as the JAX package: weight-norm folded at load time
(``weights.py``), convs as shifted-slice matmuls, the even-stride
transposed convs as four matmuls over phase-stacked weight banks, and the
noise blocks zeroed for deterministic serving.  The encoder is not ported.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from .snac_config import SNACConfig

Params = Dict[str, object]


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           stride: int = 1, padding: int = 0, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """1-D convolution on ``(B, T, C)`` with kernel ``(k, in/groups, out)``:
    a matmul for k == 1, shifted-slice multiply-adds (depthwise) or
    shifted-slice matmuls (dense) otherwise."""
    k = w.shape[0]
    if k == 1 and stride == 1 and groups == 1:
        y = x @ w[0]
        return y + b if b is not None else y
    T = x.shape[1]
    t_out = (T + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    xp = torch.nn.functional.pad(x, (0, 0, padding, padding)) if padding else x
    depthwise = groups == x.shape[2] and w.shape[1] == 1
    if not depthwise and groups != 1:
        raise NotImplementedError("only depthwise or dense convs are used by SNAC")
    y = None
    for kk in range(k):
        start = kk * dilation
        sl = xp[:, start:start + (t_out - 1) * stride + 1]
        if stride > 1:
            sl = sl[:, ::stride]
        contrib = sl * w[kk, 0][None, None, :] if depthwise else sl @ w[kk]
        y = contrib if y is None else y + contrib
    return y + b if b is not None else y


def _shift1(x: torch.Tensor, offset: int) -> torch.Tensor:
    """y[t] = x[t + offset] with zero padding out of range."""
    if offset == 0:
        return x
    zeros = x.new_zeros((x.shape[0], abs(offset), x.shape[2]))
    if offset > 0:
        return torch.cat([x[:, offset:], zeros], dim=1)
    return torch.cat([zeros, x[:, :offset]], dim=1)


def phase_banks(w_flipped: torch.Tensor, stride: int):
    """(A0, B0, A1, B1) weight banks of a k = 2s, pad s/2 ConvTranspose1d."""
    s, half = stride, stride // 2
    W = torch.flip(w_flipped, dims=[0])  # W[j] == torch weight[:, :, j]
    A0 = torch.cat([W[(p + half) % s] for p in range(half)], dim=1)
    B0 = torch.cat([W[(p + half) % s + s] for p in range(half)], dim=1)
    A1 = torch.cat([W[(p + half) % s] for p in range(half, s)], dim=1)
    B1 = torch.cat([W[(p + half) % s + s] for p in range(half, s)], dim=1)
    return A0, B0, A1, B1


def phase_combine(x, x_m1, x_p1, banks, stride: int, b=None) -> torch.Tensor:
    """Transposed-conv output from the input and its one-step shifts."""
    B, T, _ = x.shape
    A0, B0, A1, B1 = banks
    half = stride // 2
    c_out = A0.shape[1] // half
    y0 = (x @ A0 + x_m1 @ B0).reshape(B, T, half, c_out)
    y1 = (x_p1 @ A1 + x @ B1).reshape(B, T, stride - half, c_out)
    y = torch.cat([y0, y1], dim=2).reshape(B, T * stride, c_out)
    return y + b if b is not None else y


def conv_transpose1d(x: torch.Tensor, w_flipped: torch.Tensor, b=None, *,
                     stride: int, padding: int) -> torch.Tensor:
    """Torch-semantics ConvTranspose1d for kernel 2*stride, pad stride/2."""
    k = w_flipped.shape[0]
    if k != 2 * stride or padding * 2 != stride or stride < 2:
        raise NotImplementedError("SNAC uses even strides with k = 2s, pad = s/2")
    return phase_combine(x, _shift1(x, -1), _shift1(x, 1),
                         phase_banks(w_flipped, stride), stride, b)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation ``x + sin^2(alpha x) / alpha`` (channelwise alpha)."""
    a = alpha[None, None, :]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def _residual_unit(x, p, *, dilation: int, groups: int):
    pad = ((7 - 1) * dilation) // 2
    y = snake(x, p["alpha1"])
    y = conv1d(y, p["w1"], p["b1"], padding=pad, dilation=dilation, groups=groups)
    y = snake(y, p["alpha2"])
    y = conv1d(y, p["w2"], p["b2"])
    return x + y


def rvq_from_codes(params: Params, codes: Sequence[torch.Tensor], cfg: SNACConfig) -> torch.Tensor:
    """RVQ decode: per-level codebook lookup -> out_proj -> upsample -> sum."""
    z = None
    for level, stride in enumerate(cfg.vq_strides):
        q = params["quantizer"][level]
        emb = q["codebook"][codes[level].long()]  # (B, Tl, cb_dim)
        zl = conv1d(emb, q["out_w"], q["out_b"])
        if stride > 1:
            zl = torch.repeat_interleave(zl, stride, dim=1)
        z = zl if z is None else z + zl
    return z


@torch.no_grad()
def snac_decode(params: Params, codes: Sequence[torch.Tensor], cfg: SNACConfig) -> torch.Tensor:
    """Decode SNAC codes ``(codes0, codes1, codes2)`` (timelines n, 2n, 4n)
    to a waveform ``(B, 4n * hop_length)``, noise zeroed."""
    dec = params["decoder"]
    z = rvq_from_codes(params, codes, cfg)
    if cfg.depthwise:
        x = conv1d(z, dec["in_dw_w"], dec["in_dw_b"], padding=3, groups=cfg.latent)
        x = conv1d(x, dec["in_pw_w"], dec["in_pw_b"])
    else:
        x = conv1d(z, dec["in_w"], dec["in_b"], padding=3)
    for i, rate in enumerate(cfg.decoder_rates):
        blk = dec["blocks"][i]
        out_dim = cfg.decoder_dim // (2 ** (i + 1))
        groups = out_dim if cfg.depthwise else 1
        x = snake(x, blk["alpha_up"])
        x = conv_transpose1d(x, blk["up_w"], blk["up_b"], stride=rate,
                             padding=math.ceil(rate / 2))
        # noise block: identity in deterministic serving
        for j, dil in enumerate((1, 3, 9)):
            x = _residual_unit(x, blk[f"res{j + 1}"], dilation=dil, groups=groups)
    x = snake(x, dec["alpha_out"])
    x = conv1d(x, dec["out_w"], dec["out_b"], padding=3)
    return torch.tanh(x)[..., 0]
