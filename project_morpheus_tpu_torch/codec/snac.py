"""SNAC codec on ``(B, T, C)`` tensors (port of codec/snac_jax.py).

Same formulation as the JAX package: weight-norm folded at load time
(``weights.py``), convs as shifted-slice matmuls, the even-stride
transposed convs as four matmuls over phase-stacked weight banks, and the
noise blocks zeroed for deterministic serving.  The encoder
(:func:`snac_encode`) turns audio back into codes for training-data
preparation.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

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


# ------------------------------------------------------------------- encoder


def _encoder_block(x: torch.Tensor, p: Params, *, stride: int, groups: int) -> torch.Tensor:
    for j, dil in enumerate((1, 3, 9)):
        x = _residual_unit(x, p[f"res{j + 1}"], dilation=dil, groups=groups)
    x = snake(x, p["alpha_down"])
    return conv1d(x, p["down_w"], p["down_b"], stride=stride, padding=math.ceil(stride / 2))


def rvq_encode(params: Params, z: torch.Tensor, cfg: SNACConfig
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Residual quantization of the latent ``z`` (B, T, latent): per level,
    average-pool by its stride, project to the codebook space and take the
    entry of largest cosine similarity.  Returns the int32 codes of each
    level and, beside them, each position's margin: the best cosine less
    the second best (where two devices' roundings may choose differently)."""
    codes, margins = [], []
    residual = z
    for level, stride in enumerate(cfg.vq_strides):
        q = params["quantizer"][level]
        x = residual
        if stride > 1:
            t = (x.shape[1] // stride) * stride
            x = x[:, :t].reshape(x.shape[0], t // stride, stride, x.shape[2]).mean(dim=2)
        zp = conv1d(x, q["in_w"], q["in_b"])  # latent -> codebook dim
        zn = zp / (torch.linalg.vector_norm(zp, dim=-1, keepdim=True) + 1e-8)
        cb = q["codebook"]
        cbn = cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True) + 1e-8)
        cos = zn @ cbn.T  # (B, Tl, codebook_size)
        idx = cos.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
        top2 = torch.topk(cos, 2, dim=-1).values
        codes.append(idx.to(torch.int32))
        margins.append(top2[..., 0] - top2[..., 1])
        zq = conv1d(cb[idx], q["out_w"], q["out_b"])
        if stride > 1:
            zq = torch.repeat_interleave(zq, stride, dim=1)
        residual = residual - zq
    return codes, margins


@torch.no_grad()
def encode_latent(params: Params, audio: torch.Tensor, cfg: SNACConfig) -> torch.Tensor:
    """The encoder's conv stack: waveform ``(B, T)`` -> latent
    ``(B, T / hop, latent)``."""
    enc = params["encoder"]
    x = conv1d(audio[..., None], enc["in_w"], enc["in_b"], padding=3)
    d = cfg.encoder_dim
    for i, rate in enumerate(cfg.encoder_rates):
        d *= 2
        x = _encoder_block(x, enc["blocks"][i], stride=rate,
                           groups=(d // 2) if cfg.depthwise else 1)
    return conv1d(x, enc["out_w"], enc["out_b"], padding=3, groups=d if cfg.depthwise else 1)


@torch.no_grad()
def snac_encode(params: Params, audio: torch.Tensor, cfg: SNACConfig) -> Tuple[torch.Tensor, ...]:
    """Encode a waveform ``(B, T)`` into one int32 code tensor per codebook
    level (the inverse of :func:`snac_decode`); ``T`` must be a whole
    number of ``hop_length * vq_strides[0]`` samples, as in JAX."""
    return tuple(rvq_encode(params, encode_latent(params, audio, cfg), cfg)[0])
