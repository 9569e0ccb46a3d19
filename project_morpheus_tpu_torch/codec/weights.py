"""SNAC parameter initialisation and torch-checkpoint conversion.

A copy of the JAX package's ``codec/weights.py`` (numpy only): the same
seeded random state and conversion, so the port's random SNAC weights are
identical to the JAX runtime's.  The params tree keeps the JAX package's
``(B, T, C)`` conv layout; :func:`to_torch` moves it onto a device.

Layout conversions (torch module state -> ``(B, T, C)`` convs):
- ``Conv1d.weight (out, in/groups, k)``          -> ``(k, in/groups, out)``
- ``ConvTranspose1d.weight (in, out, k)``        -> time-flipped ``(k, in, out)``
  (the phase-decomposed transposed conv of ``snac.py`` reads it)
- Snake ``alpha (1, C, 1)``                      -> ``(C,)``
- weight-norm pairs ``weight_g``/``weight_v`` (or parametrizations.*) are
  folded to an effective ``weight`` first.

Real ``hubertsiuzdak/snac_24khz`` torch checkpoints can be ingested via
:func:`fold_weight_norm` + a key-rename map; no network access is assumed.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from .snac_config import SNACConfig

TorchState = Dict[str, np.ndarray]


# ----------------------------------------------------------- random init


def _conv_w(rng: np.random.Generator, out_ch: int, in_ch: int, k: int) -> np.ndarray:
    # torch Conv1d default: U(-b, b), b = 1/sqrt(in_ch * k)
    bound = 1.0 / math.sqrt(in_ch * k)
    return rng.uniform(-bound, bound, size=(out_ch, in_ch, k)).astype(np.float32)


def _bias(rng: np.random.Generator, out_ch: int, fan_in: int) -> np.ndarray:
    bound = 1.0 / math.sqrt(fan_in)
    return rng.uniform(-bound, bound, size=(out_ch,)).astype(np.float32)


def random_torch_state(cfg: SNACConfig, seed: int = 0) -> TorchState:
    """Random SNAC weights in torch layout (hermetic tests / cold start)."""
    rng = np.random.default_rng(seed)
    s: TorchState = {}
    lat = cfg.latent

    # quantizer levels
    for i, _stride in enumerate(cfg.vq_strides):
        p = f"quantizer.{i}."
        s[p + "codebook.weight"] = rng.normal(
            0, 1.0, size=(cfg.codebook_size, cfg.codebook_dim)
        ).astype(np.float32)
        s[p + "in_proj.weight"] = _conv_w(rng, cfg.codebook_dim, lat, 1)
        s[p + "in_proj.bias"] = _bias(rng, cfg.codebook_dim, lat)
        s[p + "out_proj.weight"] = _conv_w(rng, lat, cfg.codebook_dim, 1)
        s[p + "out_proj.bias"] = _bias(rng, lat, cfg.codebook_dim)

    # decoder
    d = cfg.decoder_dim
    if cfg.depthwise:
        s["decoder.in_dw.weight"] = _conv_w(rng, lat, 1, 7)
        s["decoder.in_dw.bias"] = _bias(rng, lat, 7)
        s["decoder.in_pw.weight"] = _conv_w(rng, d, lat, 1)
        s["decoder.in_pw.bias"] = _bias(rng, d, lat)
    else:
        s["decoder.in.weight"] = _conv_w(rng, d, lat, 7)
        s["decoder.in.bias"] = _bias(rng, d, lat * 7)

    def res_unit(prefix: str, dim: int, groups: int) -> None:
        s[prefix + "alpha1"] = np.ones((1, dim, 1), np.float32)
        s[prefix + "conv1.weight"] = _conv_w(rng, dim, dim // groups, 7)
        s[prefix + "conv1.bias"] = _bias(rng, dim, (dim // groups) * 7)
        s[prefix + "alpha2"] = np.ones((1, dim, 1), np.float32)
        s[prefix + "conv2.weight"] = _conv_w(rng, dim, dim, 1)
        s[prefix + "conv2.bias"] = _bias(rng, dim, dim)

    for i, rate in enumerate(cfg.decoder_rates):
        in_dim = d // (2**i)
        out_dim = d // (2 ** (i + 1))
        groups = out_dim if cfg.depthwise else 1
        p = f"decoder.block{i}."
        s[p + "alpha_up"] = np.ones((1, in_dim, 1), np.float32)
        # ConvTranspose1d weight layout: (in, out, k)
        k = 2 * rate
        bound = 1.0 / math.sqrt(in_dim * k)
        s[p + "up.weight"] = rng.uniform(
            -bound, bound, size=(in_dim, out_dim, k)
        ).astype(np.float32)
        s[p + "up.bias"] = _bias(rng, out_dim, in_dim * k)
        if cfg.noise:
            s[p + "noise.weight"] = _conv_w(rng, out_dim, out_dim, 1)
        for j in range(3):
            res_unit(p + f"res{j + 1}.", out_dim, groups)

    d_last = d // (2 ** len(cfg.decoder_rates))
    s["decoder.alpha_out"] = np.ones((1, d_last, 1), np.float32)
    s["decoder.out.weight"] = _conv_w(rng, 1, d_last, 7)
    s["decoder.out.bias"] = _bias(rng, 1, d_last * 7)

    # encoder
    e = cfg.encoder_dim
    s["encoder.in.weight"] = _conv_w(rng, e, 1, 7)
    s["encoder.in.bias"] = _bias(rng, e, 7)
    for i, rate in enumerate(cfg.encoder_rates):
        in_dim = e * (2**i)
        out_dim = e * (2 ** (i + 1))
        groups = in_dim if cfg.depthwise else 1
        p = f"encoder.block{i}."
        for j in range(3):
            res_unit(p + f"res{j + 1}.", in_dim, groups)
        s[p + "alpha_down"] = np.ones((1, in_dim, 1), np.float32)
        k = 2 * rate
        s[p + "down.weight"] = _conv_w(rng, out_dim, in_dim, k)
        s[p + "down.bias"] = _bias(rng, out_dim, in_dim * k)
    d_final = e * (2 ** len(cfg.encoder_rates))
    groups = d_final if cfg.depthwise else 1
    s["encoder.out.weight"] = _conv_w(rng, d_final, d_final // groups, 7)
    s["encoder.out.bias"] = _bias(rng, d_final, (d_final // groups) * 7)
    return s


# -------------------------------------------------------------- conversion


def fold_weight_norm(state: TorchState) -> TorchState:
    """Fold ``weight_g``/``weight_v`` (or parametrizations.*) into ``weight``.

    torch weight-norm: ``w = g * v / ||v||`` with the norm over all dims but
    dim 0 (Conv1d) / dim 1 (ConvTranspose1d uses dim=0 too in practice via
    `weight_norm` default dim=0).
    """
    out: TorchState = {}
    handled = set()
    for key in list(state):
        if key.endswith("weight_v") or key.endswith("parametrizations.weight.original1"):
            if key.endswith("weight_v"):
                base = key[: -len("weight_v")]
                gkey = base + "weight_g"
            else:
                base = key[: -len("parametrizations.weight.original1")]
                gkey = base + "parametrizations.weight.original0"
            v = state[key]
            g = state[gkey]
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(v**2, axis=axes, keepdims=True))
            out[base + "weight"] = (g * v / np.maximum(norm, 1e-12)).astype(v.dtype)
            handled.update({key, gkey})
    for key, val in state.items():
        if key in handled:
            continue
        out[key] = val
    return out


def _t_conv(w: np.ndarray) -> np.ndarray:
    """torch Conv1d (out, in/g, k) -> (k, in/g, out)."""
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def _t_convT(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose1d (in, out, k) -> time-flipped (k, in, out)."""
    return np.ascontiguousarray(np.flip(w.transpose(2, 0, 1), axis=0))


def _t_alpha(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.reshape(-1))


def params_from_torch_state(state: TorchState, cfg: SNACConfig) -> Dict[str, object]:
    """Build the params tree for ``snac.py`` from a torch state dict (numpy leaves)."""
    state = fold_weight_norm(state)

    def res_unit(prefix: str) -> Dict[str, np.ndarray]:
        return {
            "alpha1": _t_alpha(state[prefix + "alpha1"]),
            "w1": _t_conv(state[prefix + "conv1.weight"]),
            "b1": state[prefix + "conv1.bias"],
            "alpha2": _t_alpha(state[prefix + "alpha2"]),
            "w2": _t_conv(state[prefix + "conv2.weight"]),
            "b2": state[prefix + "conv2.bias"],
        }

    quant: List[Dict[str, np.ndarray]] = []
    for i, _ in enumerate(cfg.vq_strides):
        p = f"quantizer.{i}."
        quant.append(
            {
                "codebook": state[p + "codebook.weight"],
                "in_w": _t_conv(state[p + "in_proj.weight"]),
                "in_b": state[p + "in_proj.bias"],
                "out_w": _t_conv(state[p + "out_proj.weight"]),
                "out_b": state[p + "out_proj.bias"],
            }
        )

    dec: Dict[str, object] = {}
    if cfg.depthwise:
        dec["in_dw_w"] = _t_conv(state["decoder.in_dw.weight"])
        dec["in_dw_b"] = state["decoder.in_dw.bias"]
        dec["in_pw_w"] = _t_conv(state["decoder.in_pw.weight"])
        dec["in_pw_b"] = state["decoder.in_pw.bias"]
    else:
        dec["in_w"] = _t_conv(state["decoder.in.weight"])
        dec["in_b"] = state["decoder.in.bias"]
    blocks = []
    for i, _rate in enumerate(cfg.decoder_rates):
        p = f"decoder.block{i}."
        blk: Dict[str, object] = {
            "alpha_up": _t_alpha(state[p + "alpha_up"]),
            "up_w": _t_convT(state[p + "up.weight"]),
            "up_b": state[p + "up.bias"],
            "res1": res_unit(p + "res1."),
            "res2": res_unit(p + "res2."),
            "res3": res_unit(p + "res3."),
        }
        if cfg.noise:
            blk["noise"] = {"w": _t_conv(state[p + "noise.weight"])}
        blocks.append(blk)
    dec["blocks"] = blocks
    dec["alpha_out"] = _t_alpha(state["decoder.alpha_out"])
    dec["out_w"] = _t_conv(state["decoder.out.weight"])
    dec["out_b"] = state["decoder.out.bias"]

    if "encoder.in.weight" not in state:
        # decode-only checkpoint (serving never encodes)
        return {"quantizer": quant, "decoder": dec, "encoder": None}

    enc: Dict[str, object] = {
        "in_w": _t_conv(state["encoder.in.weight"]),
        "in_b": state["encoder.in.bias"],
    }
    eblocks = []
    for i, _rate in enumerate(cfg.encoder_rates):
        p = f"encoder.block{i}."
        eblocks.append(
            {
                "res1": res_unit(p + "res1."),
                "res2": res_unit(p + "res2."),
                "res3": res_unit(p + "res3."),
                "alpha_down": _t_alpha(state[p + "alpha_down"]),
                "down_w": _t_conv(state[p + "down.weight"]),
                "down_b": state[p + "down.bias"],
            }
        )
    enc["blocks"] = eblocks
    enc["out_w"] = _t_conv(state["encoder.out.weight"])
    enc["out_b"] = state["encoder.out.bias"]

    return {"quantizer": quant, "decoder": dec, "encoder": enc}


def to_torch(tree, device, dtype=None):
    """Numpy params tree -> torch tensors on ``device`` (structure kept)."""
    import torch

    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device, dtype) for v in tree)
    if tree is None:
        return None
    t = torch.as_tensor(np.asarray(tree), device=device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def init_snac_params(cfg: SNACConfig, seed: int = 0, device="cuda") -> Dict[str, object]:
    """Random-initialised params (shape-faithful to `snac_24khz`) on ``device``."""
    return to_torch(params_from_torch_state(random_torch_state(cfg, seed), cfg), device)
