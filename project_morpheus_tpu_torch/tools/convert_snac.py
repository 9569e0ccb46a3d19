#!/usr/bin/env python3
"""Convert a torch SNAC checkpoint into the .npz ``ORPHEUS_SNAC_PATH`` loads
(port of scripts/convert_snac.py).

The reference serving path loads ``hubertsiuzdak/snac_24khz`` torch weights
(Morpheus_Client/tts_engine/speechpipe.py:41-61); the port's runtime loads
a flat .npz of torch-layout arrays instead (``adapters/runtime.py``,
``codec/weights.py`` conventions).  This tool bridges the two:

    python -m project_morpheus_tpu_torch.tools.convert_snac /path/to/snac_24khz -o snac24.npz
    ORPHEUS_SNAC_PATH=snac24.npz python -m project_morpheus_tpu_torch.server.app

Accepts a state-dict file (.pt/.pth/.bin), a safetensors file, or a
checkpoint directory containing either.  Weight-norm parametrisations
(weight_v/weight_g or parametrizations.weight.original0/1) are folded, the
``snac`` package's sequential-module key names are renamed to this repo's
canonical layout, and the result is verified against the keys
``params_from_torch_state`` requires before writing.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..codec.snac_config import SNACConfig
from ..codec.weights import fold_weight_norm, params_from_torch_state
from ..model.hf_weights import read_safetensors


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def load_torch_state(path: str) -> dict:
    """Load a torch state dict from a file or checkpoint directory."""
    p = Path(path).expanduser()
    if p.is_dir():
        for name in ("pytorch_model.bin", "model.safetensors", "model.pt"):
            if (p / name).exists():
                p = p / name
                break
        else:
            raise FileNotFoundError(
                f"no pytorch_model.bin / model.safetensors in {p}"
            )
    if p.suffix == ".safetensors":
        return {k: _to_numpy(v) for k, v in read_safetensors(p).items()}
    obj = torch.load(str(p), map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: _to_numpy(v) for k, v in obj.items()}


def snac_rename_map(cfg: SNACConfig, noise_in_ckpt: bool) -> dict:
    """src (snac package sequential names) -> dst (canonical names).

    Layout per the public snac package (snac/layers.py): the decoder is
    ``decoder.model`` = [dw-conv, pw-conv] (depthwise) + one DecoderBlock
    per rate + [Snake1d, out-conv, Tanh]; each DecoderBlock.block =
    [Snake1d, ConvT, (NoiseBlock,) ResidualUnit x3]; each
    ResidualUnit.block = [Snake1d, conv(d=dilation), Snake1d, conv(1x1)].
    """
    m: dict = {}

    def res_unit(src: str, dst: str) -> None:
        m[src + "block.0.alpha"] = dst + "alpha1"
        m[src + "block.1.weight"] = dst + "conv1.weight"
        m[src + "block.1.bias"] = dst + "conv1.bias"
        m[src + "block.2.alpha"] = dst + "alpha2"
        m[src + "block.3.weight"] = dst + "conv2.weight"
        m[src + "block.3.bias"] = dst + "conv2.bias"

    # quantizer
    for i, _ in enumerate(cfg.vq_strides):
        src = f"quantizer.quantizers.{i}."
        dst = f"quantizer.{i}."
        for leaf in ("codebook.weight", "in_proj.weight", "in_proj.bias",
                     "out_proj.weight", "out_proj.bias"):
            m[src + leaf] = dst + leaf

    # decoder head
    if cfg.depthwise:
        m["decoder.model.0.weight"] = "decoder.in_dw.weight"
        m["decoder.model.0.bias"] = "decoder.in_dw.bias"
        m["decoder.model.1.weight"] = "decoder.in_pw.weight"
        m["decoder.model.1.bias"] = "decoder.in_pw.bias"
        first_block = 2
    else:
        m["decoder.model.0.weight"] = "decoder.in.weight"
        m["decoder.model.0.bias"] = "decoder.in.bias"
        first_block = 1

    for i, _rate in enumerate(cfg.decoder_rates):
        src = f"decoder.model.{first_block + i}.block."
        dst = f"decoder.block{i}."
        m[src + "0.alpha"] = dst + "alpha_up"
        m[src + "1.weight"] = dst + "up.weight"
        m[src + "1.bias"] = dst + "up.bias"
        res_at = 2
        if noise_in_ckpt:
            m[src + "2.linear.weight"] = dst + "noise.weight"
            res_at = 3
        for j in range(3):
            res_unit(src + f"{res_at + j}.", dst + f"res{j + 1}.")

    tail = first_block + len(cfg.decoder_rates)
    m[f"decoder.model.{tail}.alpha"] = "decoder.alpha_out"
    m[f"decoder.model.{tail + 1}.weight"] = "decoder.out.weight"
    m[f"decoder.model.{tail + 1}.bias"] = "decoder.out.bias"

    # encoder (optional at decode time; mapped when present)
    m["encoder.block.0.weight"] = "encoder.in.weight"
    m["encoder.block.0.bias"] = "encoder.in.bias"
    for i, _rate in enumerate(cfg.encoder_rates):
        src = f"encoder.block.{1 + i}.block."
        dst = f"encoder.block{i}."
        for j in range(3):
            res_unit(src + f"{j}.", dst + f"res{j + 1}.")
        m[src + "3.alpha"] = dst + "alpha_down"
        m[src + "4.weight"] = dst + "down.weight"
        m[src + "4.bias"] = dst + "down.bias"
    etail = 1 + len(cfg.encoder_rates)
    m[f"encoder.block.{etail}.weight"] = "encoder.out.weight"
    m[f"encoder.block.{etail}.bias"] = "encoder.out.bias"
    return m


def convert(state: dict, cfg: SNACConfig, strict: bool = True) -> dict:
    """Fold weight norm, rename to canonical layout, verify completeness."""
    state = {k.removeprefix("module."): v for k, v in state.items()}
    state = fold_weight_norm(state)
    if "decoder.in_dw.weight" in state or "decoder.in.weight" in state:
        canonical = dict(state)  # already this repo's layout (our .npz)
    else:
        noise_in_ckpt = any(".linear.weight" in k for k in state)
        rename = snac_rename_map(cfg, noise_in_ckpt)
        canonical, unmapped = {}, []
        for k, v in state.items():
            if k in rename:
                canonical[rename[k]] = np.asarray(v)
            else:
                unmapped.append(k)
        if unmapped:
            msg = f"{len(unmapped)} unmapped keys, e.g. {unmapped[:5]}"
            if strict:
                raise KeyError(msg)
            print(f"warning: {msg}", file=sys.stderr)
    # verification: the converter must be able to build the decode pytree
    params_from_torch_state(canonical, cfg)
    return canonical


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help="snac checkpoint file or directory")
    ap.add_argument("-o", "--out", default="snac24.npz")
    ap.add_argument("--lenient", action="store_true",
                    help="warn instead of fail on unmapped keys")
    args = ap.parse_args(argv)
    cfg = SNACConfig.snac_24khz()
    state = load_torch_state(args.checkpoint)
    canonical = convert(state, cfg, strict=not args.lenient)
    np.savez(args.out, **canonical)
    print(f"wrote {args.out} ({len(canonical)} tensors); "
          f"use ORPHEUS_SNAC_PATH={args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
