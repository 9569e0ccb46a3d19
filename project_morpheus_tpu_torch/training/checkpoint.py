"""Trainer checkpoints in the port's own format (port of training/checkpoint.py).

The JAX package writes orbax directories; orbax and tensorstore are not on
the card's machine, so the port writes safetensors files and reads them
with its own reader (``model/hf_weights.read_safetensors``): no pickle
runs on load, a tensor goes from a mapping of the file to the device one
at a time, and bf16 round-trips bit for bit.  The layout keeps the JAX
package's names:

    <directory>/step_<N>/ or <directory>/latest/
        params.safetensors      the params tree, stacked layout, one tensor
                                per leaf named by its path ("layers.wq")
        opt_state.safetensors   train state only: AdamW moments "mu.<path>"
                                and "nu.<path>"
        train_state.json        train state only: {"step", "count"}
    <directory>/llama_config.json   the model config, when one is given

A grouped tree (``model.bridge.group_layer_params``) is written in the
stacked layout, its groups streamed one after another into each tensor.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..model.config import LlamaConfig
from ..model.hf_weights import read_safetensors
from ..utils.device import resolve_device

_ST_CODES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}


def _ckpt_path(directory, step: Optional[int]) -> Path:
    p = Path(directory).absolute()
    return p / (f"step_{step}" if step is not None else "latest")


def latest_step(directory) -> Optional[int]:
    """Highest step number checkpointed under ``directory`` (None if none)."""
    base = Path(directory).absolute()
    if not base.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in base.iterdir()
             if d.name.startswith("step_") and d.name.split("_")[1].isdigit()]
    return max(steps) if steps else None


def find_params(directory, step: Optional[int] = None) -> Optional[Path]:
    """The ``params.safetensors`` that ``restore_params`` reads: ``step_N``
    or ``latest``, else the newest ``step_N`` (None if there is none)."""
    path = _ckpt_path(directory, step) / "params.safetensors"
    if path.exists():
        return path
    newest = latest_step(directory)
    if newest is None:
        return None
    path = _ckpt_path(directory, newest) / "params.safetensors"
    return path if path.exists() else None


# ------------------------------------------------------------ files


def _flatten(tree, prefix: str = "") -> Dict[str, List[torch.Tensor]]:
    """path name -> parts; a list (the grouped layout) contributes its
    groups' parts to the same names, in order."""
    out: Dict[str, List[torch.Tensor]] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for g in tree:
            for name, parts in _flatten(g, prefix).items():
                out.setdefault(name, []).extend(parts)
    elif tree is not None:
        out[prefix[:-1]] = [tree]
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def _write_safetensors(path: Path, named: Dict[str, List[torch.Tensor]]) -> None:
    """Write ``name -> parts`` (parts concatenated on their first axis) to
    ``path`` through a temporary file, so a killed save leaves no torn file."""
    header, off = {}, 0
    for name, parts in named.items():
        dt = parts[0].dtype
        if dt not in _ST_CODES or any(p.dtype != dt for p in parts):
            raise ValueError(f"{name}: cannot write dtype {dt} (bf16, fp16 or fp32 only)")
        shape = list(parts[0].shape)
        if len(parts) > 1:
            shape[0] = sum(p.shape[0] for p in parts)
        nbytes = sum(p.numel() for p in parts) * dt.itemsize
        header[name] = {"dtype": _ST_CODES[dt], "shape": shape, "data_offsets": [off, off + nbytes]}
        off += nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for parts in named.values():
            for p in parts:
                f.write(p.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    os.replace(tmp, path)


def _read_tree(path: Path, device) -> Dict:
    return _unflatten({k: t.to(device, copy=True) for k, t in read_safetensors(path).items()})


# -------------------------------------------------------------- API


def save_params(directory, params, step: Optional[int] = None,
                cfg: Optional[LlamaConfig] = None) -> str:
    """Write ``params`` to ``step_<step>`` (or ``latest``) under
    ``directory``, and ``cfg`` to ``llama_config.json`` beside them (as
    ``scripts/convert_checkpoint.py`` writes it for the JAX package)."""
    path = _ckpt_path(directory, step)
    path.mkdir(parents=True, exist_ok=True)
    _write_safetensors(path / "params.safetensors", _flatten(params))
    if cfg is not None:
        (path.parent / "llama_config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=2))
    return str(path)


def restore_params(directory, step: Optional[int] = None, device="cuda") -> Dict:
    """The params tree saved at ``step`` (``latest`` by default, else the
    newest step) on ``device``, in its saved dtypes (the file holds every
    shape, so no config or target tree is needed)."""
    path = find_params(directory, step)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {Path(directory).absolute()}")
    return _read_tree(path, resolve_device(device))


def save_train_state(directory, params, opt_state, step: int) -> str:
    """Save the full trainer state, params + AdamW moments + step, so a
    killed run resumes on the same trajectory.  ``opt_state`` is the
    trainer's ``OptState`` or its ``moments()`` (whole tensors, as a
    sharded run gathers them)."""
    path = _ckpt_path(directory, step)
    path.mkdir(parents=True, exist_ok=True)
    moments = opt_state if isinstance(opt_state, dict) else opt_state.moments()
    _write_safetensors(path / "params.safetensors", _flatten(params))
    _write_safetensors(path / "opt_state.safetensors",
                       _flatten({"mu": moments["mu"], "nu": moments["nu"]}))
    (path / "train_state.json").write_text(
        json.dumps({"step": int(step), "count": int(moments["count"])}))
    return str(path)


def restore_train_state(directory, step: Optional[int] = None, device="cuda",
                        mesh=None, shard_mode: str = "fsdp") -> Dict:
    """``{"params", "opt_state": {"count", "mu", "nu"}, "step"}`` from
    ``step_<step>`` (the newest by default), stacked layout, on ``device``.
    With ``mesh``, every tree is this rank's ``shard_mode`` shards, cut on
    the host before they move to the device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = _ckpt_path(directory, step)
    dev = resolve_device(device)
    meta = json.loads((path / "train_state.json").read_text())
    read = "cpu" if mesh is not None else dev
    params = _read_tree(path / "params.safetensors", read)
    moments = _read_tree(path / "opt_state.safetensors", read)
    if mesh is not None:
        from ..model.bridge import tree_map
        from ..parallel.sharding import leaf_shardings, shard_params

        shardings = leaf_shardings(params, mesh, shard_mode)

        def local(tree):
            return tree_map(lambda a: a.to(dev), shard_params(tree, mesh, shard_mode, shardings))

        params = local(params)
        moments = {k: local(moments[k]) for k in ("mu", "nu")}
    return {"params": params,
            "opt_state": {"count": meta["count"], "mu": moments["mu"], "nu": moments["nu"]},
            "step": meta["step"]}
