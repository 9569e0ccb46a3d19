"""Shardings of the Llama parameter and serving-state trees (port of
parallel/sharding.py), and the cut of a rank's shard.

A :class:`Sharding` is the counterpart of JAX's ``NamedSharding(mesh,
PartitionSpec(...))``: per tensor axis, the mesh axis it is split over
(``"data"``, ``"model"``) or None.  The modes and their specs are the
JAX package's, leaf for leaf:

- ``tp``: Megatron over ``model``: q/k/v and gate/up column-split, o and
  down row-split, the embedding (and any lm_head) split on the padded
  vocab;
- ``fsdp``: ZeRO-3 over ``data``: every parameter split on its hidden
  (or vocab) axis, gathered layer by layer when used;
- ``fsdp_tp``: both at once: hidden over ``data``, heads/ffn/vocab over
  ``model``;
- ``replicated``: every leaf whole on every rank.

The port computes with explicit shards (``shard_params``) and explicit
collectives (``collectives.py``, ``tensor.py``), not with sharded tensor
types: its model is plain functions over parameter dicts, so there is no
module tree for ``parallelize_module`` / ``fully_shard`` to wrap.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

from ..model.config import LlamaConfig
from ..model.quant import is_quantized
from .mesh import Mesh

_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd")


class Sharding(NamedTuple):
    mesh: Optional[Mesh]
    spec: Tuple[Optional[str], ...]

    def axis_of(self, mesh_axis: str) -> Optional[int]:
        """The tensor axis split over ``mesh_axis`` (None: not split)."""
        for i, name in enumerate(self.spec):
            if name == mesh_axis:
                return i
        return None

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.spec if a is not None)


def _ns(mesh, *spec) -> Sharding:
    return Sharding(mesh, tuple(spec))


def param_shardings(cfg: LlamaConfig, mesh: Optional[Mesh], mode: str = "tp") -> Dict:
    """Sharding tree matching ``init_llama_params``' structure; the leading
    layer axis of the stacked weights is never split."""
    if mode == "tp":
        layers = {
            "ln1": _ns(mesh, None, None),
            "wq": _ns(mesh, None, None, "model"),
            "wk": _ns(mesh, None, None, "model"),
            "wv": _ns(mesh, None, None, "model"),
            "wo": _ns(mesh, None, "model", None),
            "ln2": _ns(mesh, None, None),
            "wg": _ns(mesh, None, None, "model"),
            "wu": _ns(mesh, None, None, "model"),
            "wd": _ns(mesh, None, "model", None),
        }
        out = {"embed": _ns(mesh, "model", None), "layers": layers, "ln_f": _ns(mesh, None)}
        if not cfg.tie_embeddings:
            out["lm_head"] = _ns(mesh, None, "model")
        return out
    if mode == "fsdp":
        layers = {k: _ns(mesh, None, "data") if k in ("ln1", "ln2") else
                  _ns(mesh, None, "data", None) for k in _LAYER_KEYS}
        out = {"embed": _ns(mesh, "data", None), "layers": layers, "ln_f": _ns(mesh, "data")}
        if not cfg.tie_embeddings:
            out["lm_head"] = _ns(mesh, "data", None)
        return out
    if mode == "fsdp_tp":
        layers = {
            "ln1": _ns(mesh, None, None),
            "wq": _ns(mesh, None, "data", "model"),
            "wk": _ns(mesh, None, "data", "model"),
            "wv": _ns(mesh, None, "data", "model"),
            "wo": _ns(mesh, None, "model", "data"),
            "ln2": _ns(mesh, None, None),
            "wg": _ns(mesh, None, "data", "model"),
            "wu": _ns(mesh, None, "data", "model"),
            "wd": _ns(mesh, None, "model", "data"),
        }
        out = {"embed": _ns(mesh, "model", "data"), "layers": layers, "ln_f": _ns(mesh, None)}
        if not cfg.tie_embeddings:
            out["lm_head"] = _ns(mesh, "data", "model")
        return out
    if mode == "replicated":
        out = {"embed": _ns(mesh), "layers": {k: _ns(mesh) for k in _LAYER_KEYS},
               "ln_f": _ns(mesh)}
        if not cfg.tie_embeddings:
            out["lm_head"] = _ns(mesh)
        return out
    raise ValueError(f"unknown sharding mode {mode!r}")


def _scale_sharding(s: Sharding, qshape, sshape) -> Sharding:
    """The scale's dims match (in order) a subset of q's dims, greedily by
    size: per output column for layer weights ((L, in, out) -> (L, out)),
    per row for the embedding ((V, D) -> (V,)); no alignment: replicated."""
    spec = list(s.spec) + [None] * (len(qshape) - len(s.spec))
    kept = [None] * len(sshape)
    i = len(qshape) - 1
    for j in reversed(range(len(sshape))):
        while i >= 0 and qshape[i] != sshape[j]:
            i -= 1
        if i < 0:
            return Sharding(s.mesh, (None,) * len(sshape))
        kept[j] = spec[i]
        i -= 1
    return Sharding(s.mesh, tuple(kept))


def shardings_like(params: Dict, shardings: Dict) -> Dict:
    """Adapt a ``param_shardings`` tree to the actual params: fused
    ``wqkv``/``wgu`` leaves take wq's / wg's spec (tensor parallelism never
    fuses), and an int8 leaf ``{"q", "scale"}`` gives ``q`` the weight's
    spec and ``scale`` the spec without the contraction axis."""

    def adapt(p, s):
        if is_quantized(p):
            return {"q": s, "scale": _scale_sharding(s, tuple(p["q"].shape),
                                                     tuple(p["scale"].shape))}
        return s

    out: Dict = {}
    for key, val in params.items():
        if key == "layers":
            lsh = shardings["layers"]
            out["layers"] = {k: adapt(v, lsh.get(k) or lsh.get({"wqkv": "wq", "wgu": "wg"}.get(k, k)))
                             for k, v in val.items()}
        else:
            out[key] = adapt(val, shardings[key])
    return out


def kv_cache_shardings(mesh: Optional[Mesh], quantized: bool = False) -> Dict:
    """Cache slots over ``data``, kv heads over ``model``: the bf16 cache
    ``(L, slots, KV, S, HD)`` on its head axis, the flat int8 payload
    ``(L, slots, S, KV*HD)`` at kv-head boundaries of its minor axis; the
    int8 scales ``(L, slots, S, 2*KV)`` stay whole over ``model`` in the
    JAX layout (the port's TP engine keeps each rank's own heads' scales,
    see ``engine/engine.py``)."""
    if quantized:
        return {"k": _ns(mesh, None, "data", None, "model"),
                "v": _ns(mesh, None, "data", None, "model"),
                "scale": _ns(mesh, None, "data", None, None)}
    return {"k": _ns(mesh, None, "data", "model", None, None),
            "v": _ns(mesh, None, "data", "model", None, None)}


def engine_state_shardings(mesh: Optional[Mesh], quantized_cache: bool = False,
                           audio_ring: bool = False) -> Dict:
    """The serving slot table's shardings: every per-slot array over
    ``data``, the cache as :func:`kv_cache_shardings`."""
    slot = _ns(mesh, "data")
    out = {
        "cache": kv_cache_shardings(mesh, quantized_cache),
        "lengths": slot,
        "active": slot,
        "remaining": slot,
        "is_audio": slot,
        "custom_stops": _ns(mesh, "data", None),
        "rng": slot,
        "last_tokens": slot,
        "presence": _ns(mesh, "data", None),
        "temp": slot,
        "top_p": slot,
        "rep_pen": slot,
    }
    if audio_ring:
        out.update({
            "ring": _ns(mesh, "data", None),
            "partial": _ns(mesh, "data", None),
            "pcnt": slot,
            "fcnt": slot,
            "audio_pos": slot,
            "frame_done": slot,
        })
    return out


def batch_shardings(mesh: Optional[Mesh]) -> Sharding:
    """Training batches: (B, S) split over ``data``."""
    return _ns(mesh, "data", None)


# ------------------------------------------------------------- shards


def _tree_zip(fn, tree, shardings):
    if isinstance(tree, dict):
        return {k: _tree_zip(fn, v, shardings[k]) for k, v in tree.items()}
    return fn(tree, shardings)


def cut(leaf, sharding: Sharding, mesh: Mesh):
    """This rank's block of ``leaf`` (a tensor or numpy array): each axis
    split over a mesh axis keeps the block at this rank's coordinate."""
    for axis, name in enumerate(sharding.spec):
        if name is None:
            continue
        n, i = mesh.shape[name], mesh.coords[name]
        if leaf.shape[axis] % n:
            raise ValueError(f"axis {axis} of size {leaf.shape[axis]} does not split over "
                             f"{name}={n}")
        k = leaf.shape[axis] // n
        index = [slice(None)] * leaf.ndim
        index[axis] = slice(i * k, (i + 1) * k)
        leaf = leaf[tuple(index)]
    if hasattr(leaf, "contiguous"):
        return leaf.contiguous().clone() if sharding.mesh_axes else leaf
    import numpy as np

    return np.ascontiguousarray(leaf)


def leaf_shardings(params: Dict, mesh: Optional[Mesh], mode: str) -> Dict:
    """``shardings_like(params, param_shardings(...))`` for a params tree
    (tied or not, plain or int8, fused or not)."""
    cfg = LlamaConfig(tie_embeddings="lm_head" not in params)
    return shardings_like(params, param_shardings(cfg, mesh, mode))


def shard_params(params: Dict, mesh: Mesh, mode: str, shardings: Optional[Dict] = None) -> Dict:
    """This rank's shard of the full params tree (torch tensors or the
    numpy leaves of a JAX params tree), cut by the ``mode`` specs (or by
    ``shardings``, for a tree shaped like params, such as an AdamW
    moment)."""
    if shardings is None:
        shardings = leaf_shardings(params, mesh, mode)
    return _tree_zip(lambda leaf, s: cut(leaf, s, mesh), params, shardings)


def unshard(tree: Dict, shardings: Dict, mesh: Mesh) -> Dict:
    """Whole tensors from every rank's shards (all-gathered over each split
    axis; every rank receives them)."""
    from .collectives import all_gather

    def whole(leaf, s: Sharding):
        for axis, name in enumerate(s.spec):
            if name is not None:
                leaf = all_gather(leaf, axis, mesh.group(name))
        return leaf

    return _tree_zip(whole, tree, shardings)
