"""Carry parameters from the JAX package into the port.

``params_from_jax_numpy`` takes a JAX parameter tree whose leaves were
turned into numpy arrays (``jax.tree.map(np.asarray, params)``) and gives
the port's form: the same nesting of dicts and lists with torch tensors.
That covers plain leaves and int8 ``{"q", "scale"}`` leaves, fused
(``wqkv``/``wgu``) and separate layer weights, and the SNAC params dict
(lists of quantizer levels and decoder blocks, ``None`` for a missing
encoder) and LoRA adapter trees, since every one of them is such a tree.
bf16 arrays (numpy's ``ml_dtypes`` bfloat16) arrive bit-exact as
``torch.bfloat16``.

``group_layer_params`` / ``ungroup_layer_params`` convert between the
canonical stacked layout (``layers`` a dict of ``(L, ...)`` leaves, the
layout of checkpoints, serving and ``merge_lora``) and the grouped one
the trainer keeps (``layers`` a list of dicts of ``(L/groups, ...)``
leaves; with one group per layer every layer's weights are leaves of
their own, so autograd never scatters a layer's gradient into a stack).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device)


def params_from_jax_numpy(tree, device="cpu", mesh=None, mode: str = "tp"):
    """JAX params tree with numpy leaves -> the port's params on ``device``.
    With ``mesh``, this rank's ``mode`` shards of the Llama params
    (``parallel.sharding.shard_params``), cut before they move."""
    if mesh is not None:
        from ..parallel.sharding import shard_params

        tree = shard_params(tree, mesh, mode)
    return tree_map(lambda a: _leaf(a, device), tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves of a params tree, dict keys sorted (JAX's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree):
    """``fn`` on every tensor leaf, the nesting kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_unflatten(tree, leaves: List):
    """``tree``'s structure holding ``leaves`` (in :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(tree)


def group_layer_params(params: Dict, groups: int) -> Dict:
    """Split the stacked layer leaves into ``groups`` lists of separate
    leaves; every leaf of the result is a copy, so it trains without
    touching ``params``.
    Works on any tree with a ``layers`` entry: params, grads, moments."""
    first = params["layers"][next(iter(params["layers"]))]
    L = (first["q"] if isinstance(first, dict) else first).shape[0]
    if L % groups:
        raise ValueError(f"{L} layers not divisible into {groups} groups")
    k = L // groups
    out = {name: tree_map(torch.clone, leaf) for name, leaf in params.items() if name != "layers"}
    out["layers"] = [tree_map(lambda a: a[g * k:(g + 1) * k].clone(), params["layers"])
                     for g in range(groups)]
    return out


def ungroup_layer_params(params: Dict) -> Dict:
    """Inverse of :func:`group_layer_params`: the groups concatenated back
    into stacked leaves (a no-op on the stacked layout)."""
    if not isinstance(params["layers"], (list, tuple)):
        return params
    groups = [tree_leaves(g) for g in params["layers"]]
    stacked = [torch.cat([g[i].detach() for g in groups]) for i in range(len(groups[0]))]
    out = dict(params)
    out["layers"] = tree_unflatten(params["layers"][0], stacked)
    return out
