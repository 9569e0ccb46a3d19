"""A rank's part of a train step on a mesh: ZeRO-3 over ``data``,
Megatron over ``model`` (the ``fsdp`` and ``fsdp_tp`` modes of
``sharding.py``; ``tp`` and ``replicated`` fall out of the same rules).

- Each rank keeps only its shards of the params and of the AdamW moments
  (AdamW is elementwise, so the update of a shard is the shard of the
  update).
- The forward gathers a leaf's ``data`` split right before use
  (:meth:`TrainShards.gather_layer` inside each recomputed layer; the
  embedding, final norm and head once a step, :meth:`gather_top`); the
  gather's backward reduce-scatters the gradient over ``data``.  The
  ``model`` split stays, and the layers run tensor-parallel
  (``tensor.py``).
- Each data rank's loss is its batch's summed token losses over the
  global token count, so the gradients summed over ``data`` are the
  gradients of the global mean loss; a leaf not split over ``data`` has its
  gradient all-reduced over ``data`` (:meth:`reduce_grads`).
- The clipping norm sums each leaf's squares over the mesh axes the leaf
  is split on, and nowhere else (:meth:`global_norm`), so every rank
  clips by the single-rank norm of the whole tree.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from ..model.bridge import tree_leaves
from . import collectives as C
from .mesh import Mesh
from .sharding import Sharding, leaf_shardings, shard_params, unshard
from .tensor import NO_TP, tensor_parallel

MODES = ("fsdp", "fsdp_tp", "tp", "replicated")


class _Box:
    """Holds a Sharding as a tree leaf (a Sharding is a tuple, which the
    tree helpers would walk into)."""

    def __init__(self, s: Sharding) -> None:
        self.s = s


class TrainShards:
    def __init__(self, mesh: Mesh, mode: str, params: Dict) -> None:
        if mode not in MODES:
            raise ValueError(f"unknown sharding mode {mode!r}")
        self.mesh, self.mode = mesh, mode
        self.shardings = leaf_shardings(params, mesh, mode)
        self.tp = tensor_parallel(mesh) if mode in ("tp", "fsdp_tp") else NO_TP
        self.data = mesh.group("data")

    # ------------------------------------------------------------ layout

    def cut(self, tree: Dict) -> Dict:
        """This rank's shards of a full stacked tree (params or a moment)."""
        return shard_params(tree, self.mesh, self.mode, self.shardings)

    def full(self, tree: Dict) -> Dict:
        """Whole tensors of a stacked tree of this rank's shards."""
        return unshard(tree, self.shardings, self.mesh)

    def _leaf_shardings(self, grouped: Dict) -> List[Sharding]:
        """Shardings in ``tree_leaves`` order of a grouped tree."""
        n = len(grouped["layers"])
        boxed = {k: _Box(v) for k, v in self.shardings.items() if k != "layers"}
        boxed["layers"] = [{k: _Box(v) for k, v in self.shardings["layers"].items()}] * n
        return [b.s for b in tree_leaves(boxed)]

    # ------------------------------------------------------------ forward

    def _gather(self, leaf: torch.Tensor, s: Sharding, drop_layer_axis: bool) -> torch.Tensor:
        axis = s.axis_of("data")
        if axis is None:
            return leaf
        return C.gather_param(leaf, axis - int(drop_layer_axis), self.data)

    def gather_top(self, params: Dict) -> Dict:
        """``params`` with the embedding, final norm and any lm_head whole
        over ``data``."""
        out = dict(params)
        for k in ("embed", "ln_f", "lm_head"):
            if k in params:
                out[k] = self._gather(params[k], self.shardings[k], False)
        return out

    def gather_layer(self, wl: Dict) -> Dict:
        """One layer's weights (leading layer axis gone) whole over ``data``."""
        return {k: self._gather(w, self.shardings["layers"][k], True) for k, w in wl.items()}

    # ----------------------------------------------------------- backward

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        return C.all_reduce(t.detach().clone(), self.data)

    def reduce_grads(self, grads: List[torch.Tensor], grouped: Dict) -> List[torch.Tensor]:
        """All-reduce over ``data`` the gradient of every leaf not split over
        it (the split ones were reduce-scattered by their gathers)."""
        out = []
        for g, s in zip(grads, self._leaf_shardings(grouped), strict=True):
            if s.axis_of("data") is None and self.data is not None:
                g = C.all_reduce(g.contiguous(), self.data)
            out.append(g)
        return out

    def global_norm_fn(self, grouped: Dict):
        shardings = self._leaf_shardings(grouped)

        def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
            """sqrt of the whole tree's sum of squares, in fp32: each leaf's
            local sum reduced over exactly the mesh axes it is split on."""
            by_axes: Dict[tuple, torch.Tensor] = {}
            for g, s in zip(grads, shardings, strict=True):
                key = tuple(sorted(set(s.mesh_axes)))
                part = g.float().square().sum()
                by_axes[key] = by_axes[key] + part if key in by_axes else part
            total = None
            for axes, part in sorted(by_axes.items()):
                if axes == ("data",):
                    part = C.all_reduce(part, self.mesh.group("data"))
                elif axes == ("model",):
                    part = C.all_reduce(part, self.mesh.group("model"))
                elif axes:
                    part = C.all_reduce(part, self.mesh.world_group())
                total = part if total is None else total + part
            return torch.sqrt(total)

        return global_norm

    def barrier(self) -> None:
        if self.mesh.world_group() is not None:
            dist.barrier()

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes checkpoints."""
        return not dist.is_initialized() or dist.get_rank() == 0

