"""Megatron tensor parallelism over a mesh's ``model`` axis: the operations
the model functions (``model/llama.py``) call where a sharded layer needs
a collective.

A rank holds the ``tp`` layout's shards (``sharding.shard_params``):
q/k/v and gate/up by output columns (its own ``num_heads / tp`` query and
``num_kv_heads / tp`` kv heads, whole heads only), o and down by input
rows, the embedding (and any untied lm_head) by padded-vocab rows.  So:

- a normed activation enters the column-split projections through
  :meth:`TensorParallel.enter` (its gradient is summed over the group);
- the row-split ``wo`` / ``wd`` partial sums are added over the group in
  fp32 and cast back (:meth:`reduce`);
- the embedding looks up the ids of its own vocab rows and the rows are
  summed over the group (:meth:`embed`);
- the lm head gives this rank's vocab columns of the logits, gathered
  before sampling (:meth:`gather_vocab`), or fed whole-group to the
  vocab-parallel cross entropy (:meth:`cross_entropy`).

``NO_TP`` (no group) makes each of these the unsharded computation, so the
single-device path is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..model.config import LlamaConfig
from ..model.quant import embed_lookup
from . import collectives as C


class TensorParallel:
    def __init__(self, group=None) -> None:
        self.group = group
        self.size = C.size(group)
        self.rank = C.rank(group)

    def local_cfg(self, cfg: LlamaConfig) -> LlamaConfig:
        """``cfg`` with this rank's head counts (the widths its shards hold)."""
        if self.size == 1:
            return cfg
        if cfg.num_kv_heads % self.size or cfg.num_heads % self.size:
            raise ValueError(f"tp={self.size} must divide the {cfg.num_heads} query and "
                             f"{cfg.num_kv_heads} kv heads")
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // self.size,
                                   num_kv_heads=cfg.num_kv_heads // self.size)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return C.copy_to(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return C.reduce_from(x, self.group)

    def amax(self, a: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over the group (no gradient)."""
        if self.group is None:
            return a
        return C.all_reduce(a.detach().clone(), self.group, torch.distributed.ReduceOp.MAX)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        return C.gather_from(logits, logits.dim() - 1, self.group)

    def _vocab_rows(self, tokens: torch.Tensor, n_local: int):
        local = tokens.long() - self.rank * n_local
        inside = (local >= 0) & (local < n_local)
        return local.clamp(0, n_local - 1), inside

    def embed(self, embed, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Token embeddings from a vocab-split table (plain or int8)."""
        if self.group is None:
            return embed_lookup(embed, tokens, dtype)
        n_local = (embed["q"] if isinstance(embed, dict) else embed).shape[0]
        local, inside = self._vocab_rows(tokens, n_local)
        x = embed_lookup(embed, local, dtype)
        return self.reduce(torch.where(inside[..., None], x, torch.zeros_like(x)))

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Per-row cross entropy of fp32 ``(N, V/tp)`` vocab-split logits
        against ``labels`` (N,), equal on every rank of the group."""
        if self.size == 1:  # the whole vocab: the library's cross entropy
            return F.cross_entropy(logits, labels, reduction="none")
        m = self.amax(logits.amax(dim=-1))
        z = logits - m[:, None]
        sumexp = self.reduce(z.exp().sum(dim=-1))
        local, inside = self._vocab_rows(labels, logits.shape[-1])
        target = z.gather(1, local[:, None])[:, 0]
        target = self.reduce(torch.where(inside, target, torch.zeros_like(target)))
        return sumexp.log() - target


NO_TP = TensorParallel(None)


def tensor_parallel(mesh) -> TensorParallel:
    """The mesh's model-axis tensor parallelism (``NO_TP`` without a mesh)."""
    if mesh is None:
        return NO_TP
    return TensorParallel(mesh.group("model"))


def as_tp(tp: Optional[TensorParallel]) -> TensorParallel:
    return NO_TP if tp is None else tp
