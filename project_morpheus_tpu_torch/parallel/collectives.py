"""Collectives over a mesh axis, and the autograd functions built on them.

Every collective takes a process group, and is the identity when it is
None (no process group).  Over ``gloo``, a CUDA tensor is staged through
the host explicitly: copied to the CPU, reduced or gathered there, and
copied back; gloo's own CUDA support differs between collectives and
PyTorch builds, and a staged copy behaves the same everywhere.

The autograd functions are Megatron's conjugate pairs, written here
rather than taken from ``torch.distributed.nn.functional``: there the
backward of ``all_reduce`` all-reduces the gradient again, which is the
gradient of the SUM of every rank's (identical) loss, tp times the one
loss; and its gather's backward needs a reduce-scatter, which gloo may not
carry for CUDA tensors.

- :func:`copy_to` (Megatron's f): identity forward, gradient summed over
  the group in the backward; it marks where a replicated activation
  enters column-parallel weights.
- :func:`reduce_from` (g): sum over the group forward (in fp32, then cast
  back), identity backward; row-parallel partial sums.
- :func:`gather_from`: all-gather along an axis forward, this rank's slice
  of the gradient backward (vocab-parallel logits).
- :func:`gather_param`: all-gather along an axis forward, reduce-scatter
  (sum) backward; ZeRO-3's gather of a parameter shard, whose backward
  leaves each rank the sum over the data ranks of its shard's gradient.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist


@torch.no_grad()
def _staged(group, fn: Callable, inputs: Sequence[torch.Tensor],
            outputs: Sequence[torch.Tensor]) -> None:
    """``fn(*inputs, *outputs)``, through host copies for CUDA tensors on gloo."""
    if dist.get_backend(group) == "gloo" and any(t.is_cuda for t in (*inputs, *outputs)):
        h_in = [t.cpu() for t in inputs]
        h_out = [torch.empty(t.shape, dtype=t.dtype) for t in outputs]
        fn(*h_in, *h_out)
        for t, h in zip(outputs, h_out):
            t.copy_(h)
        return
    fn(*inputs, *outputs)


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


@torch.no_grad()
def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t``; returns ``t``."""
    if group is None:
        return t
    if dist.get_backend(group) == "gloo" and t.is_cuda:
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in rank order."""
    n = size(group)
    if group is None:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _staged(group, lambda a, b: dist.all_gather_into_tensor(b, a, group=group), [x], [out])
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the group's sum of ``t``."""
    n = size(group)
    if group is None:
        return t
    x = t.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: axis of {x.shape[0]} not divisible by {n}")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _staged(group, lambda a, b: dist.reduce_scatter_tensor(b, a, group=group), [x], [out])
    return out.movedim(0, dim)


def local_slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = size(group)
    if n == 1:
        return t
    k = t.shape[dim] // n
    return t.narrow(dim, rank(group) * k, k).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g.contiguous(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.dim, ctx.group), None, None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def _sum_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, accumulated in fp32, cast back to ``x``'s dtype."""
    y = x.float().clone() if x.dtype == torch.float32 else x.float()
    return all_reduce(y, group).to(x.dtype)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, dim, group)


def gather_param(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherParam.apply(x, dim, group)
