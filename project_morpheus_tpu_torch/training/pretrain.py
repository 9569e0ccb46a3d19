"""Pretraining (port of training/pretrain.py).

The JAX trainer is one jitted step over parameters sharded on a mesh; here
it is one autograd step per process.  One card holds the reference recipe
(Orpheus-3B, bf16, seq 8192, batch 1) whole: bf16 params and grads, AdamW
moments in the params' dtype (as optax keeps them), layer-boundary
activations under per-layer recompute and one chunk of fp32 logits.  On a
mesh (``train_loop(mesh=..., shard_mode=...)``) each process is one rank
of ``torch.distributed``: ``fsdp`` is ZeRO-3 over ``data``, ``fsdp_tp``
adds Megatron tensor parallelism over ``model``
(``parallel/training.py``); batches are rank-local (``data.shard_for_rank``
by the rank's data coordinate), and the losses, the clipped update and the
checkpoints equal the single-process run on the global batch.

The optimizer is ``torch.optim.AdamW`` behind a ``LambdaLR`` that gives
optax's ``warmup_cosine_decay_schedule`` (evaluated at the update count
before the step, so with warmup the first step's learning rate is 0), and
before it optax's ``clip_by_global_norm``: ``select(norm < max, g,
g / norm * max)``, without ``clip_grad_norm_``'s epsilon.  The norm sums
each leaf's squares in fp32 (optax sums in the leaves' dtype).  Weight
decay applies to every leaf, norms and embedding included, as
``make_optimizer`` has no mask.

The trainer keeps its parameters in the grouped layout with one group per
layer (``model.bridge.group_layer_params``), so each layer's weights are
leaves of their own; the stacked layout exists only at the boundary
(``train_loop``'s arguments and result, checkpoints).  Loss streams are
split text/audio by batch kind for logging, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..model.bridge import (
    group_layer_params,
    tree_leaves,
    tree_map,
    tree_unflatten,
    ungroup_layer_params,
)
from ..model.config import LlamaConfig
from ..model.llama import llama_forward, lm_head_logits
from ..parallel.tensor import NO_TP
from ..utils.device import resolve_device
from .data import IGNORE_LABEL

__all__ = ["TrainConfig", "make_optimizer", "causal_lm_loss", "resolve_attn",
           "group_layer_params", "ungroup_layer_params", "make_grouped_grad_step",
           "make_train_step", "train_loop", "LOGITS_CHUNK", "LONG_SEQ_THRESHOLD"]


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    seq_len: int = 8192
    save_steps: int = 5000  # reference pretrain/config.yaml cadence
    log_every: int = 10
    # "auto" switches to blockwise attention and per-layer recompute at
    # LONG_SEQ_THRESHOLD and above; "dense"/"blockwise" force an impl
    attn_impl: str = "auto"
    remat: str = "auto"  # "auto" | "on" | "off"


LONG_SEQ_THRESHOLD = 2048  # dense O(S^2) scores stop fitting around here

# chunked-vocab loss chunk length for long sequences: 512 positions x the
# 157k padded vocab = 320 MB of fp32 logits, against ~5 GB (+5 GB of
# gradient) for a whole seq-8192 sequence
LOGITS_CHUNK = 512


# ------------------------------------------------------------ optimizer


def warmup_cosine_lr(tc: TrainConfig, count: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1))`` at update count ``count``: linear from 0 over the warmup,
    then a cosine to 0."""
    peak, warm = tc.learning_rate, tc.warmup_steps
    if count < warm:
        return peak * count / warm
    decay = max(tc.total_steps, warm + 1) - warm
    t = min(count - warm, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm_fn: Callable = global_norm) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``, in place: leaves unchanged while the
    norm is below ``max_norm``, else ``g / norm * max_norm`` (no epsilon;
    dividing and multiplying by 1 leaves a value exact).  The choice stays
    on the device: no host sync.  ``norm_fn`` is the sharded norm on a
    mesh."""
    norm = norm_fn(grads)
    keep = norm < max_norm
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
    return grads


@dataclasses.dataclass
class OptState:
    """One run's optimizer state: the leaves it updates (of the tree it
    was made for), the AdamW moments and the schedule."""

    tree: object
    leaves: List[torch.Tensor]
    adamw: torch.optim.AdamW
    schedule: torch.optim.lr_scheduler.LambdaLR

    @property
    def count(self) -> int:
        """Updates applied (optax's ``count``)."""
        return self.schedule.last_epoch

    def moments(self) -> Dict[str, object]:
        """``{"count", "mu", "nu"}`` with moment trees shaped like ``tree``
        (zeros before the first update, as optax initialises them)."""
        def get(name):
            return tree_unflatten(self.tree, [
                self.adamw.state[p][name] if p in self.adamw.state else torch.zeros_like(p)
                for p in self.leaves])
        return {"count": self.count, "mu": get("exp_avg"), "nu": get("exp_avg_sq")}

    def load_moments(self, state: Dict[str, object]) -> None:
        """Inverse of :meth:`moments` (trees in ``tree``'s layout)."""
        count = int(state["count"])
        mus, nus = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        for p, mu, nu in zip(self.leaves, mus, nus, strict=True):
            self.adamw.state[p] = {"step": torch.tensor(float(count)),
                                   "exp_avg": mu.to(p.device, p.dtype).clone(),
                                   "exp_avg_sq": nu.to(p.device, p.dtype).clone()}
        self.schedule.last_epoch = count
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule.lr_lambdas[0](count)


class AdamWSchedule:
    """optax ``chain(clip_by_global_norm, adamw(warmup_cosine schedule))``
    as ``torch.optim.AdamW`` + ``LambdaLR``: :meth:`init` binds it to a
    tree's leaves, :meth:`update` applies one step in place."""

    def __init__(self, tc: TrainConfig) -> None:
        self.tc = tc

    def init(self, tree) -> OptState:
        leaves = tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
        adamw = torch.optim.AdamW(leaves, lr=1.0, betas=(self.tc.b1, self.tc.b2), eps=1e-8,
                                  weight_decay=self.tc.weight_decay)
        schedule = torch.optim.lr_scheduler.LambdaLR(
            adamw, lambda count: warmup_cosine_lr(self.tc, count))
        return OptState(tree, leaves, adamw, schedule)

    def update(self, grads: List[torch.Tensor], state: OptState,
               norm_fn: Callable = global_norm) -> None:
        """Clip ``grads`` (in ``state.leaves`` order), step AdamW at the
        schedule's current rate, then advance the schedule."""
        clipped = clip_by_global_norm(list(grads), self.tc.max_grad_norm, norm_fn)
        for p, g in zip(state.leaves, clipped, strict=True):
            p.grad = g
        state.adamw.step()
        state.adamw.zero_grad(set_to_none=True)
        state.schedule.step()


def make_optimizer(tc: TrainConfig) -> AdamWSchedule:
    return AdamWSchedule(tc)


# ----------------------------------------------------------------- loss


def _batch_tensors(batch: Dict, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(input ids, bool attention mask, int64 labels) on ``device``."""
    def get(name):
        return torch.as_tensor(batch[name]).to(device)
    return get("input_ids"), get("attention_mask").bool(), get("labels").long()


def _chunk_loss(head: Dict, h: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, tp=NO_TP) -> torch.Tensor:
    logits = lm_head_logits(head, h, tp)  # (B, C, padded_vocab [/ tp]) fp32
    ll = tp.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return (ll * mask.reshape(-1)).sum()


def causal_lm_loss(
    params,
    batch: Dict,
    cfg: LlamaConfig,
    lora=None,
    lora_scale: float = 1.0,
    attn_impl: str = "dense",
    remat: bool = False,
    logits_chunk: int = 0,
    scan_layers: bool = True,
    accum_stack_grads: bool = False,
    shard=None,
) -> torch.Tensor:
    """Next-token cross entropy over the padded vocab, ``-100`` labels
    ignored, divided by ``max(labels kept, 1)``.

    ``shard`` (a ``parallel.training.TrainShards``): ``params`` are this
    rank's shards, ``batch`` its data rank's examples, and the result its
    share of the global mean loss: its token losses over the token count
    of every data rank (the shares summed over ``data`` are the loss).

    ``logits_chunk > 0`` is the chunked-vocab loss: the forward returns
    hidden states and the lm head + softmax cross entropy run on one
    ``logits_chunk``-position chunk at a time, each under a non-reentrant
    ``torch.utils.checkpoint``, so the backward recomputes the chunk's
    logits and the ``(S, padded_vocab)`` fp32 logits never exist whole.
    The tied embedding takes its gradient from the lookup and the head."""
    ids, attn_mask, labels = _batch_tensors(batch, params["ln_f"].device)
    tp, extra = NO_TP, {}
    if shard is not None:
        params = shard.gather_top(params)
        tp = shard.tp
        extra = {"tp": tp, "gather_layer": shard.gather_layer}
    out, _ = llama_forward(
        params, ids, cfg, attn_mask=attn_mask, lora=lora, lora_scale=lora_scale,
        attn_impl=attn_impl, remat=remat, return_hidden=bool(logits_chunk),
        scan_layers=scan_layers, accum_stack_grads=accum_stack_grads, **extra)
    labels = labels[:, 1:]
    mask = labels != IGNORE_LABEL
    safe = labels.masked_fill(~mask, 0)
    mask = mask.float()
    count = mask.sum()
    if shard is not None:
        count = shard.data_sum(count)
    denom = torch.clamp(count, min=1.0)
    out = out[:, :-1]
    if not logits_chunk:
        ll = tp.cross_entropy(out.reshape(-1, out.shape[-1]), safe.reshape(-1))
        return (ll * mask.reshape(-1)).sum() / denom
    head = {k: params[k] for k in ("embed", "lm_head") if k in params}
    total = torch.zeros((), dtype=torch.float32, device=out.device)
    for c0 in range(0, out.shape[1], logits_chunk):
        c = slice(c0, c0 + logits_chunk)
        args = (head, out[:, c], safe[:, c], mask[:, c], tp)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            total = total + _chunk_loss(*args)
    return total / denom


def resolve_attn(seq_len: int, attn_impl: str = "auto", remat: str = "auto"):
    """Pick (attn_impl, remat) for a training sequence length."""
    long = seq_len >= LONG_SEQ_THRESHOLD
    impl = attn_impl if attn_impl != "auto" else ("blockwise" if long else "dense")
    rm = remat == "on" or (remat == "auto" and long)
    return impl, rm


# ---------------------------------------------------------------- steps


def make_grouped_grad_step(
    cfg: LlamaConfig,
    optimizer: AdamWSchedule,
    groups: int,
    attn_impl: str = "auto",
    remat: str = "auto",
) -> Callable:
    """An exact optimizer step whose backward runs in ``groups`` passes.

    On a 15.75 GiB v5e the JAX package could not hold one monolithic 3B
    fwd/bwd program (18.1 GiB of backward temporaries), so pass ``g``
    recomputes the forward and differentiates only layer group ``g``, the
    other groups and (until the last pass) the embedding, final norm and
    head being constants; gradients accumulate and one update applies
    them.  One card holds the monolithic step, so the trainer does not use
    this; it keeps its contract: every pass sees the original params, so
    the result equals :func:`make_train_step`'s.  Takes and returns the
    grouped layout (``group_layer_params(params, groups)``).
    """

    def step(params, opt_state: OptState, batch):
        layer_groups = params["layers"]
        if not isinstance(layer_groups, (list, tuple)) or len(layer_groups) != groups:
            raise ValueError("params must come from group_layer_params(params, groups)")
        seq = batch["input_ids"].shape[1]
        impl, rm = resolve_attn(seq, attn_impl, remat)
        chunk = LOGITS_CHUNK if seq >= LONG_SEQ_THRESHOLD else 0
        rest = {k: v for k, v in params.items() if k != "layers"}
        found = {}
        loss = None
        for g in range(groups):
            last = g == groups - 1
            detached = [lg if i == g else tree_map(torch.Tensor.detach, lg)
                        for i, lg in enumerate(layer_groups)]
            p = {**(rest if last else tree_map(torch.Tensor.detach, rest)), "layers": detached}
            loss = causal_lm_loss(p, batch, cfg, attn_impl=impl, remat=rm, logits_chunk=chunk)
            wrt = tree_leaves(layer_groups[g]) + (tree_leaves(rest) if last else [])
            found.update(zip(map(id, wrt), torch.autograd.grad(loss, wrt)))
        optimizer.update([found[id(p)] for p in opt_state.leaves], opt_state)
        return params, opt_state, loss.detach()

    return step


def make_train_step(
    cfg: LlamaConfig,
    optimizer: AdamWSchedule,
    attn_impl: str = "auto",
    remat: str = "auto",
    scan_layers: bool = True,
    stack_grad: str = "auto",  # "auto" | "scan" | "accum" (llama_forward's accum_stack_grads)
    shard=None,  # parallel.training.TrainShards: a rank's step on a mesh
) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: one
    forward, backward and update, in place.

    ``attn_impl="auto"`` resolves per batch shape: at
    ``LONG_SEQ_THRESHOLD`` and above, blockwise attention, per-layer
    recompute and the chunked-vocab loss.  ``stack_grad="auto"`` takes
    ``accum_stack_grads`` for long sequences over the stacked layout, as
    JAX does (here it is the same per-layer recompute).

    With ``shard`` the step takes and returns a rank's shards (grouped
    layout) and returns the global loss."""

    def step(params, opt_state: OptState, batch):
        seq = batch["input_ids"].shape[1]
        impl, rm = resolve_attn(seq, attn_impl, remat)
        long = seq >= LONG_SEQ_THRESHOLD
        accum = stack_grad == "accum" or (
            stack_grad == "auto" and long and not isinstance(params["layers"], (list, tuple)))
        loss = causal_lm_loss(
            params, batch, cfg, attn_impl=impl, remat=rm and not accum,
            logits_chunk=LOGITS_CHUNK if long else 0, scan_layers=scan_layers,
            accum_stack_grads=accum, shard=shard)
        grads = torch.autograd.grad(loss, opt_state.leaves, materialize_grads=True)
        if shard is None:
            optimizer.update(grads, opt_state)
            return params, opt_state, loss.detach()
        optimizer.update(shard.reduce_grads(grads, params), opt_state,
                         shard.global_norm_fn(params))
        return params, opt_state, shard.data_sum(loss)

    return step


# ----------------------------------------------------------------- loop


def train_loop(
    params,
    cfg: LlamaConfig,
    batches: Iterable[Dict],
    tc: Optional[TrainConfig] = None,
    mesh=None,
    log: Optional[Callable[[Dict], None]] = None,
    checkpoint_dir: Optional[str] = None,
    collate: Optional[Callable] = None,
    resume: bool = True,
    shard_mode: str = "fsdp",
    device="cuda",
) -> Tuple[Dict, Dict]:
    """Drive ``{"kind": "text"|"audio", "examples": [...]}`` batches (from
    ``BatchedRatioDataset``) through the train step on ``device``; losses
    go to ``history`` under ``<kind>_loss``.  ``params`` (stacked layout)
    is copied, not changed; the trained params come back stacked.

    With ``checkpoint_dir`` the full trainer state (params, AdamW moments,
    step) is saved every ``save_steps`` and at the end, and, when
    ``resume`` finds a checkpoint, restored: the run continues on the same
    trajectory, the data cursor replayed by skipping trained batches.

    ``mesh`` (``parallel.make_mesh``): every rank calls this with the full
    ``params`` and its own ``batches``, keeps its ``shard_mode`` shards
    (``"fsdp"`` or ``"fsdp_tp"``; ``parallel/training.py``), logs the
    global loss, and gets back the whole trained params; rank 0 writes the
    checkpoints, as whole tensors in the single-device layout.  ``device``
    must be the mesh's device type."""
    from .checkpoint import latest_step, restore_train_state, save_train_state
    from .data import pad_collate

    dev = resolve_device(device)
    shard = None
    if mesh is not None:
        from ..parallel.training import TrainShards

        if mesh.device.type != dev.type:
            raise ValueError(f"mesh on {mesh.device}, train_loop asked for {dev}")
        dev = mesh.device
        shard = TrainShards(mesh, shard_mode, params)
    tc = tc or TrainConfig()
    collate = collate or (lambda ex: pad_collate(ex, max_len=tc.seq_len))
    optimizer = make_optimizer(tc)
    restored = None
    if checkpoint_dir and resume and latest_step(checkpoint_dir) is not None:
        restored = restore_train_state(checkpoint_dir, device=dev, mesh=mesh,
                                       shard_mode=shard_mode)
        params = restored["params"]

    def local(tree):
        """The trainer's layout: this rank's shards (restored trees come
        cut), one group per layer."""
        tree = tree_map(lambda a: a.detach().to(dev), tree)
        if shard is not None and restored is None:
            tree = shard.cut(tree)
        return group_layer_params(tree, cfg.num_layers)

    params = local(params)
    opt_state = optimizer.init(params)
    start_step = 0
    if restored is not None:
        moments = restored["opt_state"]
        opt_state.load_moments({"count": moments["count"], "mu": local(moments["mu"]),
                                "nu": local(moments["nu"])})
        start_step = int(restored["step"])
        if log is not None:
            log({"resumed_at_step": start_step})
    step_fn = make_train_step(cfg, optimizer, tc.attn_impl, tc.remat, shard=shard)

    def save(step: int) -> None:
        if shard is None:
            save_train_state(checkpoint_dir, params, opt_state, step)
            return
        moments = opt_state.moments()
        whole = {"count": moments["count"]}
        for name in ("mu", "nu"):
            whole[name] = shard.full(ungroup_layer_params(moments[name]))
        full = shard.full(ungroup_layer_params(params))
        if shard.is_writer:
            save_train_state(checkpoint_dir, full, whole, step)
        shard.barrier()

    history: Dict[str, list] = {"text_loss": [], "audio_loss": []}
    start = time.monotonic()
    step_idx = 0
    for batch_spec in batches:
        if step_idx >= tc.total_steps:
            break
        if step_idx < start_step:
            step_idx += 1  # deterministic data-cursor replay
            continue
        batch = collate(batch_spec["examples"])
        params, opt_state, loss = step_fn(params, opt_state, batch)
        loss_val = float(loss)
        stream = f"{batch_spec['kind']}_loss"
        history.setdefault(stream, []).append(loss_val)
        if log is not None and step_idx % tc.log_every == 0:
            log({"step": step_idx, stream: loss_val, "elapsed_s": time.monotonic() - start})
        if checkpoint_dir and step_idx > 0 and (step_idx + 1) % tc.save_steps == 0:
            save(step_idx + 1)
        step_idx += 1
    if checkpoint_dir and step_idx > start_step:
        save(step_idx)
    out = ungroup_layer_params(params)
    if shard is not None:
        out = shard.full(tree_map(torch.Tensor.detach, out))
    return out, history
