"""LoRA adapters for the decoder (port of training/lora.py).

Defaults mirror the reference recipe: r=32, alpha=64, adapters on every
projection matrix (q/k/v/o/gate/up/down), rslora scaling
(alpha / sqrt(r)), optional trainable embedding, and merge-and-unload
export producing plain dense weights.  Adapters are fp32 over a frozen
base of any dtype; the base takes no gradient and stays bit-identical.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..model.config import LlamaConfig

PROJ_NAMES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def _proj_dims(cfg: LlamaConfig) -> Dict[str, Tuple[int, int]]:
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, KV, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": (D, H * HD), "wk": (D, KV * HD), "wv": (D, KV * HD), "wo": (H * HD, D),
            "wg": (D, F), "wu": (D, F), "wd": (F, D)}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 32
    alpha: float = 64.0
    rslora: bool = True  # scale alpha / sqrt(r) instead of alpha / r
    train_embed: bool = False


def lora_scale(lc: LoraConfig) -> float:
    return lc.alpha / (math.sqrt(lc.rank) if lc.rslora else lc.rank)


@torch.no_grad()
def init_lora_params(cfg: LlamaConfig, lc: LoraConfig, seed: int = 0, device="cuda",
                     dtype: torch.dtype = torch.float32) -> Dict:
    """Gaussian ``a`` (scaled by 1/sqrt(fan_in)) and zero ``b`` per
    projection, stacked over layers, so the delta starts at 0.  Drawn from
    a seeded torch generator on ``device`` (not ``jax.random``'s numbers;
    tests carry JAX's adapters across with ``model/bridge.py``)."""
    L = cfg.num_layers
    g = torch.Generator(device=device).manual_seed(seed)
    layers: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, (fan_in, fan_out) in _proj_dims(cfg).items():
        a = torch.randn((L, fan_in, lc.rank), generator=g, device=device) / math.sqrt(fan_in)
        layers[name] = {"a": a.to(dtype),
                        "b": torch.zeros((L, lc.rank, fan_out), dtype=dtype, device=device)}
    out: Dict = {"layers": layers}
    if lc.train_embed:
        out["embed_delta"] = torch.zeros((cfg.padded_vocab, cfg.hidden_size), dtype=dtype,
                                         device=device)
    return out


@torch.no_grad()
def merge_lora(params: Dict, lora: Dict, lc: LoraConfig) -> Dict:
    """Merge-and-unload: dense stacked weights absorbing the low-rank
    deltas (``W + scale * A @ B`` in fp32, rounded to W's dtype)."""
    s = lora_scale(lc)
    layers = dict(params["layers"])
    for name in PROJ_NAMES:
        if name not in lora["layers"]:
            continue
        a, b = lora["layers"][name]["a"].float(), lora["layers"][name]["b"].float()
        w = params["layers"][name]
        layers[name] = (w.float() + s * torch.einsum("ldr,lro->ldo", a, b)).to(w.dtype)
    merged = dict(params)
    merged["layers"] = layers
    if "embed_delta" in lora:
        merged["embed"] = (params["embed"].float() + lora["embed_delta"]).to(params["embed"].dtype)
    return merged


def make_lora_train_step(cfg: LlamaConfig, lc: LoraConfig, optimizer):
    """``step(lora, opt_state, params, batch) -> (lora, opt_state, loss)``:
    one update of the adapters in ``opt_state`` (``optimizer.init(lora)``),
    the base ``params`` frozen.  JAX's step runs the dense attention without
    recompute, and so does this one."""
    from .pretrain import causal_lm_loss

    s = lora_scale(lc)

    def step(lora, opt_state, params, batch):
        loss = causal_lm_loss(params, batch, cfg, lora=lora, lora_scale=s)
        optimizer.update(torch.autograd.grad(loss, opt_state.leaves, materialize_grads=True),
                         opt_state)
        return lora, opt_state, loss.detach()

    return step
