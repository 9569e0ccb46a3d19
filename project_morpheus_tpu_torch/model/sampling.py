"""Sampling over the Orpheus 156k-token vocab (port of model/sampling.py).

Per-slot temperature / top-p / repetition penalty as tensors, so one step
serves a batch of requests with different settings.  The nucleus is found
by the same 24-step bisection on the kept probability mass as the JAX
package (not a sort), so both select the same token sets.  Categorical
draws are Gumbel-max with noise from each slot's own ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch


@dataclasses.dataclass
class SamplingParams:
    """Host-side per-request sampling configuration."""

    temperature: float = 0.6
    top_p: float = 0.9
    repetition_penalty: float = 1.1
    max_tokens: int = 8192
    stop_token_ids: Sequence[int] = (128258,)
    # per-request seed: the slot's generator is seeded with it, so a seeded
    # request's trace does not depend on co-batched traffic
    seed: Optional[int] = None

    def clipped(self) -> "SamplingParams":
        """Range clamps mirroring the server's /config validation."""
        return dataclasses.replace(
            self,
            temperature=min(max(self.temperature, 0.0), 1.5),
            top_p=min(max(self.top_p, 1e-3), 1.0),
            repetition_penalty=max(self.repetition_penalty, 1.0),
        )


def penalized_logits(logits, *, repetition_penalty, presence, vocab_size):
    """Mask the vocab padding and apply the repetition penalty to seen ids."""
    Vp = logits.shape[1]
    lane = torch.arange(Vp, device=logits.device)[None, :]
    logits = torch.where(lane < vocab_size, logits, torch.full_like(logits, -torch.inf))
    pen = repetition_penalty[:, None]
    penalised = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(presence, penalised, logits)


def nucleus_logits(scaled: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Top-p filter by bisection: keep ids whose probability is >= tau, the
    largest threshold whose kept mass still covers ``top_p``."""
    probs = torch.softmax(scaled, dim=-1)
    lo = torch.zeros_like(top_p)
    hi = probs.amax(dim=-1)
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs >= mid[:, None], probs, torch.zeros_like(probs)).sum(dim=-1)
        keep = mass >= top_p
        lo = torch.where(keep, mid, lo)
        hi = torch.where(keep, hi, mid)
    return torch.where(probs >= lo[:, None], scaled, torch.full_like(scaled, -torch.inf))


def gumbel_noise(shape_v: int, generators: List[Optional[torch.Generator]],
                 device) -> torch.Tensor:
    """(B, V) Gumbel noise; row b draws from ``generators[b]``, or is zero
    when that entry is None (the lane draws nothing this step)."""
    rows = []
    for g in generators:
        if g is None:
            rows.append(torch.zeros(shape_v, device=device))
        else:
            u = torch.rand(shape_v, generator=g, device=device)
            rows.append(-torch.log(-torch.log(torch.clamp(u, min=1e-20))))
    return torch.stack(rows)


def sample_logits(
    logits: torch.Tensor,         # (B, padded_vocab) fp32
    generators: List[Optional[torch.Generator]],  # per-slot; None: no draw
    *,
    temperature: torch.Tensor,    # (B,)
    top_p: torch.Tensor,          # (B,)
    repetition_penalty: torch.Tensor,  # (B,)
    presence: torch.Tensor,       # (B, padded_vocab) bool
    vocab_size: int,
) -> torch.Tensor:
    """One token per slot; temperature <= 0 selects greedy argmax."""
    logits = penalized_logits(logits, repetition_penalty=repetition_penalty,
                              presence=presence, vocab_size=vocab_size)
    greedy = logits.argmax(dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-4)[:, None]
    nucleus = nucleus_logits(scaled, top_p)
    noise = gumbel_noise(logits.shape[1], generators, logits.device)
    sampled = (nucleus + noise).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
