"""Sampling over the Orpheus 156k-token vocab (port of model/sampling.py).

Per-slot temperature / top-p / repetition penalty as tensors, so one step
serves a batch of requests with different settings.  The nucleus is found
by the same 24-step bisection on the kept probability mass as the JAX
package (not a sort), so both select the same token sets.  Categorical
draws are Gumbel-max with noise from a counter-based generator: the
uniform bits of slot ``b`` are a pure integer function of
``(seeds[b], draws[b], vocab index)`` held in device tensors, so a draw
needs no host state and runs unchanged inside a captured CUDA graph.  The
caller advances ``draws[b]`` on the steps where lane ``b`` emits, as the
JAX engine advances each slot's key chain.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch


@dataclasses.dataclass
class SamplingParams:
    """Host-side per-request sampling configuration."""

    temperature: float = 0.6
    top_p: float = 0.9
    repetition_penalty: float = 1.1
    max_tokens: int = 8192
    stop_token_ids: Sequence[int] = (128258,)
    # per-request seed: it fixes the slot's random stream, so a seeded
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


def init_sampler_state(batch: int, padded_vocab: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Per-slot state: which token ids each slot has seen."""
    return {"presence": torch.zeros(batch, padded_vocab, dtype=torch.bool, device=device)}


def note_tokens(state: Dict[str, torch.Tensor], tokens: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Mark ``tokens`` (B,) or (B, S) as seen in a new state; ``mask``
    excludes padding.  A token marks its slot when any of its masked-in
    occurrences does (the JAX scatter leaves a token that a row holds both
    masked in and masked out to the order of its writes)."""
    presence = state["presence"].clone()
    if tokens.ndim == 1:
        tokens = tokens[:, None]
    rows = torch.arange(presence.shape[0], device=presence.device)[:, None].expand(tokens.shape)
    if mask is None:
        presence[rows, tokens.long()] = True
    else:
        presence[rows[mask], tokens.long()[mask]] = True
    return {"presence": presence}


def reset_slots(state: Dict[str, torch.Tensor], slot_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A new state with the presence of the slots in ``slot_mask`` cleared."""
    return {"presence": state["presence"] & ~slot_mask[:, None]}


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


# ------------------------------------------------------ counter-based bits

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the constant is
    split in 16-bit halves so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche mix (xorshift-multiply, two rounds)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_bits(seeds: torch.Tensor, draws: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) int64 in [0, 2**32): bits of draw ``draws[b]`` of the stream
    ``seeds[b]`` (both int64 >= 0), one word per vocab index.

    Only integer adds, multiplies, shifts and xors on int64 tensors whose
    values stay below 2**49, so the CPU and the card compute the same bits."""
    s = seeds.long()
    key = _mix32((s & _M32) ^ _mix32(((s >> 32) & _M32) ^ 0x9E3779B9))
    key = _mix32(key ^ _mul32(draws.long() & _M32, 0x85EBCA6B))
    idx = torch.arange(n, device=seeds.device, dtype=torch.int64)
    return _mix32(_mix32(key[:, None] ^ _mul32(idx, 0xC2B2AE35)[None, :]) ^ 0x27D4EB2F)


def gumbel_noise(seeds: torch.Tensor, draws: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) Gumbel noise from :func:`uniform_bits`: 24 bits make a uniform
    in (0, 1) exactly; the logs round as float32 does on each device."""
    u = ((uniform_bits(seeds, draws, n) >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_logits(
    logits: torch.Tensor,         # (B, padded_vocab) fp32
    seeds: torch.Tensor,          # (B,) int64 per-slot stream
    draws: torch.Tensor,          # (B,) int64 per-slot draw counter
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
    noise = gumbel_noise(seeds, draws, logits.shape[1])
    sampled = (nucleus + noise).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
