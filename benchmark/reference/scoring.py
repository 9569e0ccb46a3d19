"""What the check does with a reference's logits, whatever the decoder
family: fp32 with TF32 off, the scores the engine's sampler ranks, and the
widest gap of a served token below the best.  Every trunk carries the
Orpheus token space, so the audio bands are the same for all.  Imports
nothing of the program.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch

AUDIO_BASE, CODEBOOK, FRAME_TOKENS = 128266, 4096, 7


@contextlib.contextmanager
def exact_fp32(tf32: bool = False):
    """Run the block with TF32 off (or on, for a control), then restore."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def served_scores(lg: torch.Tensor, d: Dict, prompt: Sequence[int], served: Sequence[int],
                  penalty: float) -> torch.Tensor:
    """The scores the sampler ranks, for served token ``j`` at row ``j``:
    padding masked, the repetition penalty on every id seen before it
    (the prompt and the served tokens before ``j``), and everything outside
    the audio band of position ``j % 7`` masked."""
    n, Vp = lg.shape
    dev = lg.device
    seen = torch.zeros((n, Vp), dtype=torch.bool, device=dev)
    seen[:, torch.as_tensor(sorted(set(prompt)), device=dev)] = True
    if n > 1:
        tok = torch.as_tensor(served[: n - 1], device=dev)
        first = torch.zeros((n, Vp), dtype=torch.int32, device=dev)
        first[torch.arange(1, n, device=dev), tok] = 1
        seen |= first.cumsum(dim=0) > 0
    lane = torch.arange(Vp, device=dev)[None, :]
    s = torch.where(lane < d["V"], lg, torch.full_like(lg, float("-inf")))
    s = torch.where(seen, torch.where(s > 0, s / penalty, s * penalty), s)
    lo = AUDIO_BASE + (torch.arange(n, device=dev) % FRAME_TOKENS)[:, None] * CODEBOOK
    band = (lane >= lo) & (lane < lo + CODEBOOK)
    return torch.where(band, s, torch.full_like(s, float("-inf")))


def widest_gap(scores: torch.Tensor, tokens: Sequence[int]) -> float:
    """Largest ``best - score(token)`` over the rows; inf where a token is
    one the scores rule out."""
    dev = scores.device
    t = torch.as_tensor(list(tokens), device=dev)
    got = scores.gather(1, t[:, None])[:, 0]
    return float((scores.amax(dim=1) - got).max())
