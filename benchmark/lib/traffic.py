"""One general traffic generator, driven by a mix file (``mixes/*.json``).

Every seed gets the same multiset of request sizes, in another order,
and the same arrival times: sizes are the quantiles of the mix's
distributions at ``(i + 0.5) / n``, permuted by the seed (wholly, or with
``permute_block`` within blocks of a fixed order), and gaps the quantiles
of the exponential distribution in one fixed order, so two seeds differ
in which request comes when and in content, but not in the amount of
work or the schedule.  Prompts are token ids in the Orpheus layout
(``[start_of_human] text [end_of_text, end_of_human, start_of_ai,
start_of_speech]``), text ids drawn in [0, 128000); a clone prompt puts a
reference turn first, whose audio ids follow the 7-position band
pattern.  Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Dict, List

import numpy as np

START_OF_HUMAN, END_OF_TEXT, END_OF_HUMAN = 128259, 128009, 128260
START_OF_AI, END_OF_AI = 128261, 128262
START_OF_SPEECH, END_OF_SPEECH = 128257, 128258
AUDIO_BASE, CODEBOOK, FRAME_TOKENS = 128266, 4096, 7
TEXT_IDS = 128000
FRAME_S = 2048 / 24000  # audio seconds of one 7-token frame


@dataclasses.dataclass
class Item:
    """One planned request."""

    at: float                 # seconds after the window opens (open loop)
    prompt: List[int]
    frames: int               # output length: max_tokens = 7 * frames
    greedy: bool
    seed: int                 # the request's sampling seed

    @property
    def max_tokens(self) -> int:
        return FRAME_TOKENS * self.frames


def quantiles(spec: Dict, n: int) -> np.ndarray:
    """``n`` quantiles of a lognormal (``median``, ``sigma``) or uniform
    (``lo``, ``hi``) distribution, clipped to ``[min, max]`` and rounded."""
    u = (np.arange(n) + 0.5) / n
    if "median" in spec:
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        v = spec["median"] * np.exp(spec["sigma"] * z)
    else:
        v = spec["lo"] + u * (spec["hi"] - spec["lo"])
    return np.clip(np.rint(v), spec["min"], spec["max"]).astype(np.int64)


def _positions(n: int, rng, block: int) -> np.ndarray:
    """``range(n)`` permuted by the seed within consecutive blocks of
    ``block``."""
    pos = np.arange(n)
    for k in range(0, n, block):
        pos[k:k + block] = rng.permutation(pos[k:k + block])
    return pos


def _text(rng, n: int) -> List[int]:
    return rng.integers(0, TEXT_IDS, size=max(int(n), 0)).tolist()


def _turn(body: List[int]) -> List[int]:
    return [START_OF_HUMAN, *body, END_OF_TEXT, END_OF_HUMAN, START_OF_AI, START_OF_SPEECH]


def _prompts(mix: Dict, rng, n: int, pos) -> List[List[int]]:
    """Prompts in the seed's order: a whole permutation, or at ``pos``
    (each item's place in a fixed order)."""
    p = mix["prompt"]
    fixed = None if pos is None else np.random.default_rng(1).permutation(n)[pos]
    if p["kind"] == "text":  # the whole prompt's length, specials included
        lengths = quantiles(p["length"], n)
        lengths = rng.permutation(lengths) if fixed is None else lengths[fixed]
        return [_turn(_text(rng, L - 5)) for L in lengths]
    if p["kind"] == "clone":  # reference transcript + its audio, then the target
        # each reference length is paired with a target length the same way
        # for every seed, and the pairs are permuted: every seed sends the
        # same prompt lengths
        pairing = np.random.default_rng(0).permutation(n)
        order = rng.permutation(n) if fixed is None else fixed
        ref_s = quantiles(p["ref_audio_s"], n)[order]
        target = quantiles(p["target_text"], n)[pairing][order]
        out = []
        for secs, tl in zip(ref_s, target):
            frames = int(round(secs / FRAME_S))
            codes = rng.integers(0, CODEBOOK, size=frames * FRAME_TOKENS)
            audio = (AUDIO_BASE + (np.arange(codes.size) % FRAME_TOKENS) * CODEBOOK + codes)
            ref_text = _text(rng, round(secs * p["ref_text_tokens_per_s"]))
            out.append(_turn(ref_text) + audio.tolist() + [END_OF_SPEECH, END_OF_AI]
                       + _turn(_text(rng, tl)))
        return out
    raise ValueError(f"unknown prompt kind {p['kind']!r}")


def _items(mix: Dict, rng, n: int, ats) -> List[Item]:
    """With ``permute_block``, prompts and outputs keep fixed pairs in a
    fixed order, which the seed permutes within blocks of that many
    items, so every seed puts the same work into each stretch of the
    window; otherwise each is wholly permuted."""
    block = int(mix.get("permute_block", 0))
    pos = _positions(n, rng, block) if block > 0 else None
    prompts = _prompts(mix, rng, n, pos)
    frames = quantiles(mix["output_frames"], n)
    frames = rng.permutation(frames) if pos is None else \
        frames[np.random.default_rng(2).permutation(n)[pos]]
    every = mix["greedy_every"]
    seeds = rng.integers(0, 2**32, size=n)
    return [Item(float(ats[i]), prompts[i], int(frames[i]), i % every == 0, int(seeds[i]))
            for i in range(n)]


def arrival_offsets(rate: float, seconds: float) -> np.ndarray:
    """``round(rate * seconds)`` arrival offsets in ``[0, seconds)``:
    exponential gaps at their quantiles, in one fixed order, scaled to the
    window.  Every seed gets the same arrival times (the order of gaps sets
    the clumps that a tail waits behind, and changed the 90th percentile
    by up to 2.3x from seed to seed); the seed orders the requests."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps = np.random.default_rng(0x5EED).permutation(gaps)
    at = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return at * (seconds / gaps.sum())


def plan(mix: Dict, seed: int, seconds: float, slots: int) -> Dict:
    """The run's requests: ``{"loop": "open", "items": [...]}`` sorted by
    arrival, or ``{"loop": "closed", "clients": n, "burst": b, "items":
    pool}`` whose clients, in lockstep groups of ``b``, take the pool's
    items in turn."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0xB3C])
    arr = mix["arrival"]
    if mix["loop"] == "closed":
        clients = slots if arr["clients"] == "slots" else int(arr["clients"])
        return {"loop": "closed", "clients": clients, "burst": int(arr.get("burst", 1)),
                "stagger_s": float(arr.get("stagger_s", 0.0)),
                "items": _items(mix, rng, arr["pool"], np.zeros(arr["pool"]))}
    burst = int(arr.get("burst", 1))
    starts = arrival_offsets(arr["rate_per_s"], seconds)
    ats = np.repeat(starts, burst)
    return {"loop": "open", "items": _items(mix, rng, ats.size, ats)}


def prompt_range(mix: Dict) -> tuple:
    """The shortest and longest prompt the mix can draw (for warmup)."""
    p = mix["prompt"]
    if p["kind"] == "text":
        return p["length"]["min"], p["length"]["max"]
    lo_f = int(round(p["ref_audio_s"]["min"] / FRAME_S))
    hi_f = int(round(p["ref_audio_s"]["max"] / FRAME_S))
    fixed = 2 * 5 + 2
    lo = fixed + lo_f * 7 + round(p["ref_audio_s"]["min"] * p["ref_text_tokens_per_s"]) \
        + p["target_text"]["min"]
    hi = fixed + hi_f * 7 + round(p["ref_audio_s"]["max"] * p["ref_text_tokens_per_s"]) \
        + p["target_text"]["max"]
    return lo, hi


def longest_output_tokens(mix: Dict) -> int:
    return FRAME_TOKENS * int(mix["output_frames"]["max"])
