"""Audio watermarking: key-seeded embed + blind verify (port of
utils/watermark.py, numpy only: outputs equal the JAX package's).

Capability parity with the reference's SilentCipher integration
(Orpheus-TTS/additional_inference_options/watermark_audio/watermark.py:
embed at 44.1 kHz with key [121,124,146,56,201], resample 24k<->44.1k,
verify round-trip).  SilentCipher is a closed neural codec; this
implementation is a classical spread-spectrum watermark — a key-seeded
pseudo-noise sequence shaped to sit ~40 dB under the signal, detected
by correlating against the regenerated sequence — which keeps the same
API surface (embed(key), verify(key) -> bool/confidence) without a
model dependency.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_KEY: Tuple[int, ...] = (121, 124, 146, 56, 201)  # reference key
_CHIP_RATE = 4  # samples per PN chip
_STRENGTH_DB = -36.0


def _pn_sequence(key: Sequence[int], n: int) -> np.ndarray:
    seed = int(np.sum(np.asarray(list(key), dtype=np.int64) * 1009) % (2**31))
    rng = np.random.default_rng(seed)
    chips = rng.integers(0, 2, size=(n // _CHIP_RATE + 1,)) * 2 - 1
    return np.repeat(chips, _CHIP_RATE)[:n].astype(np.float32)


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler (24k<->44.1k round trips in reference)."""
    if sr_in == sr_out:
        return audio
    n_out = int(round(len(audio) * sr_out / sr_in))
    x_in = np.arange(len(audio), dtype=np.float64) / sr_in
    x_out = np.arange(n_out, dtype=np.float64) / sr_out
    return np.interp(x_out, x_in, audio).astype(audio.dtype)


def embed(
    audio: np.ndarray,
    key: Sequence[int] = DEFAULT_KEY,
    sample_rate: int = 24_000,
) -> np.ndarray:
    """Embed the watermark; accepts float [-1,1] or int16, returns same kind."""
    is_int = np.issubdtype(audio.dtype, np.integer)
    x = audio.astype(np.float32) / 32767.0 if is_int else audio.astype(np.float32)
    pn = _pn_sequence(key, len(x))
    rms = float(np.sqrt(np.mean(x**2))) or 1e-4
    amp = rms * (10.0 ** (_STRENGTH_DB / 20.0))
    y = np.clip(x + amp * pn, -1.0, 1.0)
    if is_int:
        return (y * 32767.0).astype(np.int16)
    return y


def detect(
    audio: np.ndarray,
    key: Sequence[int] = DEFAULT_KEY,
    sample_rate: int = 24_000,
) -> float:
    """Blind detection: normalised correlation against the key's PN sequence.

    Returns a z-score-like confidence; > ~5 indicates presence.
    """
    x = (
        audio.astype(np.float32) / 32767.0
        if np.issubdtype(audio.dtype, np.integer)
        else audio.astype(np.float32)
    )
    if len(x) < _CHIP_RATE * 8:
        return 0.0
    pn = _pn_sequence(key, len(x))
    # whiten: first difference suppresses the (correlated) host signal
    dx = np.diff(x)
    dpn = np.diff(pn)
    denom = np.linalg.norm(dx) * np.linalg.norm(dpn)
    if denom == 0:
        return 0.0
    corr = float(np.dot(dx, dpn) / denom)
    return corr * np.sqrt(len(dx))


def verify(
    audio: np.ndarray,
    key: Sequence[int] = DEFAULT_KEY,
    sample_rate: int = 24_000,
    threshold: float = 5.0,
) -> bool:
    return detect(audio, key, sample_rate) >= threshold
