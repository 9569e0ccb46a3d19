"""Offline WAV utilities: write, read, crossfade-stitch files.

Parity with reference inference.py:294-365 (``stitch_wav_files`` with 50 ms
crossfade) and the ad-hoc WAV writers scattered through the reference.
"""
from __future__ import annotations

import wave
from pathlib import Path
from typing import List, Sequence

import numpy as np

from ..orchestrator.stitcher import crossfade


def write_wav(path, pcm: np.ndarray, sample_rate: int = 24_000) -> None:
    pcm = np.ascontiguousarray(pcm, np.int16)
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())


def read_wav(path) -> tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as wf:
        sr = wf.getframerate()
        data = wf.readframes(wf.getnframes())
    return np.frombuffer(data, np.int16), sr


def stitch_wav_files(
    input_files: Sequence, output_file, crossfade_ms: float = 50.0
) -> int:
    """Join WAV files with linear crossfades; returns output sample count."""
    if not input_files:
        return 0
    segments: List[np.ndarray] = []
    sample_rate = 24_000
    for f in input_files:
        pcm, sample_rate = read_wav(f)
        segments.append(pcm)
    overlap = int(crossfade_ms * sample_rate / 1000.0)
    out = segments[0]
    for seg in segments[1:]:
        out = crossfade(out, seg, overlap)
    write_wav(output_file, out, sample_rate)
    return out.size
