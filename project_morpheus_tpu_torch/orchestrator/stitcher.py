"""Crossfade stitcher for adapter chunk streams.

Functional parity with reference orchestrator/stitcher.py:10-79: joins an
async stream of AudioChunks by overlap-add with linear fades, holding back
the last ``overlap_ms`` of each chunk until its successor arrives, with a
drift guard (never overlap more samples than either side has) and an EOS
tail flush.  ``overlap_ms=0`` degenerates to pass-through concat — the
serving default (reference server.py:154-156).
"""
from __future__ import annotations

from typing import AsyncGenerator, AsyncIterator, Optional

import numpy as np

from .adapter import AudioChunk


def _fade(n: int, rising: bool) -> np.ndarray:
    ramp = np.arange(n, dtype=np.float32) / n
    return ramp if rising else 1.0 - ramp


def crossfade(tail: np.ndarray, head: np.ndarray, overlap: int) -> np.ndarray:
    """Overlap-add ``tail`` into ``head``; returns the joined int16 array.

    With ``ORPHEUS_NATIVE_PCM=1`` the join runs in the compiled C++
    pcm_ops library (native.crossfade_join, equivalence-tested against
    this implementation in tests/test_torch_native.py); the Python path is the
    default and the oracle.
    """
    from .. import native

    if native.enabled():
        return native.crossfade_join(tail, head, overlap)
    ov = min(overlap, tail.size, head.size)
    if ov <= 0:
        return np.concatenate([tail, head])
    mixed = (
        tail[-ov:].astype(np.float32) * _fade(ov, rising=False)
        + head[:ov].astype(np.float32) * _fade(ov, rising=True)
    )
    mixed = np.clip(mixed, -32768, 32767).astype(np.int16)
    return np.concatenate([tail[:-ov], mixed, head[ov:]])


async def stitch_chunks(
    chunks: AsyncIterator[AudioChunk],
    *,
    sample_rate: int,
    overlap_ms: float = 0.0,
    emit_markers: bool = False,
) -> AsyncGenerator[AudioChunk, None]:
    overlap = int(overlap_ms * sample_rate / 1000.0)
    tail: Optional[np.ndarray] = None

    def emit(pcm: np.ndarray, markers, eos: bool) -> AudioChunk:
        return AudioChunk(
            pcm=pcm.astype("<i2").tobytes(),
            duration_ms=pcm.size / sample_rate * 1000.0,
            markers=markers if emit_markers else None,
            eos=eos,
        )

    async for chunk in chunks:
        pcm = np.frombuffer(chunk.pcm, dtype=np.int16)
        if tail is not None and tail.size:
            pcm = crossfade(tail, pcm, overlap)
        if chunk.eos:
            yield emit(pcm, chunk.markers, eos=True)
            return
        if overlap > 0:
            if pcm.size <= overlap:
                tail = pcm  # too small to emit; carry whole chunk forward
                continue
            tail = pcm[-overlap:]
            pcm = pcm[:-overlap]
        else:
            tail = None
        yield emit(pcm, chunk.markers, eos=False)

    if tail is not None and tail.size:
        # stream ended without explicit EOS: flush the held-back tail
        yield emit(tail, None, eos=True)
