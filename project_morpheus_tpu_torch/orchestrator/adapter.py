"""The adapter protocol: the seam between orchestration and synthesis.

Functional parity with reference orchestrator/adapter.py:13-60.  An adapter
must return *promptly* from ``pull`` with at most ``chunk_size`` units
(PCM bytes for waveform adapters) — never blocking for a whole utterance —
and must fully discard in-flight state on ``reset`` (the barge-in path).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable


@dataclass
class AudioChunk:
    """One pulled unit of audio.

    ``pcm`` is PCM16 mono little-endian bytes; ``duration_ms`` its length in
    milliseconds; ``markers`` optional backend metadata (word boundaries,
    adapter identity, ...); ``eos`` marks end of the current utterance.
    """

    pcm: bytes
    duration_ms: float
    markers: Optional[object] = None
    eos: bool = False


@runtime_checkable
class TTSAdapter(Protocol):
    """Pull-based synthesis backend.

    ``pull(chunk_size)`` returns the next chunk with ``len(pcm) <=
    chunk_size`` bytes; it may return fewer (or empty with ``eos``) but must
    not wait for the full utterance.  ``reset()`` aborts the in-flight
    utterance and clears all internal buffers (observed only at chunk
    boundaries — the frame-boundary barge-in contract).
    """

    async def pull(self, chunk_size: int) -> AudioChunk: ...

    async def reset(self) -> None: ...
