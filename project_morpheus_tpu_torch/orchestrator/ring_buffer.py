"""Circular PCM byte buffer wired to playback-depth accounting.

Functional parity with reference orchestrator/ring_buffer.py: writes and
reads are in bytes; an attached PlaybackBuffer is credited/debited in
milliseconds (PCM16 mono at the configured sample rate).  Overflow writes
are truncated, mirroring the reference's bounded-write contract.
"""
from __future__ import annotations

from typing import Optional

from .buffer import PlaybackBuffer

BYTES_PER_SAMPLE = 2  # PCM16 mono


def bytes_to_ms(n: int, sample_rate: int) -> float:
    if sample_rate <= 0:
        return 0.0
    return n / BYTES_PER_SAMPLE / sample_rate * 1000.0


class RingBuffer:
    """With ``ORPHEUS_NATIVE_PCM=1`` the byte ring is backed by the
    compiled C++ pcm_ops ring (native.NativeRing, equivalence-tested in
    tests/test_torch_native.py); ms accounting stays host-side either way."""

    def __init__(
        self,
        capacity: int,
        sample_rate: int,
        playback: Optional[PlaybackBuffer] = None,
    ) -> None:
        from .. import native

        self.capacity = capacity
        self.sample_rate = sample_rate
        self.playback = playback
        self._native = native.NativeRing(capacity) if native.enabled() else None
        self._buf = bytearray(capacity)
        self._read = 0
        self._write = 0
        self._size = 0

    def __len__(self) -> int:
        if self._native is not None:
            return len(self._native)
        return self._size

    @property
    def free(self) -> int:
        return self.capacity - len(self)

    def write(self, data: bytes) -> int:
        """Append up to ``free`` bytes of ``data``; returns bytes written."""
        if self._native is not None:
            n = self._native.write(bytes(data))
        else:
            n = min(len(data), self.free)
            if n == 0:
                return 0
            first = min(n, self.capacity - self._write)
            self._buf[self._write : self._write + first] = data[:first]
            rest = n - first
            if rest:
                self._buf[:rest] = data[first:n]
            self._write = (self._write + n) % self.capacity
            self._size += n
        if n and self.playback is not None:
            self.playback.add(bytes_to_ms(n, self.sample_rate))
        return n

    def read(self, size: int) -> bytes:
        """Pop up to ``size`` bytes (playback consumption)."""
        if self._native is not None:
            out = self._native.read(size)
            if out and self.playback is not None:
                self.playback.consume(bytes_to_ms(len(out), self.sample_rate))
            return out
        n = min(size, self._size)
        if n <= 0:
            return b""
        first = min(n, self.capacity - self._read)
        out = bytes(self._buf[self._read : self._read + first])
        rest = n - first
        if rest:
            out += bytes(self._buf[:rest])
        self._read = (self._read + n) % self.capacity
        self._size -= n
        if self.playback is not None:
            self.playback.consume(bytes_to_ms(n, self.sample_rate))
        return out

    def reset(self) -> None:
        if self._native is not None:
            self._native.reset()
        self._read = self._write = self._size = 0
