"""Playback-depth accounting in milliseconds.

Functional parity with reference orchestrator/buffer.py: a passive counter
the controller reads; capacity is advisory, not enforced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class PlaybackBuffer:
    capacity_ms: float
    depth_ms: float = 0.0

    def add(self, duration_ms: float) -> None:
        self.depth_ms += duration_ms

    def consume(self, duration_ms: float) -> None:
        self.depth_ms = max(0.0, self.depth_ms - duration_ms)

    def reset(self) -> None:
        self.depth_ms = 0.0

    def within(self, band: Tuple[float, float]) -> bool:
        low, high = band
        return low <= self.depth_ms <= high
