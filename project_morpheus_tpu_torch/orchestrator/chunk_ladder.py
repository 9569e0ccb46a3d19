"""Discrete adaptive chunk-size controller.

Functional parity with reference orchestrator/chunk_ladder.py: a ladder of
chunk sizes in adapter-native units; shallow playback buffer -> step up
(ask for bigger chunks to build margin), deep buffer -> step down (reduce
latency exposure).  Default ladder [8..64] matches the reference contract
(chunk_ladder.py:7) and the adapter capability descriptor granularity.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

DEFAULT_LADDER: List[int] = [8, 12, 16, 24, 32, 48, 64]


@dataclass
class ChunkLadder:
    ladder: List[int] = field(default_factory=lambda: list(DEFAULT_LADDER))
    index: int = 0

    @property
    def current(self) -> int:
        return self.ladder[self.index]

    def step_up(self) -> None:
        self.index = min(self.index + 1, len(self.ladder) - 1)

    def step_down(self) -> None:
        self.index = max(self.index - 1, 0)

    def reset(self) -> None:
        self.index = 0

    def adapt(self, depth_ms: float, band: Tuple[float, float]) -> None:
        low, high = band
        if depth_ms < low:
            self.step_up()
        elif depth_ms > high:
            self.step_down()
