"""Throughput monitoring (port of utils/perf.py; reference inference.py:170-207).

Tracks token and chunk rates and the realtime factor implied by the
85.3 ms-per-hop contract; reports at a fixed interval via a callback
(print by default).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

SECONDS_PER_CHUNK = 0.085  # 2048 samples @ 24 kHz


class PerformanceMonitor:
    def __init__(
        self,
        report_interval_s: float = 2.0,
        emit: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.report_interval_s = report_interval_s
        self.emit = emit or print
        self.start = time.monotonic()
        self.tokens = 0
        self.chunks = 0
        self._last_report = self.start

    def add_tokens(self, n: int = 1) -> None:
        self.tokens += n
        self._maybe_report()

    def add_chunks(self, n: int = 1) -> None:
        self.chunks += n
        self._maybe_report()

    @property
    def elapsed(self) -> float:
        return max(time.monotonic() - self.start, 1e-9)

    def stats(self) -> dict:
        est_audio_s = self.chunks * SECONDS_PER_CHUNK
        return {
            "elapsed_s": self.elapsed,
            "tokens": self.tokens,
            "chunks": self.chunks,
            "tokens_per_s": self.tokens / self.elapsed,
            "chunks_per_s": self.chunks / self.elapsed,
            "est_audio_s": est_audio_s,
            "realtime_factor": est_audio_s / self.elapsed,
        }

    def _maybe_report(self) -> None:
        now = time.monotonic()
        if now - self._last_report >= self.report_interval_s:
            s = self.stats()
            self.emit(
                f"perf: {s['tokens_per_s']:.1f} tok/s, {s['chunks_per_s']:.2f} "
                f"chunks/s, {s['realtime_factor']:.2f}x realtime"
            )
            self._last_report = now
