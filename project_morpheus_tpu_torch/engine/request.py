"""Request objects for the serving engine."""
from __future__ import annotations

import asyncio
import enum
import itertools
from dataclasses import dataclass, field
from typing import AsyncGenerator, List, Optional

from ..model.sampling import SamplingParams

_req_counter = itertools.count()


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    CANCELLED = "cancelled"


@dataclass
class Request:
    """One utterance generation request tracked by the engine."""

    prompt_ids: List[int]
    sampling: SamplingParams
    request_id: int = field(default_factory=lambda: next(_req_counter))
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    generated: int = 0
    ctx_len: int = 0  # prompt tokens actually written at prefill (clamped)
    # total generation budget (max_tokens clamped by context headroom),
    # fixed at admission and enforced BOTH host-side (_deliver) and
    # device-side (engine._post_step countdown) so they stay in lockstep
    allowed: int = 1 << 30
    # Unbounded: the device never blocks on a slow consumer; backpressure
    # is applied by the orchestrator's pull loop instead.
    token_queue: "asyncio.Queue[Optional[int]]" = field(
        default_factory=asyncio.Queue
    )
    # audio mode (engine-side batched SNAC decode): PCM16 byte hops
    audio: bool = False
    audio_pos: int = 0
    planner: Optional[object] = None  # stream_decode.StreamPlanner (audio mode)
    pcm_queue: "asyncio.Queue[Optional[bytes]]" = field(
        default_factory=asyncio.Queue
    )
    # set by the engine at submit: called after every consumer get() so a
    # backpressure-parked loop wakes as soon as its queues drain
    on_drain: Optional[object] = None
    # lazily-built union of per-request + engine-default stop ids
    stop_set: Optional[set] = None

    def _drained(self) -> None:
        if self.on_drain is not None:
            self.on_drain()

    async def tokens(self) -> AsyncGenerator[int, None]:
        """Async stream of generated token ids (None sentinel = EOS)."""
        while True:
            tok = await self.token_queue.get()
            self._drained()
            if tok is None:
                return
            yield tok

    async def pcm_chunks(self) -> AsyncGenerator[bytes, None]:
        """Async stream of PCM16 hops (audio mode only)."""
        while True:
            chunk = await self.pcm_queue.get()
            self._drained()
            if chunk is None:
                return
            yield chunk

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED)
