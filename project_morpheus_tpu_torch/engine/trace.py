"""The engine's in-memory trace: spans, device stage stamps and lane counts.

Off by default: ``OrpheusEngine.trace`` is None until ``start_trace()``;
while it is off each instrumented site of the engine costs one ``is None``
check, and no frame program captured then takes a stamp.  While it is on,
everything stays in memory (nothing is written or printed):

- **Spans** ``(name, start_ns, end_ns, parent, request_id)`` on
  ``time.perf_counter_ns()``; ``parent`` is the ``id`` of the span that
  caused it.  Each request has a ``request`` span, from ``submit`` to its
  end of stream, and three contiguous children under its ``request_id``:
  ``request.queue`` (submit to its slot), ``request.prefill`` (to its final
  prefill round issued) and ``request.first_hop`` (to its first PCM hop
  put on its queue); they sum to its submit-to-first-hop interval.  The
  loop's spans (``engine.turn``, ``engine.admit``, ``engine.gate``,
  ``engine.dispatch`` with ``engine.stage_inputs`` and ``engine.replay``,
  ``engine.readback_issue``, ``engine.prefill_round``,
  ``engine.readback_wait``, ``engine.route``, ``engine.flush_audio``,
  ``engine.park``) nest as the code runs them, and each is also entered as
  a ``torch.profiler.record_function`` range of its name, so a profiler
  trace puts them on the card's clock.  On the card, ``engine.prefill_round``
  also records CUDA events around its device work (``device_seconds``).
- **Device stages**: a frame program captured while the trace is on marks
  each stage boundary with ``ops/stamp.py`` (the card's global timer, in
  stream order; the host clock on the CPU) into a buffer that rides the
  frame's readback.  ``stage_ns`` assigns each interval between two marks
  to the stage named by the mark that ends it (``MARKS``), so a frame's
  stages sum to its first-to-last mark: attention (each layer's attention
  branch), trunk (the rest of the decode step: embedding, norms,
  projections, MLP, head), sampling (band mask, sampler, gather),
  bookkeeping (the step's state updates, stop and budget, the code ring)
  and the SNAC hop.
- **Counters**: ``lanes_decoded`` (steps x ``max_slots`` of each routed
  frame) and ``lanes_emitted`` (the tokens routed from them);
  ``attn_kernel_frames`` and ``attn_dense_frames``, the frames dispatched
  whose decode attention resolved to the CUDA kernels or to the dense
  branch (``OrpheusEngine._attn_for``); ``trunk_kernel_frames`` and
  ``trunk_plain_frames``, the frames dispatched whose decode steps ran
  the whole elementwise chain between the projections as the trunk
  kernels of ``ops/decode_trunk.py``, or some of it as plain ops
  (``OrpheusEngine._trunk_path``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.stamp import stamp as _stamp

# each mark of a frame program, with the stage of the interval it ends
MARKS = {
    "frame": "bookkeeping",   # a frame phase starts
    "step": "bookkeeping",    # a decode step starts
    "attn_in": "trunk",       # a layer's attention branch starts
    "attn_out": "attention",  # ... and ends
    "trunk": "trunk",         # the step's logits are out
    "sampled": "sampling",    # band mask, sampler and gather done
    "bookkept": "bookkeeping",  # state, stop and budget, code ring done
    "snac": "snac",           # the frame's SNAC hop and its PCM done
    "end": "bookkeeping",     # the program's outputs stacked
}
CODES = {name: i for i, name in enumerate(MARKS)}
STAGES = ("attention", "trunk", "sampling", "bookkeeping", "snac")
_STAGE_OF_CODE = np.array([STAGES.index(s) for s in MARKS.values()])
REQUEST_PHASES = ("request.queue", "request.prefill", "request.first_hop")


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    request_id: Optional[int]
    id: int
    events: Optional[tuple] = None  # CUDA events around the span's device work


class Stamps:
    """A frame program's marks: ``stamps(mark)`` writes the mark's code and
    the time into the next row of an int64 ``(capacity, 2)`` buffer."""

    def __init__(self, capacity: int, device: torch.device) -> None:
        self.buf = torch.empty((capacity, 2), dtype=torch.int64, device=device)
        self.n = 0

    def __call__(self, mark: str) -> None:
        _stamp(self.buf, self.n, CODES[mark])
        self.n += 1

    def taken(self) -> torch.Tensor:
        return self.buf[:self.n]


def stage_ns(stamps: np.ndarray) -> Dict[str, int]:
    """ns of each stage (``STAGES``) between the first and the last row of
    a program's ``(n, 2)`` marks, and ``frames``, its frame phases."""
    codes, t = stamps[:, 0], stamps[:, 1]
    stage = _STAGE_OF_CODE[codes[1:]]
    d = np.diff(t)
    out = {s: int(d[stage == i].sum()) for i, s in enumerate(STAGES)}
    out["frames"] = int((codes == CODES["frame"]).sum())
    return out


def device_seconds(spans: List[Span]) -> float:
    """Device seconds between the CUDA events of ``spans`` (waits for the
    card); spans without events count 0."""
    timed = [s for s in spans if s.events is not None]
    if timed:
        timed[-1].events[1].synchronize()
    return sum(s.events[0].elapsed_time(s.events[1]) for s in timed) / 1e3


class EngineTrace:
    """Spans, device stages a routed frame (``frames``: ``stage_ns`` dicts)
    and ``counters``, kept in memory; ``clear()`` empties them."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.spans: List[Span] = []
        self.frames: List[Dict[str, int]] = []
        self.counters: collections.Counter = collections.Counter()
        self._ids = itertools.count()
        self._stack: List[Span] = []
        # request_id -> [request span, start of its open phase, phases closed]
        self._requests: Dict[int, list] = {}

    def clear(self) -> None:
        """Drop everything recorded so far (requests in flight included)."""
        self.spans.clear()
        self.frames.clear()
        self.counters.clear()
        self._requests.clear()

    def _add(self, name, start, end, parent, request_id) -> Span:
        s = Span(name, start, end, parent, request_id, next(self._ids))
        self.spans.append(s)
        return s

    @contextlib.contextmanager
    def span(self, name: str, device: bool = False):
        """A loop span around the block, inside the innermost one open, and
        a profiler range of the same name; ``device`` also records CUDA
        events around the block's device work (on the card)."""
        s = self._add(name, time.perf_counter_ns(), None,
                      self._stack[-1].id if self._stack else None, None)
        self._stack.append(s)
        if device and self.device.type == "cuda":
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record()
        try:
            with torch.profiler.record_function(name):
                yield s
        finally:
            if s.events is not None:
                s.events[1].record()
            s.end_ns = time.perf_counter_ns()
            self._stack.pop()

    # ------------------------------------------------------------ requests

    def request_start(self, req) -> None:
        now = time.perf_counter_ns()
        span = self._add("request", now, None, None, req.request_id)
        self._requests[req.request_id] = [span, now, 0]

    def request_phase(self, req, phase: str) -> None:
        """Close the request's open phase if it is ``phase`` (a later call
        for a phase already closed does nothing)."""
        st = self._requests.get(req.request_id)
        if st is None or st[2] >= len(REQUEST_PHASES) or REQUEST_PHASES[st[2]] != phase:
            return
        now = time.perf_counter_ns()
        self._add(phase, st[1], now, st[0].id, req.request_id)
        st[1] = now
        st[2] += 1

    def request_end(self, req) -> None:
        st = self._requests.pop(req.request_id, None)
        if st is not None:
            st[0].end_ns = time.perf_counter_ns()

    # -------------------------------------------------------------- frames

    def note_frame(self, lanes: int, emitted: int, stamps: Optional[np.ndarray]) -> None:
        """One routed frame: its lanes decoded and tokens routed, and its
        device stages where its program took stamps."""
        self.counters["lanes_decoded"] += lanes
        self.counters["lanes_emitted"] += emitted
        if stamps is not None and len(stamps) > 1:
            self.frames.append(stage_ns(stamps))
