"""What a ``--trace 1`` run reads, from the benchmark's own files.

Wrappers on the engine instance (after its warmup) around the calls into
each layer, as ``tools/profile_serving.py``'s ``_wrap`` and
``round_timer`` put them (copied here):

- ``_dispatch_frame``: host seconds a dispatch (a graph replay and its
  readback copies);
- ``_run_program``: CUDA events before and after each frame program, its
  device time, and its width ``k`` (frames);
- ``_prefill_round``: CUDA events before and after each round, its width
  ``J``, chunk length and each job's offset and real tokens;
- ``_process_frame``: each routed frame's emitted tokens and the keys
  each one's decode step attended (ctx_len + tokens generated before it);
- ``_advance_prefill``: a named range only.

Each wrapper also opens a ``record_function`` range named
``bench.<method>``, so that the device trace can say what the host was
doing in an idle gap.  One slice of ``slice_s`` seconds, at the window's
end or where the mix's ``trace_slice_start_s`` puts it, runs under
``torch.profiler`` (CPU ranges and CUDA
activity, raw Kineto events, no chrome trace written), bounded by a
device synchronisation on both sides so that every kernel a call in it
launched ran in it.  If a later change renames a wrapped method, the
wrapper raises here: a metric it feeds is then missing, never zero.
"""
from __future__ import annotations

import asyncio
import collections
import time
from typing import Dict, List

import torch

from .stats import idle_gaps, span_union_s

WRAPPED = ("_dispatch_frame", "_run_program", "_prefill_round", "_process_frame",
           "_advance_prefill")


class Tracer:
    def __init__(self, engine, slice_s: float, slice_start_s=None) -> None:
        self.engine = engine
        self.slice_s = slice_s
        # seconds into the window where the slice starts (None: it ends
        # as the window closes)
        self.slice_start_s = slice_start_s
        self.cuda = engine.device.type == "cuda"
        self.in_window = False
        self.in_slice = False
        self.dispatch_host_s: List[float] = []
        self.frames: List[Dict] = []     # {"k", "ev", "slice"} in dispatch order
        self.rounds: List[Dict] = []     # {"J", "clen", "jobs", "ev", "slice"}
        self.tokens: List[Dict] = []     # {"keys": [...], "slice"} a routed frame
        self._routed = 0
        self.trace: Dict = {}
        for name in WRAPPED:
            if not callable(getattr(engine, name, None)):
                raise AttributeError(f"engine has no method {name}: the tracer's wrappers "
                                     "need it")
            setattr(engine, name, self._wrap(name, getattr(engine, name)))

    def _events(self):
        if not self.cuda:
            return None
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        return a, b

    def _wrap(self, name: str, fn):
        label = "bench." + name.lstrip("_")

        def wrapped(*a, **k):
            if not self.in_window:
                return fn(*a, **k)
            with torch.profiler.record_function(label):
                return getattr(self, "_" + name.lstrip("_"))(fn, *a, **k)

        return wrapped

    def _dispatch_frame(self, fn, *a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            self.dispatch_host_s.append(time.perf_counter() - t)

    def _run_program(self, fn, bucket, k, audio):
        ev = self._events()
        try:
            return fn(bucket, k, audio)
        finally:
            if ev is not None:
                ev[1].record()
            self.frames.append({"k": k, "ev": ev, "slice": self.in_slice})

    def _prefill_round(self, fn, group, clen, hist, final):
        jobs = [(j["offset"], max(0, min(clen, len(j["ids"]) - j["offset"]))) for j in group]
        ev = self._events()
        try:
            return fn(group, clen, hist, final)
        finally:
            if ev is not None:
                ev[1].record()
            self.rounds.append({"J": len(group), "clen": clen, "jobs": jobs, "ev": ev,
                                "slice": self.in_slice})

    def _process_frame(self, fn, slot_map, firsts, host):
        first_slots = {f[0] for f in firsts}
        keys = []
        toks = host["toks"]
        for slot, req in slot_map.items():
            base = req.ctx_len + req.generated + (slot in first_slots)
            n = 0
            for row in toks:
                if row[slot] >= 0:
                    keys.append(base + n)
                    n += 1
        idx = self._routed
        self._routed += 1
        in_slice = idx < len(self.frames) and self.frames[idx]["slice"]
        self.tokens.append({"keys": keys, "slice": in_slice})
        return fn(slot_map, firsts, host)

    def _advance_prefill(self, fn, *a, **k):
        return fn(*a, **k)

    def open(self, t0: float) -> None:
        self.in_window = True

    def warm_profiler(self) -> None:
        """Start and stop the profiler once in set-up: its first start in a
        process initialises CUPTI for seconds, which must not fall in the
        window."""
        if not self.cuda:
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=self.engine.device).add_(1)
            torch.cuda.synchronize()

    async def slice_task(self, t0: float, t1: float) -> None:
        """Trace ``slice_s`` seconds, from ``slice_start_s`` into the window
        or ending as it closes."""
        if self.slice_start_s is not None:
            t1 = min(t1, t0 + self.slice_start_s + self.slice_s)
        await asyncio.sleep(max(0.0, t1 - self.slice_s - time.perf_counter()))
        if not self.cuda:
            return
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        ts = time.perf_counter()
        prof.start()
        self.trace["start_s"] = time.perf_counter() - ts
        self.in_slice = True
        await asyncio.sleep(max(0.0, t1 - time.perf_counter()))
        self.in_slice = False
        torch.cuda.synchronize()
        self.trace["window_s"] = time.perf_counter() - ts
        prof.stop()
        self.trace.update(read_trace(prof))

    def close(self) -> None:
        self.in_window = False
        if self.cuda:
            torch.cuda.synchronize()
        for rec in self.frames + self.rounds:
            ev = rec.pop("ev")
            rec["device_s"] = ev[0].elapsed_time(ev[1]) / 1e3 if ev else None


def read_trace(prof) -> Dict:
    """Device time by kernel name, the device's busy time (the union of its
    kernel and copy spans), and its idle gaps by the ``bench.*`` host
    range they fall in, from the raw Kineto events."""
    from torch.autograd import DeviceType

    ops: Dict[str, List] = {}
    spans, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("bench.") and e.device_type() == DeviceType.CUDA:
            continue  # the device-side image of a host range, no work of the card
        if e.device_type() == DeviceType.CUDA:
            rec = ops.setdefault(e.name(), [0.0, 0])
            rec[0] += e.duration_ns() / 1e9
            rec[1] += 1
            spans.append((e.start_ns(), e.end_ns()))
        elif e.name().startswith("bench."):
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
    if not spans:
        return {"ops": ops, "busy_s": 0.0, "gaps": {}}
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    ranges.sort()
    gaps: Dict[str, float] = collections.defaultdict(float)
    for a, b in idle_gaps(spans, lo, hi):
        mid, where = (a + b) // 2, "host outside the engine's wrapped calls"
        for s, e, name in ranges:
            if s > mid:
                break
            if e >= mid:
                where = name
        gaps[where] += (b - a) / 1e9
    return {"ops": ops, "busy_s": span_union_s(spans), "gaps": dict(gaps)}
