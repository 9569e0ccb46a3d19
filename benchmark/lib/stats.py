"""The arithmetic of the end-to-end metrics, from per-request times.

A request is a dict with ``t_sched`` (when it was due), ``hops`` (the
host time each PCM hop was received) and ``failed``.  Percentiles are
nearest-rank: the value of rank ``ceil(p / 100 * n)`` in ascending order,
so no value is interpolated between a served request and a miss.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence


def nearest_rank(values: Sequence[float], p: float) -> float:
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(1, math.ceil(p / 100.0 * len(s))) - 1]


def ttfa_ms(reqs: List[Dict], deadline: float) -> List[float]:
    """Time from each request's scheduled send to its first hop, in ms.  A
    failed request, or one with no hop, is a miss: it counts the whole wait
    up to the drain deadline, more than any served request waited."""
    out = []
    for r in reqs:
        if r["failed"] or not r["hops"]:
            out.append((max(deadline, r["t_sched"]) - r["t_sched"]) * 1e3 + 1.0)
        else:
            out.append((r["hops"][0] - r["t_sched"]) * 1e3)
    return out


def stream_rtf(reqs: List[Dict], hop_audio_s: float) -> List[float]:
    """Each request's audio seconds over the seconds from its first hop to
    its last; a failed request counts 0."""
    out = []
    for r in reqs:
        hops = r["hops"]
        if r["failed"] or len(hops) < 2:
            out.append(0.0)
            continue
        out.append(len(hops) * hop_audio_s / max(hops[-1] - hops[0], 1e-9))
    return out


def audio_rate(reqs: List[Dict], t0: float, t1: float, hop_audio_s: float) -> float:
    """Audio seconds of the hops received in ``[t0, t1]`` over ``t1 - t0``."""
    n = sum(1 for r in reqs for t in r["hops"] if t0 <= t <= t1)
    return n * hop_audio_s / (t1 - t0)


def span_union_s(spans) -> float:
    """Length of the union of ``(start_ns, end_ns)`` spans, in seconds
    (copied from ``project_morpheus_tpu_torch/tools/profile_serving.py:
    busy_seconds``): spans that overlap count once."""
    total, reach = 0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total / 1e9


def idle_gaps(spans, t_lo: int, t_hi: int):
    """The gaps ``(start_ns, end_ns)`` in ``[t_lo, t_hi]`` where no span runs."""
    gaps, reach = [], t_lo
    for start, end in sorted(spans):
        if start > reach:
            gaps.append((reach, min(start, t_hi)))
        reach = max(reach, end)
        if reach >= t_hi:
            break
    if reach < t_hi:
        gaps.append((reach, t_hi))
    return [(a, b) for a, b in gaps if b > a]


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, with Python's ``statistics.quantiles``."""
    import statistics

    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)
