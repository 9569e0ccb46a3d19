"""The end-to-end arithmetic against hand-worked cases."""
import math

import pytest

from benchmark.lib import stats

HOP = 2048 / 24000


def req(t_sched, first, n, gap=HOP, failed=False, stall_at=None, stall=0.0):
    hops, t = [], first
    for k in range(n):
        if stall_at is not None and k == stall_at:
            t += stall
        hops.append(t)
        t += gap
    return {"t_sched": t_sched, "hops": hops if not failed else hops[:1], "failed": failed}


def test_nearest_rank():
    v = list(range(1, 11))  # 1..10
    assert stats.nearest_rank(v, 50) == 5
    assert stats.nearest_rank(v, 90) == 9
    assert stats.nearest_rank(v, 10) == 1
    assert stats.nearest_rank([7.0], 90) == 7.0


def test_ttfa_counts_from_scheduled_send_and_misses():
    reqs = [req(0.0, 0.1, 3), req(1.0, 1.25, 3), req(2.0, 2.2, 3, failed=True),
            {"t_sched": 3.0, "hops": [], "failed": True}]
    t = stats.ttfa_ms(reqs, deadline=10.0)
    assert t[0] == pytest.approx(100.0) and t[1] == pytest.approx(250.0)
    # misses count the whole wait to the deadline, more than any served request
    assert t[2] == pytest.approx(8001.0) and t[3] == pytest.approx(7001.0)
    assert stats.nearest_rank(t, 50) == pytest.approx(250.0)


def test_a_stall_moves_rtf_p10_and_audio_rate():
    steady = [req(k, k + 0.1, 12) for k in range(10)]
    rtf = stats.stream_rtf(steady, HOP)
    assert all(r == pytest.approx(12 / 11) for r in rtf)
    stalled = [req(k, k + 0.1, 12, stall_at=6, stall=0.5) for k in range(10)]
    r2 = stats.stream_rtf(stalled, HOP)
    assert stats.nearest_rank(r2, 10) == pytest.approx(12 * HOP / (11 * HOP + 0.5))
    assert stats.nearest_rank(r2, 10) < 1.0 < stats.nearest_rank(rtf, 10)
    # the window's audio: hops received inside [0, 10] only
    a1 = stats.audio_rate(steady, 0.0, 10.0, HOP)
    a2 = stats.audio_rate(stalled, 0.0, 10.0, HOP)
    n1 = sum(1 for r in steady for t in r["hops"] if t <= 10.0)
    assert a1 == pytest.approx(n1 * HOP / 10.0) and a2 < a1


def test_failed_request_counts_zero_rtf():
    assert stats.stream_rtf([req(0, 0.1, 5, failed=True)], HOP) == [0.0]


def test_span_union_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40), (35, 36), (50, 60)]
    assert stats.span_union_s(spans) == pytest.approx(40 / 1e9)
    assert stats.idle_gaps(spans, 0, 70) == [(20, 30), (40, 50), (60, 70)]


def test_quartile_spread():
    assert stats.quartile_spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)
    assert math.isfinite(stats.quartile_spread([2.0, 2.0, 2.0, 2.1]))
