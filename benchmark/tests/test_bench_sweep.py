"""The knee and the open-loop cell's rate follow from a sweep's rows."""
import pytest

from benchmark.lib import spec
from benchmark.sweep import knee

# the chat sweep as run on an H100 (every request greedy, seed 9, 15 s
# windows): rate, share within the limits, backlog growing
CHAT_SWEEP = [(2.0, 0.233, False), (3.0, 0.067, False), (4.0, 0.133, False),
              (5.0, 0.067, False), (6.0, 0.044, True), (7.0, 0.076, True),
              (8.0, 0.025, True)]


def _rows(ladder):
    return [{"rate_per_s": r, "met": m, "growing": g} for r, m, g in ladder]


def test_no_rate_within_limits_takes_the_highest_steady_rate():
    k = knee(_rows(CHAT_SWEEP))
    assert k == {"knee_per_s": 5.0, "knee_by": "no growing backlog", "rate_per_s": 4.0}


@pytest.mark.parametrize("name", ["chat", "chat_greedy"])
def test_chat_rate_is_the_sweeps(name):
    assert spec.load_mix(name)["arrival"]["rate_per_s"] == knee(_rows(CHAT_SWEEP))["rate_per_s"]


def test_limits_decide_where_a_rate_meets_them():
    rows = _rows([(1.0, 0.95, False), (2.0, 0.92, False), (3.0, 0.5, False), (4.0, 0.1, True)])
    assert knee(rows) == {"knee_per_s": 2.0, "knee_by": "limits", "rate_per_s": 1.6}
    assert knee(_rows([(1.0, 0.0, True)]))["knee_per_s"] is None
