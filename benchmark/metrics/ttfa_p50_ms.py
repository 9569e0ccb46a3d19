"""Median time to first audio, ms: every request sent in the window, from
its scheduled send to its first PCM hop; a failed request is a miss."""
from benchmark.lib.stats import nearest_rank, ttfa_ms


def read(run):
    return nearest_rank(ttfa_ms(run.records, run.deadline), 50) if run.records else None
