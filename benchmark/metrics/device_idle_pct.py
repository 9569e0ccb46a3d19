"""Share of the traced slice in which no kernel or copy ran on the card."""
from benchmark.lib.readers import idle_pct


def read(run):
    return idle_pct(run)
