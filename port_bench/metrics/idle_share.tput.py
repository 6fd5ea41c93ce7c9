"""Percent of the traced window in which no kernel ran on the card (the union
of the profiler's kernel intervals)."""

from port_bench.readings import idle_share


def read(run):
    return idle_share(run)
