"""Requests a ``prepare_batch`` group admits: requests over the program's
``engine.admit.group`` spans (each group pays admission's fixed host cost)."""

from port_bench.spans import named


def read(run):
    found = named(run, "engine.admit.group")
    if found is None:
        return None
    groups = found["engine.admit.group"]
    return sum(g.attrs["requests"] for g in groups) / len(groups)
