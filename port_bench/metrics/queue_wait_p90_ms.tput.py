"""p90 of the time a request waits in the engine's queue: from ``submit`` to
the start of the admission group that places it (the program's
``engine.admit.group`` spans, ``queue_wait_ms``)."""

from port_bench.readings import tail
from port_bench.spans import named


def read(run):
    found = named(run, "engine.admit.group")
    if found is None:
        return None
    return tail([w for g in found["engine.admit.group"] for w in g.attrs["queue_wait_ms"]], 90)
