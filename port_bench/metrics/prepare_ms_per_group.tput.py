"""Host ms of one admission group's ``prepare_batch`` call (the program's
``engine.admit.prepare`` spans, one a group)."""

from port_bench.spans import named


def read(run):
    found = named(run, "engine.admit.prepare")
    if found is None:
        return None
    spans = found["engine.admit.prepare"]
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
