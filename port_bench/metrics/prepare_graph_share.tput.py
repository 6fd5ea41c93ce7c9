"""Percent of the window's prepares that replayed a captured CUDA graph: the
program's ``engine.admit.prepare`` (one an admission group) and
``stream.prepare`` (one a sentence) spans whose ``graph`` attribute is
``replay``; the rest captured their shape's graph at its first use, or ran
eagerly (not on a card). A program whose spans carry no ``graph`` reads None."""

from port_bench.spans import named


def read(run):
    found = named(run, "engine.admit.prepare", "stream.prepare")
    if found is None:
        return None
    modes = [s.attrs["graph"] for spans in found.values() for s in spans if "graph" in s.attrs]
    return 100.0 * modes.count("replay") / len(modes) if modes else None
