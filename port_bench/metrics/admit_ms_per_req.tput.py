"""Host ms of the engine's admission (_admit_pending: prepare_batch groups
and placement) per request admitted in the window."""

from port_bench.readings import per_count


def read(run):
    return per_count(run, "admit", "admitted")
