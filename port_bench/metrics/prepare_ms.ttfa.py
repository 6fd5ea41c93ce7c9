"""Host ms of begin_stream (encoder, cross-attention K/V, context prefill,
BOS step) per sentence."""

from port_bench.readings import per_call


def read(run):
    return per_call(run, "prepare")
