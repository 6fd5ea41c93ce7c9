"""90th percentile, over every sentence of the window, of the time from its
token ids being handed to stream_sentence to its first chunk's samples."""

from port_bench.readings import tail


def read(run):
    return tail(run.win["ttfa_ms"], 90)
