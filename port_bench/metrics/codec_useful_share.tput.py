"""Percent of the frames the codec vocoded that were delivered: ``frames``
over ``vocoded`` of the program's ``codec.decode_batch`` spans (serve: every
request padded to its batch's frame bucket) and ``stream.vocode`` spans (the
stream: a window of context and new frames for each chunk's new frames)."""

from port_bench.spans import named


def read(run):
    found = named(run, "codec.decode_batch", "stream.vocode")
    if found is None:
        return None
    spans = found["codec.decode_batch"] + found["stream.vocode"]
    vocoded = sum(s.attrs["vocoded"] for s in spans)
    return 100.0 * sum(s.attrs["frames"] for s in spans) / vocoded if vocoded else None
