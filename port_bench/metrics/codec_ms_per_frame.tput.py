"""Host ms in the codec (decode_batch, or the stream's window decodes) per
audio frame delivered: padding and context frames cost, and show here."""

from port_bench.readings import per_count


def read(run):
    return per_count(run, "codec", "vocoded_frames")
