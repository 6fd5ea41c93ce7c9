"""Host ms of decode_chunk (decode_loop: kernel A and one host read a frame)
per frame generated."""

from port_bench.readings import per_count


def read(run):
    return per_count(run, "chunk", "frames_generated")
