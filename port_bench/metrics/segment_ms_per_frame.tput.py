"""Host ms of the engine's segments (_segment: kernel C a frame, one host
read a segment) per engine frame (segments x segment_frames)."""

from port_bench.readings import per_count


def read(run):
    return per_count(run, "segment", "engine_frames")
