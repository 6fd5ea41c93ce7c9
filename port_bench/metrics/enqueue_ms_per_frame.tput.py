"""Host ms to enqueue one frame's work. Serve: the program's
``engine.segment.enqueue`` spans (the K-frame launch loop) over segments x K.
Stream: ``stream.chunk``'s self time (less its ``decode.read`` children, the
frames' host reads) over the frames the chunks made."""

from port_bench.spans import named


def read(run):
    found = named(run, "engine.segment.enqueue", "stream.chunk", "decode.read")
    if found is None:
        return None
    loops = found["engine.segment.enqueue"]
    if loops:
        return 1e3 * sum(s.seconds for s in loops) / (
            len(loops) * run.workload["engine"]["segment_frames"])
    chunks = found["stream.chunk"]
    inside = {c.index for c in chunks}
    reads = sum(r.seconds for r in found["decode.read"] if r.parent in inside)
    frames = sum(c.attrs["frames"] for c in chunks)
    return 1e3 * (sum(c.seconds for c in chunks) - reads) / frames if frames else None
