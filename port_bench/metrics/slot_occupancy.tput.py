"""Percent of the slot frames kernel C ran that a request kept: the frame
counts' growth over each segment (``kept_frames``) over segments x K x slots
(``slot_frames``), from the program's ``engine.segment`` spans. Empty slots,
slots past their EOS and frames after it until the segment ends are the rest."""

from port_bench.spans import named


def read(run):
    found = named(run, "engine.segment")
    if found is None:
        return None
    segs = found["engine.segment"]
    total = sum(s.attrs["slot_frames"] for s in segs)
    return 100.0 * sum(s.attrs["kept_frames"] for s in segs) / total if total else None
