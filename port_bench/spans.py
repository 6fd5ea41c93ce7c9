"""The program's own spans in a run's window, for the metric readers of
``program_span`` and ``program_counter`` metrics: the records of
``magpie_tts_tpu_torch.runtime.telemetry`` (kept while the ``--trace 1``
profile runs), by name. A program without that module, or a window in which
it kept none of the names, reads None, and the metric is left out."""

from __future__ import annotations

import sys
from typing import Dict, List, Optional


def named(run, *names: str) -> Optional[Dict[str, List]]:
    """{name: [records]} of the window's spans of ``names``, or None."""
    try:
        from magpie_tts_tpu_torch.runtime import telemetry
    except ImportError:
        return None
    if telemetry.dropped():
        print(f"bench: the program's span ring overwrote {telemetry.dropped()} spans; a "
              f"window that held more than {telemetry.CAPACITY} lacks its first",
              file=sys.stderr)
    out: Dict[str, List] = {n: [] for n in names}
    for s in telemetry.spans(run.win["t0"], run.win["t_end"]):
        if s.name in out:
            out[s.name].append(s)
    return out if any(out.values()) else None
