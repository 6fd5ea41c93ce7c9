"""Arithmetic the metric readers (``metrics/<name>.py``) share. Each returns
None where the run holds nothing to read, and the metric is then left out."""

from __future__ import annotations

from typing import Optional


def per_count(run, stage: str, count: str, scale: float = 1e3) -> Optional[float]:
    """Host seconds in ``stage`` per unit of ``count``, times ``scale``."""
    n = run.win["counts"].get(count, 0)
    if stage not in run.stage_s or not n:
        return None
    return scale * run.stage_s[stage] / n


def per_call(run, stage: str, scale: float = 1e3) -> Optional[float]:
    n = run.stage_calls.get(stage, 0)
    return scale * run.stage_s[stage] / n if n else None


def roofline(run, kernel: str) -> Optional[float]:
    """Percent: the kernel's least time (rooflines/<kernel>.py) over its
    device time in the trace."""
    if run.profile is None or kernel not in run.kernel_least_s:
        return None
    device = run.profile["kernel_s"].get(kernel, 0.0)
    return 100.0 * run.kernel_least_s[kernel] / device if device > 0 else None


def idle_share(run) -> Optional[float]:
    """Percent of the traced window with no kernel running on the card."""
    if run.profile is None or run.profile["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])


def mfu(run) -> Optional[float]:
    """Percent: flops of the work the window completed (work.window_flops)
    over the window's seconds times the peak of the served dtype."""
    if run.profile is None or not run.model_flops or run.window_s <= 0:
        return None
    return 100.0 * run.model_flops / (run.window_s * run.peaks[run.dtype])


def tail(values, p: float) -> Optional[float]:
    """The ``p``-th percentile, or None (with a note on standard error) where
    fewer than ten samples lie beyond it."""
    import sys

    from .stats import TooFewSamples, percentile

    try:
        return percentile(values, p)
    except TooFewSamples as e:
        print(f"bench: {e}", file=sys.stderr)
        return None
