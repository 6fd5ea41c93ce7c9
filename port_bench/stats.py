"""Percentiles and spreads, as the benchmark reports and bounds them."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


class TooFewSamples(ValueError):
    """A percentile asked of too few samples to have ten beyond it."""


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank ``p``-th percentile of ``values`` (a miss is +inf).
    Refused unless at least ten samples lie beyond it: n * (1 - p / 100) >= 10."""
    n = len(values)
    if n * (1.0 - p / 100.0) < 10.0 - 1e-9:
        raise TooFewSamples(f"p{p:g} of {n} samples has fewer than 10 beyond it")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(p / 100.0 * n) - 1)]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
