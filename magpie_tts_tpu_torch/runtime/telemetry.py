"""Spans at the layer boundaries of the serving and streaming paths.

A span records only while a ``torch.profiler`` profile runs. Otherwise
``span`` returns one shared no-op after one read of the profiler's own flag,
so an untraced program pays that read and nothing else. Under a profile a
span opens ``record_function("magpie.<name>")``, which puts it on the
profiler's timeline on the device kernels' clock, and appends a record to an
in-memory buffer: name, ``perf_counter_ns`` start and end, the index of the
enclosing span of the same thread (-1 at the top) and the attributes. Counts
are attributes of the span at the boundary where their work happens.

The buffer is a ring of the newest ``CAPACITY`` records, so a long-lived
process profiled again and again keeps recording; the records it overwrites
are counted by ``dropped()``. A span's index counts every span recorded in
the process. ``spans(t0, t1)`` returns the records that start in a window
given in ``time.perf_counter`` seconds.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 18

_records: deque = deque(maxlen=CAPACITY)
_recorded = 0
_dropped = 0
_lock = threading.Lock()
_local = threading.local()


class _Off:
    """The span of an untraced program: it records nothing."""

    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class Span:
    """One span: entered once; ``set`` adds attributes until it closes."""

    on = True
    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "index", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = 0
        self.parent = self.index = -1

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        global _recorded, _dropped
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else -1
        self._rf = torch.profiler.record_function("magpie." + self.name)
        self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        with _lock:
            self.index = _recorded
            _recorded += 1
            _dropped += len(_records) == _records.maxlen
            _records.append(self)
        stack.append(self.index)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        self._rf.__exit__(*exc)
        self._rf = None
        return False


def span(name: str, **attrs):
    """A context manager spanning one layer's call, ``magpie.<name>`` on the
    profiler's timeline; the no-op when no profile runs."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, attrs)


def spans(t0: float, t1: float) -> List[Span]:
    """The records whose span started in [t0, t1] (``time.perf_counter`` s)."""
    lo, hi = int(t0 * 1e9), int(t1 * 1e9)
    with _lock:
        return [r for r in _records if lo <= r.start_ns <= hi]


def dropped() -> int:
    """Records the ring has overwritten."""
    return _dropped
