"""The benchmark's own instrumentation of the program, on in ``--trace 1`` runs.

- ``Tracer.stage`` times a host span around a call into one of the program's
  layers (host wall seconds and calls by name, as ``chip_profile.py``'s
  ``_StageTimer`` did) and, under the profiler, marks it with a
  ``record_function`` named ``bench.stage.<name>``.
- ``Tracer.wrap_kernels`` spans each of the program's kernel wrappers named
  in ``port.KERNEL_SITES`` (``bench.kernel.<K>``) and keeps the shapes of
  every call, for the roofline's operations and bytes.
- ``reduce_profile`` turns the profiler's events into device seconds per
  kernel span (the device kernels that ran inside the span's extent on the
  card), the busy union of every device kernel over the window
  (``chip_profile.py``'s ``_busy_share``), the device operations that took
  most time and the idle gaps by the host stage that was running when the
  device went idle.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

WINDOW_SPAN = "bench.window"


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.kernel_calls: Dict[str, list] = defaultdict(list)
        self._restore: List[tuple] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"bench.stage.{name}"):
                yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def wrap_method(self, obj, attr: str, stage: str) -> None:
        """Put ``obj.attr`` (an instance's bound method) under ``stage``."""
        if not self.enabled:
            return
        fn = getattr(obj, attr)

        def timed(*a, **k):
            with self.stage(stage):
                return fn(*a, **k)
        setattr(obj, attr, timed)

    def wrap_kernels(self, sites: Dict[str, tuple], infos: Dict[str, Callable]) -> None:
        """Span every kernel wrapper of ``sites`` ({kernel: (module, attr)}) and
        keep ``infos[kernel](*args, **kwargs)`` of each call."""
        if not self.enabled:
            return
        for kernel, (module_name, attr) in sites.items():
            module = importlib.import_module(module_name)
            fn = getattr(module, attr)
            info = infos.get(kernel)

            def spanned(*a, _fn=fn, _k=kernel, _info=info, **k):
                if _info is not None:
                    self.kernel_calls[_k].append(_info(*a, **k))
                with torch.profiler.record_function(f"bench.kernel.{_k}"):
                    return _fn(*a, **k)
            setattr(module, attr, spanned)
            self._restore.append((module, attr, fn))

    def restore(self) -> None:
        for module, attr, fn in reversed(self._restore):
            setattr(module, attr, fn)
        self._restore.clear()


def _union(intervals) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def reduce_profile(prof) -> dict:
    """Device seconds by kernel span, busy and window seconds, and the
    breakdown, from a profile holding one ``bench.window`` span.

    Reads the profiler's raw events (no event tree is built: a window holds
    hundreds of thousands of kernels). A kernel span's device time is the
    time of the device kernels that run inside its device-side extent (the
    profiler's copy of the host span on the card's timeline): one stream
    runs kernels in launch order, so those are the kernels the span launched."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    kernels, stages, windows = [], [], []
    extents: Dict[str, list] = defaultdict(list)
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                if name.startswith("bench.kernel."):
                    extents[name[len("bench.kernel."):]].append((e.start_ns(), e.end_ns()))
            elif not _is_copy(name):
                kernels.append((e.start_ns(), e.end_ns(), name))
        elif name == WINDOW_SPAN:
            windows.append((e.start_ns(), e.end_ns()))
        elif name.startswith("bench.stage."):
            stages.append((e.start_ns(), e.end_ns(), name[len("bench.stage."):]))
    if len(windows) != 1:
        raise RuntimeError(f"the profile holds {len(windows)} {WINDOW_SPAN} spans, want 1")
    ws, we = windows[0]
    inside = sorted((max(s, ws), min(t, we), n) for s, t, n in kernels if min(t, we) > max(s, ws))
    starts = [s for s, _, _ in inside]
    acc = [0]
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, n in inside:
        acc.append(acc[-1] + (t - s))
        by_name[n] += (t - s) / 1e9
    by_kernel = {}
    for k, spans in extents.items():
        total = 0
        for a, b in spans:
            total += acc[bisect.bisect_right(starts, b)] - acc[bisect.bisect_left(starts, a)]
        by_kernel[k] = total / 1e9
    busy = _union([(s, t) for s, t, _ in inside])
    idle: Dict[str, float] = defaultdict(float)
    stages.sort()
    stage_starts = [s for s, _, _ in stages]
    for gs, ge in _gaps([(s, t) for s, t, _ in inside], ws, we):
        idle[_stage_at(stages, stage_starts, gs)] += (ge - gs) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (we - ws) / 1e9, "busy_s": busy / 1e9, "kernel_s": by_kernel,
            "kernel_extent_s": {k: sum(b - a for a, b in v) / 1e9 for k, v in extents.items()},
            "n_kernels": len(inside),
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in
                                        sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}}


def _gaps(intervals, ws: float, we: float):
    out, cur = [], ws
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if we > cur:
        out.append((cur, we))
    return out


def _stage_at(stages, starts, t: float) -> str:
    """The host stage running at ``t`` (the latest-starting span that began
    by ``t``, if it still runs), or "host" outside every stage."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and stages[i][1] >= t:
        return stages[i][2]
    return "host"
