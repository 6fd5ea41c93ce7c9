"""Timing for the probes: the counterparts of ``slope()``
(scripts/opt_slope_probe.py) and ``timed()`` (scripts/probe_int4.py,
scripts/opt_launch_probe.py).

A probe hands over ``body(i, h) -> h``, one launch that takes the carried
value ``h`` (a tensor or a tuple) and the launch's index ``i``, as the TPU
probes' ``fori_loop`` body does, and an initial ``h``.

- ``graph_slope`` captures ``n_lo`` chained launches in one
  ``torch.cuda.CUDAGraph`` and ``n_hi`` in another, replays each between
  CUDA events, keeps the best of ``reps`` and returns the slope
  (T_hi - T_lo) / (n_hi - n_lo): the device time of one launch, free of the
  host's enqueue (the TPU probes' jitted loop).
- ``eager_slope`` is the same with the launches issued from Python each
  time: the larger of the device time and the host's cost of a launch.
  Their difference is what the host adds per launch.
- ``event_mean`` is the CUDA-event mean of repeated calls.

On the CPU (a carried value on the CPU) every function times the plain
versions by the host clock, and its result says so (``clock: "host"``).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

REPS = 5


def _tensors(h):
    return [t for t in (h if isinstance(h, (tuple, list)) else (h,))
            if isinstance(t, torch.Tensor)]


def device_of(h) -> torch.device:
    return _tensors(h)[0].device


def chain(body: Callable, h, n: int):
    """n launches, each fed the previous one's result."""
    for i in range(n):
        h = body(i, h)
    return h


def _result(times: dict, n_lo: int, n_hi: int, clock: str) -> dict:
    return {"per_launch_ms": (times[n_hi] - times[n_lo]) / (n_hi - n_lo),
            "t_lo_ms": times[n_lo], "t_hi_ms": times[n_hi], "n_lo": n_lo, "n_hi": n_hi,
            "clock": clock}


def host_slope(body: Callable, init, n_lo: int, n_hi: int, reps: int = REPS) -> dict:
    """The slope by the host clock around each chain (the CPU's measure)."""
    chain(body, init, 1)
    times = {}
    for n in (n_lo, n_hi):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            chain(body, init, n)
            best = min(best, (time.perf_counter() - t0) * 1e3)
        times[n] = best
    return _result(times, n_lo, n_hi, "host")


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def graph_slope(body: Callable, init, n_lo: int, n_hi: int, reps: int = REPS) -> dict:
    """Per-launch device ms from two captured chains of n_lo and n_hi
    launches (best of ``reps`` replays each); each graph is freed before the
    next is captured. On the CPU: ``host_slope``."""
    if device_of(init).type != "cuda":
        return host_slope(body, init, n_lo, n_hi, reps)
    chain(body, init, 1)  # warm-up: builds the library, workspaces, per-call state
    torch.cuda.synchronize()
    times = {}
    for n in (n_lo, n_hi):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = chain(body, init, n)
        graph.replay()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            start, end = _events()
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        times[n] = best
        del graph, out
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return _result(times, n_lo, n_hi, "cuda graph")


def eager_slope(body: Callable, init, n_lo: int, n_hi: int, reps: int = REPS) -> dict:
    """Per-launch ms of chains issued from Python, by CUDA events around each
    chain (best of ``reps``). On the CPU: ``host_slope``."""
    if device_of(init).type != "cuda":
        return host_slope(body, init, n_lo, n_hi, reps)
    chain(body, init, 1)
    torch.cuda.synchronize()
    times = {}
    for n in (n_lo, n_hi):
        best = float("inf")
        for _ in range(reps):
            start, end = _events()
            start.record()
            out = chain(body, init, n)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
            del out
        times[n] = best
    return _result(times, n_lo, n_hi, "eager")


def event_mean(fn: Callable, reps: int, warmup: int = 2, device=None) -> float:
    """Mean ms of fn() over ``reps`` calls: CUDA events on a CUDA ``device``
    (the default when a card is there), the host clock on the CPU."""
    device = torch.device(device) if device is not None else torch.device("cuda")
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = _events()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fmt(res: dict) -> str:
    """One slope as 'X us/launch (Tlo=..ms Thi=..ms, clock)'."""
    return (f"{res['per_launch_ms'] * 1e3:9.3f} us/launch  (T{res['n_lo']}="
            f"{res['t_lo_ms']:.4f} ms T{res['n_hi']}={res['t_hi_ms']:.4f} ms, {res['clock']})")


# An H100 SXM's published peaks (NVIDIA's datasheet): device memory rate and
# dense bf16 on the tensor cores. A probe's bound is the larger of its bytes
# (each input read once, each output written once) over the first and its
# operations over the second.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
L2_BYTES = 50 * 2 ** 20  # the H100's L2: a rotation past it reads from HBM


def bound(nbytes: float, flops: float = 0.0) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "bytes": nbytes, "flops": flops}


def copies_past_l2(nbytes: int) -> int:
    """How many copies of an nbytes working set a rotation needs so that the
    set is gone from the 50 MB L2 when its turn comes again (at least 2)."""
    return max(2, -(-int(1.2 * L2_BYTES) // max(int(nbytes), 1)))


def parse_args(argv, prog: str, doc: str, build=None):
    """A script's arguments (``build(parser)`` adds them) plus ``--device``
    (default cuda); returns (args, torch.device). A CUDA device that is not
    there exits 1: the scripts have no CPU fallback, ``--device cpu`` asks
    for the plain versions."""
    import argparse

    from ..runtime.engine import resolve_device

    ap = argparse.ArgumentParser(prog=prog, description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    if build is not None:
        build(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(1, f"{prog}: {e}\n")
    return args, device


def parse_device(argv, prog: str, doc: str, names: bool = False):
    """``parse_args`` with, when ``names``, the probe names; returns
    (torch.device, names)."""
    build = (lambda ap: ap.add_argument("probes", nargs="*")) if names else None
    args, device = parse_args(argv, prog, doc, build)
    return device, getattr(args, "probes", None)


def banner(device: torch.device) -> str:
    """The device line every probe prints first."""
    if device.type == "cpu":
        return ("device=cpu: every time below is the PLAIN PyTorch version's, by the host "
                "clock (no kernel, no CUDA graph)")
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except OSError:
        smi = []
    idx = device.index or 0
    power = smi[idx] if idx < len(smi) else "nvidia-smi: not available"
    return f"device={torch.cuda.get_device_name(device)} ({power})"
