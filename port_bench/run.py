"""Run one cell of the benchmark and print its result as one JSON line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from process start to the window): weights on the card
from the seeds, the cell's driver builds the program's engines and warms
every shape the cell's traffic uses (a checkout's first run also builds the
kernel library). Then the window: ``--seconds`` of the cell's traffic through
the program, with tracing on only under ``--trace 1`` (the profiler, the
benchmark's spans around the program's layers and kernels). Then the program
is freed and the check (``check.py``) judges what it served against the
plain reference. The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result.

Exit codes: 0 with a result; 2 when no CUDA card (or too few) is there;
3 when JAX or the JAX package was loaded; 1 on any other failure.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "magpie_tts_tpu")
PEAKS = {  # NVIDIA H100 SXM data sheet, dense: bf16 and TF32 tensor cores, HBM3
    "bfloat16": 989e12, "float32": 495e12, "bandwidth": 3.35e12}


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


@dataclasses.dataclass
class Context:
    cell: str
    workload: dict
    config: dict
    seed: int
    device: object
    dtype: object
    mcfg: object
    ccfg: object
    hp: dict
    chp: dict
    raw_magpie: dict
    raw_codec: dict
    magpie_weights: object
    codec_weights: object
    temperature: float
    top_k: int


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: str
    workload: dict
    dtype: str
    setup_s: float
    window_s: float
    win: dict
    stage_s: dict
    stage_calls: dict
    kernel_least_s: dict
    profile: Optional[dict]
    peaks: dict
    model_flops: float


def build_context(cell: str, workload: dict, config: dict, seed: int, device) -> Context:
    import torch

    from . import port, weights

    mcfg, ccfg = port.configs(config)
    hp, chp = dataclasses.asdict(mcfg), dataclasses.asdict(ccfg)
    dtype = port.DTYPES[config["dtype"]]
    raw_m = weights.make(weights.magpie_shapes(hp), int(config["weights_seed"]), device, dtype)
    raw_m["lt.out_proj_b"][:, mcfg.audio_eos_id] += float(workload["eos_offset"])
    raw_c = weights.make(weights.codec_shapes(chp), weights.sub_seed(seed, "codec"), device, dtype)
    s = workload["sampling"]
    return Context(cell, workload, config, seed, torch.device(device), dtype, mcfg, ccfg, hp, chp,
                   raw_m, raw_c, port.magpie_weights(raw_m), port.codec_weights(raw_c, chp),
                   float(s["temperature"]), int(s["top_k"]))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=10)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
             root=None, overrides=None, log=print, on_served=None) -> dict:
    """One run of ``cell``; returns the result (``correct``, ``metrics``, ...).
    ``overrides`` (tests) replaces parts of the cell or its
    configuration; ``on_served(served, ctx)`` (the control) sees what the
    check judged."""
    import torch

    from . import check, spec, trace as trace_mod, work

    root = root or spec.ROOT
    bench = spec.benchmark(root)
    if cell not in {w["name"] for w in bench["workloads"]}:
        raise KeyError(f"BENCHMARK.json has no cell {cell!r}")
    workload = spec.load("workloads", cell, root)
    config = spec.load("configs", workload["config"], root)
    if overrides:
        workload = {**workload, **overrides.get("workload", {})}
        config = {**config, **overrides.get("config", {})}
    driver = spec.module("drivers", workload["driver"], root)
    ctx = build_context(cell, workload, config, seed, device)
    state = driver.setup(ctx)
    tracer = trace_mod.Tracer(trace)
    kernels = spec.kernels(root)
    driver.instrument(ctx, state, tracer)
    tracer.wrap_kernels({k: m.SITE for k, m in kernels.items()},
                        {k: m.info for k, m in kernels.items()})
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = process_age()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        with torch.profiler.record_function(trace_mod.WINDOW_SPAN):
            win = driver.window(ctx, state, seconds)
            if cuda:
                torch.cuda.synchronize()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        tracer.restore()
    window_s = win["t_end"] - win["t0"]
    t_reduce = time.perf_counter()
    profile = trace_mod.reduce_profile(prof) if (prof is not None and cuda) else None
    if prof is not None:
        log(f"bench: profile reduced in {time.perf_counter() - t_reduce:.1f}s", file=sys.stderr)
    del prof
    least = {k: mod.least_seconds(tracer.kernel_calls[k], ctx.hp, PEAKS, config["dtype"])
             for k, mod in kernels.items() if tracer.kernel_calls.get(k)}
    memory_peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    served = driver.served(ctx, win)
    model_flops = work.window_flops(ctx.hp, ctx.chp, win["items"])
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check.run(served, ctx.raw_magpie, ctx.raw_codec, ctx.mcfg, ctx.ccfg,
                        workload["check"], ctx.temperature, ctx.top_k, seed, ctx.device)
    log(f"bench: check of {verdict.get('checked')} in {time.perf_counter() - t_check:.1f}s: "
        f"{json.dumps(verdict.get('detail'))}", file=sys.stderr)
    if on_served is not None:
        on_served(served, ctx)
    run = Run(cell, workload, config["dtype"], setup_s, window_s, win, dict(tracer.seconds),
              dict(tracer.calls), least, profile, PEAKS, model_flops)
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for m in spec.cell_metrics(bench, cell, trace):
        value = spec.module("metrics", m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
    result = {"correct": verdict["correct"], "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if profile is not None:
        result["breakdown"] = profile["breakdown"]
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict["numbers"].items()}
    result["_run"] = run
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from . import spec

    cell = next((w for w in spec.benchmark()["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"bench: BENCHMARK.json has no cell {args.workload!r}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"bench: cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      log=lambda *a, **k: print(*a, **k, flush=True))
    run = result.pop("_run")
    found = forbidden_modules()
    if found:
        print(f"bench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    lengths = run.win["counts"].get("lengths", [])
    info = {"window_s": run.window_s, "setup_s": run.setup_s,
            "power_limit": power_limit(), "stages_s": run.stage_s,
            "kernel_device_s": (run.profile or {}).get("kernel_s"),
            "kernel_extent_s": (run.profile or {}).get("kernel_extent_s"),
            "counts": {k: v for k, v in run.win["counts"].items() if k != "lengths"},
            "mean_frames": (sum(lengths) / len(lengths)) if lengths else None,
            "max_frames": max(lengths) if lengths else None}
    print("bench: " + json.dumps(info), file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
