"""Find a cell's EOS offset: the value added to the EOS column of every
codebook's ``lt.out_proj_b`` that makes the pool's mean output length, as
the program realises it, the cell's ``target_mean_frames``.

    python3 -m port_bench.calibrate_eos --workload serve-bf16-sat [--workload ...]

On the card. Runs the cell's whole pool once per trial offset through the
cell's own path (serve cells: the continuous engine with every request's
pool identity as its id, as the driver submits it; the stream cell:
``stream_sentence``), bisects on the mean, and prints one JSON line a cell
with every trial and the realised length distribution. The offset goes into
the cell's file by hand.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import run, spec, traffic


def serve_lengths(ctx) -> list:
    from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine

    e = ctx.workload["engine"]
    pool = traffic.pool(ctx.workload["traffic"], ctx.hp)
    engine = ContinuousBatchingEngine(ctx.magpie_weights, ctx.mcfg, n_slots=min(len(pool), 256),
                                      device=ctx.device, compute_dtype=ctx.dtype,
                                      token_buckets=tuple(e["token_buckets"]),
                                      segment_frames=e["segment_frames"])
    ids = {}
    for req in pool:
        engine._next_id = req.index
        ids[engine.submit(list(req.tokens), speaker_id=req.speaker, seed=req.seed)] = req.index
    out = {}
    with torch.no_grad():
        while engine.pending:
            for rid, codes in engine.step(temperature=ctx.temperature, top_k=ctx.top_k).items():
                out[ids[rid]] = codes.shape[0]
    return [out[i] for i in sorted(out)]


def stream_lengths(ctx, state) -> list:
    from magpie_tts_tpu_torch.runtime.streaming import stream_sentence

    from .drivers.stream import _params

    out = []
    with torch.no_grad():
        for req in traffic.pool(ctx.workload["traffic"], ctx.hp):
            state.codes.clear()
            for _ in stream_sentence(state.engine, state.codec, list(req.tokens),
                                     _params(ctx, req)):
                pass
            out.append(int(sum(c.shape[0] for c in state.codes)))
    return out


def calibrate(cell: str, lo: float, hi: float, steps: int) -> dict:
    workload = spec.load("workloads", cell)
    config = spec.load("configs", workload["config"])
    target = float(workload["target_mean_frames"])
    ctx = run.build_context(cell, {**workload, "eos_offset": 0.0}, config, 0, "cuda")
    eos = ctx.mcfg.audio_eos_id
    base = ctx.raw_magpie["lt.out_proj_b"][:, eos].clone()
    state = None
    if workload["driver"] == "stream":
        state = spec.module("drivers", "stream").setup(ctx)
    trials = []

    def measure(offset):
        ctx.raw_magpie["lt.out_proj_b"][:, eos] = base + offset
        t0 = time.perf_counter()
        lengths = serve_lengths(ctx) if state is None else stream_lengths(ctx, state)
        trials.append({"offset": offset, "mean": float(np.mean(lengths)),
                       "seconds": time.perf_counter() - t0})
        print(json.dumps({"cell": cell, **trials[-1]}), file=sys.stderr, flush=True)
        return lengths

    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        if np.mean(measure(mid)) > target:
            lo = mid
        else:
            hi = mid
    best = min(trials, key=lambda t: abs(t["mean"] - target))
    lengths = measure(best["offset"])
    q = np.percentile(lengths, [5, 25, 50, 75, 95]).tolist()
    return {"cell": cell, "target": target, "offset": best["offset"], "mean": float(np.mean(lengths)),
            "quantiles_5_25_50_75_95": q, "max": int(max(lengths)), "n": len(lengths),
            "at_cap": int(sum(n >= ctx.mcfg.max_dec_steps for n in lengths)), "trials": trials}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--lo", type=float, default=-2.0)
    ap.add_argument("--hi", type=float, default=4.0)
    ap.add_argument("--steps", type=int, default=9)
    args = ap.parse_args(argv)
    for cell in args.workload:
        print(json.dumps(calibrate(cell, args.lo, args.hi, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
