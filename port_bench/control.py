"""The control of a cell's check: the reference, computed one precision below
the configuration's (float8 e4m3 for bfloat16, TF32 for float32 with TF32
off), put in the program's place. It has to come out as not correct.

    python3 -m port_bench.control --workload <cell> --seconds <s> --seed <n> [--seed ...]

On the card, at the cell's own size and load: each seed runs the cell's
window through the program, then reads both the program's numbers and the
control's on the same prompts and codes (the control's first choice at every
position, its decision to end or go on at the frame each request ended on,
judged by the float32 reference; the control's codec decode of the sampled
requests against the reference's). The control's numbers are held to the
cell's limits by the check's own ``verdict``. One JSON line a seed; the exit
code is 1 when the control comes out correct on any seed, so that the limits
do not separate it from the program.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import check, run
from .reference.codec import Codec
from .reference.model import Magpie

CONTROL_PRECISION = {"bfloat16": "fp8", "float32": "tf32"}


def control_readings(served, ctx) -> dict:
    precision = CONTROL_PRECISION[ctx.config["dtype"]]
    hp, chp = check.model_hp(ctx.mcfg), check.codec_hp(ctx.ccfg)
    limits = ctx.workload["check"]
    served = [served[i] for i in check.sample_of(served, int(limits.get("token_requests", 600)),
                                                 ctx.seed)]
    judge = Magpie(ctx.raw_magpie, hp, ctx.device)
    low = Magpie(ctx.raw_magpie, hp, ctx.device, precision)
    gaps, ends = check.token_readings(served, judge, hp, ctx.temperature, ctx.top_k,
                                      chooser=low)
    del judge, low
    ref = Codec(ctx.raw_codec, chp, ctx.device)
    low_codec = Codec(ctx.raw_codec, chp, ctx.device, precision)
    picks = check.sample_of(served, int(limits.get("codec_requests", 8)), ctx.seed)
    readings = []
    dev = low_codec.w["pre_conv_w"].device
    for i in picks:
        codes = served[i].codes
        if codes.shape[0]:
            audio = low_codec.decode(torch.as_tensor(codes, device=dev)[None])[0].cpu().numpy()
            readings.append(check.codec_reading(codes, audio, ref, ctx.ccfg.hop_length))
    out = {"precision": precision, "token_gap": float(gaps.max()),
           "token_gap_per_request_median": float(np.median(gaps)),
           "end_gap": float(np.nanmax(ends)) if not np.isnan(ends).all() else None}
    for name in check.CODEC_NUMBERS:
        out[name] = max(r[name] for r in readings) if readings else 0.0
    numbers = check.limited(out, limits)
    out["numbers"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    out["correct"] = check.verdict(numbers)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    control_correct = []
    for seed in args.seed:
        kept = {}
        res = run.run_cell(args.workload, seed, args.seconds, False,
                           on_served=lambda served, ctx: kept.update(
                               control=control_readings(served, ctx)))
        r = res.pop("_run")
        print(json.dumps({"cell": args.workload, "seed": seed, "program": res["check"],
                          "control": kept["control"], "correct": res["correct"],
                          "requests": len(r.win["items"]),
                          "frames": r.win["frames_done"]}), flush=True)
        control_correct.append(kept["control"]["correct"])
    if any(control_correct):
        print(f"control: correct on {sum(control_correct)} of {len(control_correct)} seeds: "
              "the limits do not separate the control", file=sys.stderr)
        return 1
    print(f"control: not correct on all {len(control_correct)} seeds", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
