"""Kernel B's launch plans, each timed: how far ``plan_conv``'s pick sits
from the best plan the kernel takes.

For one conv of each class of a decode of ``--frames`` frames at the
codec's full width (``CodecConfig()``: the pre-conv; each stage's k = 3, 7
and 11 convs at dilation 1; the post-conv), in float32 and bfloat16, every
plan of ``codec_conv.conv_plans`` runs on the same inputs, is held bit for
bit to the pick's output (a row's value does not depend on the plan), and
is timed by CUDA-graph slope. Each class prints the pick and the best plan
with their times, then the sums over the classes. These per-plan times are
what the plan's cost model (``codec_conv._C_*``) was fitted to.

    python -m magpie_tts_tpu_torch.scripts.conv_plan_sweep [--device cuda|cpu]
        [--frames 32] [--dtype float32|bfloat16|both]

With ``--device cpu`` it lists each class's plans in the cost model's order
and times nothing (the kernel runs only on the card). The last line is one
JSON object with every class's pick, best and times (ms).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from ..config import CodecConfig
from ..ops.kernels import codec_conv as cc
from . import timing

SLOPE_N = (2, 8, 3)  # launches per graph, lo / hi, and replays


def conv_classes(frames: int, cfg: CodecConfig = CodecConfig()):
    """(name, T, C_in, C_out, k, dilation, activated) of one conv per class."""
    out = [("pre", frames, cfg.latent_dim, cfg.base_channels, cfg.pre_conv_kernel, 1, False)]
    T = frames
    for s, (rate, C) in enumerate(zip(cfg.up_sample_rates, cfg.up_channels)):
        T *= rate
        out += [(f"s{s}.k{k}", T, C, C, k, 1, True) for k in cfg.resblock_kernel_sizes]
    out.append(("post", T, cfg.up_channels[-1], 1, cfg.post_conv_kernel, 1, True))
    return out


def _label(p: cc.ConvPlan) -> str:
    return f"{p.tile_m}x{p.tile_n}"


def sweep_class(name, T, c_in, c_out, k, d, act, dtype, device, gen) -> dict:
    plans = sorted(cc.conv_plans(1, T, c_in, c_out, k, d, dtype, act=act), key=lambda cp: cp[0])
    pick = cc.plan_conv(1, T, c_in, c_out, k, d, dtype, act=act)
    res = {"dtype": str(dtype).removeprefix("torch."), "class": name, "T": T, "c_in": c_in,
           "c_out": c_out, "k": k, "dilation": d, "pick": _label(pick),
           "plans": [_label(p) for _, p in plans]}
    if device.type != "cuda":
        return res
    x = (torch.randn(1, T, c_in, generator=gen, device=device) * 0.5).to(dtype)
    w = (torch.randn(k, c_in, c_out, generator=gen, device=device) / math.sqrt(k * c_in)).to(dtype)
    b = (torch.randn(c_out, generator=gen, device=device) * 0.1).to(dtype)
    alpha = ((0.5 + torch.rand(c_in // 2, generator=gen, device=device)).to(dtype)
             if act else None)
    want = cc.snake_causal_conv_planned(x, w, b, alpha, d, 0.01, None, pick)
    times = {}
    for _, p in plans:
        fn = lambda p=p: cc.snake_causal_conv_planned(x, w, b, alpha, d, 0.01, None, p)
        if not torch.equal(fn(), want):
            raise AssertionError(f"{res['dtype']} {name}: plan {_label(p)} differs from the "
                                 f"pick {_label(pick)}")
        times[_label(p)] = timing.graph_slope(lambda i, h: (fn(), h)[1],
                                              torch.zeros(1, device=device),
                                              *SLOPE_N)["per_launch_ms"]
    best = min(times, key=times.get)
    res.update(times_ms=times, best=best, pick_ms=times[res["pick"]], best_ms=times[best])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="conv_plan_sweep", description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--dtype", default="both", choices=("float32", "bfloat16", "both"))
    args = ap.parse_args(argv)
    from ..runtime.engine import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(1, f"conv_plan_sweep: {e}\n")
    print(timing.banner(device) if device.type == "cuda" else
          "device=cpu: the plans in the cost model's order, no times", file=sys.stderr)
    dtypes = ((torch.float32, torch.bfloat16) if args.dtype == "both"
              else (getattr(torch, args.dtype),))
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    with torch.no_grad():
        for dtype in dtypes:
            for cls in conv_classes(args.frames):
                r = sweep_class(*cls, dtype, device, gen)
                rows.append(r)
                head = (f"{r['dtype']:8s} {r['class']:7s} T{r['T']:6d} {r['c_in']:4d}->"
                        f"{r['c_out']:4d} k{r['k']:2d}:")
                if "best" in r:
                    print(f"{head} pick {r['pick']} {r['pick_ms'] * 1e3:.1f} us, best "
                          f"{r['best']} {r['best_ms'] * 1e3:.1f} us ({r['pick_ms'] / r['best_ms']:.3f}x"
                          f", {len(r['plans'])} plans)", file=sys.stderr, flush=True)
                else:
                    print(f"{head} pick {r['pick']}; by cost {' '.join(r['plans'])}",
                          file=sys.stderr, flush=True)
    for dtype in dtypes:
        dn = str(dtype).removeprefix("torch.")
        timed = [r for r in rows if r["dtype"] == dn and "best" in r]
        if timed:
            pick, best = sum(r["pick_ms"] for r in timed), sum(r["best_ms"] for r in timed)
            print(f"{dn}: {len(timed)} classes, picks {pick:.4f} ms, bests {best:.4f} ms "
                  f"({pick / best:.3f}x)", file=sys.stderr, flush=True)
    print(json.dumps({"classes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
