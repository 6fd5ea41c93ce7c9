"""Batched greedy parity and loop throughput on the H100
(scripts/parity_batched.py): the fused batched frame kernel (C), the split
batched kernels (7 + 8) and the plain lockstep loop, slot by slot.

Every arm is ``models.magpie.synthesize_codes_batched_program`` on the same
inputs (B streams of T = 64 tokens, lengths 16..61, keys
``fold_in(PRNGKey(0), i)``, random 357M weights, top_k 80):

  fused  ``use_fused=True`` on --device: kernel C once a frame
  split  ``use_fused=False``: kernels 7 and 8 a frame
  plain  the program on the CPU (the wrappers' plain versions); it runs the
         slots one at a time, so B = 32 x 100 frames takes minutes
         (``run_parity(..., plain_batch=N)`` runs it on the first N slots)

For every slot, codes and ``n_frames`` meet parity_decode's bars: fused
against split exactly equal in float32; every other pair, and every pair in
bfloat16, equal or first parting at a near-tie (the reference arm's loop
re-run to that frame, its hidden row fed to the plain LT). A card arm fails
unless its own kernels' launch counters moved and the other arm's stayed 0.

Then the throughput: the fused and the split loop timed as the JAX script
times the fused one, by the slope between two step budgets (``--frames`` / 2
and ``--frames`` forced frames, temp 0.7), inputs varied per run, best of 3,
host wall clock around the whole program (prepare, glue and the final read
included; the slope cancels what does not grow with the frames).

Usage:
    python -m magpie_tts_tpu_torch.scripts.parity_batched [--batch 32] [--frames 100]
        [--dtype float32|bfloat16] [--skip-parity] [--temp 0.0] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import parity_decode as pd

T_TOKENS = 64
TIMING_TEMP = 0.7
TIMING_REPS = 3


def make_inputs(config, B: int, seed: int) -> dict:
    """The JAX script's inputs: tokens [B, 64] (BOS, ids in [2, 90), EOS,
    zero padding), lengths in [16, 62), speaker 0, keys fold_in(PRNGKey(seed), i)."""
    from ..ops import sampling

    r = np.random.default_rng(seed)
    tokens = np.zeros((B, T_TOKENS), np.int64)
    lens = r.integers(16, T_TOKENS - 2, size=B)
    for i in range(B):
        tokens[i, 0] = config.text_bos_id
        tokens[i, 1:lens[i] - 1] = r.integers(2, 90, size=lens[i] - 2)
        tokens[i, lens[i] - 1] = config.text_eos_id
    base = sampling.prng_key(seed)
    return {"tokens": tokens, "lens": [int(n) for n in lens], "spk": [0] * B,
            "keys": [sampling.fold_in(base, i) for i in range(B)]}


def take(inputs: dict, n: int) -> dict:
    """The first n slots of ``inputs``."""
    return {k: v[:n] for k, v in inputs.items()}


def arm_weights(weights, device: torch.device, dtype) -> tuple:
    """(weights, prepare weights) on ``device`` in ``dtype``, as the lockstep
    engine keeps them."""
    from ..models import magpie as magpie_mod

    w = weights.to(device=device, dtype=dtype)
    return w, magpie_mod.float32_products(w)


def run_program(inputs: dict, w, prep, config, temperature: float, use_fused: bool,
                max_steps: Optional[int] = None, state: bool = False):
    """The lockstep program on ``w``'s device: (codes [B, N, 8], n_frames [B])
    as numpy, or with ``state`` the loop's final state."""
    from ..models import magpie as magpie_mod

    device = w.text_emb.device
    tokens = torch.from_numpy(inputs["tokens"]).to(device)
    if state:
        return magpie_mod.lockstep_loop(tokens, inputs["lens"], inputs["spk"], inputs["keys"],
                                        temperature, w, config, pd.TOP_K, max_steps=max_steps,
                                        use_fused=use_fused, prepare_weights=prep)
    codes, n = magpie_mod.synthesize_codes_batched_program(
        tokens, inputs["lens"], inputs["spk"], inputs["keys"], temperature, w, config,
        pd.TOP_K, max_steps=max_steps, use_fused=use_fused, prepare_weights=prep)
    return codes.cpu().numpy(), n.cpu().numpy()


def run_arm(arm: str, inputs: dict, replica: tuple, config, temperature: float) -> dict:
    """One arm over ``inputs`` (a warm-up first on a card); its launches
    checked. Returns {"codes", "n_frames", "seconds", "launches"}."""
    w, prep = replica
    device = w.text_emb.device
    if device.type == "cuda":
        run_program(take(inputs, 1), w, prep, config, temperature, arm == "fused", max_steps=2)
    pd.reset_launches(batched=True)
    t0 = time.perf_counter()
    codes, n_frames = run_program(inputs, w, prep, config, temperature, arm == "fused")
    dt = time.perf_counter() - t0
    launches = pd.read_launches(batched=True)
    pd.check_launches(arm, device, launches, int(n_frames.max()), batched=True)
    B = len(inputs["lens"])
    pd.log(f"parity_batched: {arm}: B={B} x {int(n_frames.min())}+ frames in {dt:.2f}s = "
           f"{int(n_frames.sum()) / dt:.1f} aggregate fps ({device}, launches {launches})")
    return {"codes": codes, "n_frames": n_frames, "seconds": dt, "launches": launches}


def rerun_hidden(inputs: dict, replica: tuple, config, use_fused: bool, slot: int,
                 frame: int, temperature: float):
    """Slot ``slot``'s hidden row feeding frame ``frame``'s LT (the arm's
    loop re-run for ``frame`` steps), with that frame's seed and forbid flag."""
    from ..models import magpie as magpie_mod
    from ..ops import sampling

    w, prep = replica
    if frame == 0:   # frame 0's hidden row is prepare's BOS step
        tokens = torch.from_numpy(inputs["tokens"]).to(w.text_emb.device)
        with torch.no_grad():
            hidden = magpie_mod.prepare_batch(tokens, inputs["lens"], inputs["spk"], prep,
                                              config)[4]
    else:
        s = run_program(inputs, w, prep, config, temperature, use_fused, max_steps=frame,
                        state=True)
        if s.step != frame or bool(s.done[slot]):
            raise RuntimeError(f"re-run of slot {slot} stopped short of frame {frame}")
        hidden = s.hidden
    seeds, _ = sampling.frame_seeds_batch(np.array(inputs["keys"], np.uint32), frame + 1)
    return hidden[slot], w, int(seeds[frame, slot]), frame < config.min_generated_frames


def run_parity(config, weights, inputs: dict, arms: Sequence[str], device: torch.device,
               dtype=torch.float32, temperature: float = 0.0,
               plain_batch: Optional[int] = None) -> dict:
    """The arms' codes and the slot-by-slot comparisons. Returns {"arms":
    {arm: run_arm's dict}, "pairs": [compare_rows' dicts with "pair",
    "slot"], "near_ties": int, "ok": bool}."""
    replicas, runs = {}, {}
    card = arm_weights(weights, device, dtype) if any(a != "plain" for a in arms) else None
    for arm in arms:
        replicas[arm] = arm_weights(weights, torch.device("cpu"), dtype) if arm == "plain" \
            else card
        arm_inputs = take(inputs, plain_batch) if arm == "plain" and plain_batch else inputs
        runs[arm] = run_arm(arm, arm_inputs, replicas[arm], config, temperature)
    pairs = [(a, b) for a, b in (("fused", "split"), ("plain", "fused"), ("plain", "split"))
             if a in runs and b in runs]
    results = []
    for a, b in pairs:
        exact_only = dtype == torch.float32 and {a, b} == {"fused", "split"}
        ra, rb = runs[a], runs[b]
        n_slots = min(len(ra["n_frames"]), len(rb["n_frames"]))
        ref_inputs = take(inputs, len(ra["n_frames"]))
        for slot in range(n_slots):
            def classify(frame, row_a, row_b, slot=slot, a=a):
                hidden, w, seed, forbid = rerun_hidden(ref_inputs, replicas[a], config,
                                                       a == "fused", slot, frame, temperature)
                return (pd.frame_gaps(hidden, row_a, w, config, seed, temperature, pd.TOP_K,
                                      forbid)
                        + pd.frame_gaps(hidden, row_b, w, config, seed, temperature, pd.TOP_K,
                                        forbid))
            res = pd.compare_rows(f"slot {slot}", a, b, ra["codes"][slot, :ra["n_frames"][slot]],
                                  rb["codes"][slot, :rb["n_frames"][slot]], exact_only,
                                  classify)
            results.append({**res, "pair": f"{a} vs {b}", "slot": slot})
    return {"arms": runs, "pairs": results,
            "near_ties": sum(r["status"] == "NEAR-TIE" for r in results),
            "ok": all(r["ok"] for r in results)}


def time_loop(config, replica: tuple, B: int, n_lo: int, n_hi: int, use_fused: bool,
              reps: int = TIMING_REPS, make=make_inputs) -> dict:
    """The lockstep program's ms a step: the slope between ``n_lo`` and
    ``n_hi`` forced frames at temp 0.7, by the host clock around the whole
    call (prepare, glue and the final read of the codes included), best of
    ``reps`` runs a budget, each on fresh inputs ``make(config, B, seed)``
    after one warm-up run."""
    w, prep = replica
    ts = {}
    for n in (n_lo, n_hi):
        cfg = dataclasses.replace(config, max_dec_steps=n, min_generated_frames=n)
        run_program(make(cfg, B, 1), w, prep, cfg, TIMING_TEMP, use_fused)
        best = float("inf")
        for rep in range(reps):
            inputs = make(cfg, B, 100 + rep)
            t0 = time.perf_counter()
            run_program(inputs, w, prep, cfg, TIMING_TEMP, use_fused)
            best = min(best, time.perf_counter() - t0)
        ts[n] = best
    slope = (ts[n_hi] - ts[n_lo]) / (n_hi - n_lo)
    return {"n_lo": n_lo, "n_hi": n_hi, "t_lo_ms": ts[n_lo] * 1e3, "t_hi_ms": ts[n_hi] * 1e3,
            "ms_a_step": slope * 1e3, "aggregate_fps": B / slope if slope > 0 else float("inf"),
            "clock": "host"}


def timing_line(label: str, t: dict) -> str:
    return (f"{label} batched loop: t({t['n_lo']})={t['t_lo_ms']:.1f}ms "
            f"t({t['n_hi']})={t['t_hi_ms']:.1f}ms -> {t['ms_a_step']:.3f} ms/step "
            f"({t['aggregate_fps']:.0f} aggregate fps)")


def main(argv=None, base_config=None) -> int:
    """``base_config`` (tests): the config whose step budget becomes
    ``--frames`` (default ``MagpieConfig()``)."""
    from ..io.magpie_weights import random_magpie_weights
    from .timing import banner, parse_args

    def build(ap):
        ap.add_argument("--batch", type=int, default=32)
        ap.add_argument("--frames", type=int, default=100)
        ap.add_argument("--dtype", default="float32", choices=tuple(pd.DTYPES))
        ap.add_argument("--skip-parity", action="store_true")
        ap.add_argument("--temp", type=float, default=0.0,
                        help="sampling temperature for the parity check (0 = greedy; >0 "
                             "exercises the in-kernel draw, still expected IDENTICAL at f32 "
                             "between the card's arms)")

    args, device = parse_args(argv, "parity_batched", __doc__, build)
    B, dtype = args.batch, pd.DTYPES[args.dtype]
    config = pd.parity_config(args.frames, base_config)
    weights = random_magpie_weights(config, seed=pd.WEIGHT_SEED)
    pd.log(f"parity_batched: {banner(device)} B={B} frames={args.frames} dtype={args.dtype}")
    ok = True
    if not args.skip_parity:
        res = run_parity(config, weights, make_inputs(config, B, 0), ("fused", "split", "plain"),
                         device, dtype, args.temp)
        for r in res["pairs"]:
            if r["status"] != "EXACT":
                print(r["line"], flush=True)
        mode = "greedy" if args.temp < 0.01 else f"temp={args.temp}"
        for pair in dict.fromkeys(r["pair"] for r in res["pairs"]):
            rows = [r for r in res["pairs"] if r["pair"] == pair]
            ties = sum(r["status"] == "NEAR-TIE" for r in rows)
            verdict = ("IDENTICAL" if all(r["status"] == "EXACT" for r in rows) else
                       f"NEAR-TIES ONLY ({ties} slots)" if all(r["ok"] for r in rows) else
                       "FAILED")
            a = pair.split(" vs ")[0]
            print(f"parity: {pair}: {verdict} over {len(rows)} slots x "
                  f"{int(res['arms'][a]['n_frames'].min())}+ {mode} frames", flush=True)
        ok = res["ok"]
    card = arm_weights(weights, device, dtype)
    for label, fused in (("fused", True), ("split", False)):
        print(timing_line(label, time_loop(config, card, B, args.frames // 2, args.frames,
                                           fused)), flush=True)
    print("parity:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
