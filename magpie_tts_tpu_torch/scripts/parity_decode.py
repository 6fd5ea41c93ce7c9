"""Whole-utterance greedy parity on the H100 (scripts/parity_decode.py): the
fused frame kernel, the split kernels and the plain PyTorch loop, at the
VERDICT bar of >= 3 texts x >= 300 frames, plus fps for each arm.

Arms (the JAX script's ``paths``), each a ``MagpieEngine`` at 357M width on
random weights (``random_magpie_weights(config, seed=0)``), every run with
``seed=17``:

  fused  ``use_fused=True`` on --device: kernel A once a frame
  split  ``use_fused=False``: kernels 4 and 5 a frame
  plain  the same engine on the CPU, where every wrapper runs its plain
         version (the JAX script's ``xla`` arm; no switch on the card's path)

A card arm fails unless its own kernels' launch counters moved and the
other arm's stayed at 0. Bars, pair by pair and text by text:

- float32, fused against split: codes and lengths exactly equal (kernel 4 is
  kernel A's LT phases, 5 its decoder: one code path);
- every other pair, and every pair in bfloat16: exactly equal, or the first
  differing frame is a near-tie. A near-tie (chip_smoke.py's ``lt_flips``
  rule) is a frame whose every differing code loses to the plain LT's winner
  by less than one bf16 ulp of the winner's logit (at temp >= 0.01, of the
  Gumbel score times temp), or at temp >= 0.01 crossed the exact top-k set's
  edge: the code entered the set from within one bf16 ulp below its k-th
  logit, or the winner left it, lying within one ulp above the best logit
  outside the set, and the code is the runner-up (``frame_gaps``); the
  plain LT is fed the reference arm's own hidden state at that frame (the
  reference arm re-run to it). The script prints that frame and its gaps
  and compares that text no further. A float32 sum
  on the card runs in another order than on the CPU, so a card arm and the
  plain arm can part at a tie; none is expected in float32.

Usage:
    python -m magpie_tts_tpu_torch.scripts.parity_decode [--frames 300]
        [--dtype float32|bfloat16] [--texts 3] [--skip-split] [--temp 0.0]
        [--device cuda|cpu]

Exit code 0 on ``parity: PASS``, 1 on ``FAIL``. ``run_parity(...,
plain_texts=N)`` runs the plain arm on the first N texts only.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TEXT_SEED, RUN_SEED, WEIGHT_SEED = 7, 17, 0
TOP_K = 80


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parity_config(frames: int, base=None):
    """``base`` (default ``MagpieConfig()``) with ``frames`` forced frames."""
    from ..config import MagpieConfig

    return dataclasses.replace(base if base is not None else MagpieConfig(),
                               max_dec_steps=frames, min_generated_frames=frames)


def make_token_lists(config, n_texts: int) -> List[List[int]]:
    """The JAX script's token lists: 20-44 ids in [2, 90) between BOS and EOS."""
    rng = np.random.default_rng(TEXT_SEED)
    out = []
    for _ in range(n_texts):
        n = int(rng.integers(20, 45))
        out.append([config.text_bos_id] + [int(t) for t in rng.integers(2, 90, size=n)]
                   + [config.text_eos_id])
    return out


# ------------------------------------------------------------- near-ties


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (0 at 0)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def frame_gaps(hidden: torch.Tensor, codes: Sequence[int], weights, config, seed: int,
               temperature: float, top_k: int, forbid_eos: bool) -> list:
    """The codes of one frame that differ from the plain LT sampler's winner
    on ``hidden``, the sampler fed ``codes``' own earlier codebooks, as
    (codebook, gap, ulp, kind). A differing code is a near-tie when gap < ulp.

    kind "argmax": gap is the winner's score minus the code's (in logits; at
    temp >= 0.01 the Gumbel score times temp), ulp one bf16 ulp of the
    winner's logit (chip_smoke.py's ``lt_flips``). At temp >= 0.01 the exact
    top-k set decides which codes may win, and its edge is the gap between
    the k-th logit and the largest logit outside the set. When the argmax
    gap is not a near-tie, the kind is "top-k edge" if the code entered the
    set or the winner left it: (a) the code lies outside the plain set and
    the k-th logit minus the code's is the gap, or (b) the code is the
    runner-up (the best score without the winner) and the winner's logit
    minus the largest logit outside the set is the gap; ulp is one bf16 ulp
    of the k-th logit. A code inside the set that is not the runner-up, the
    k-th itself included, has no edge to cross: it keeps its argmax gap."""
    from ..models import local_transformer as lt_mod
    from ..ops import sampling
    from ..ops.precision import matmul_f32

    c, lt, dev = config, weights.lt, hidden.device
    mask = sampling.forbidden_token_mask(c.vocab_per_cb, c.audio_bos_id, device=dev)
    seq = torch.zeros(lt_mod._MAX_SEQ, c.lt_dim, dtype=hidden.dtype, device=dev)
    seq[0] = lt_mod._in_proj(hidden, lt)
    cols = torch.arange(c.vocab_per_cb, device=dev)
    k = min(top_k, c.vocab_per_cb)
    sampled = temperature >= sampling.GREEDY_TEMP_THRESHOLD
    gaps = []
    for cb in range(c.num_codebooks):
        h = lt_mod._lt_layer_f32(seq, lt, c)[cb]
        logits = matmul_f32(h.to(hidden.dtype), lt.out_proj_w[cb]) + lt.out_proj_b[cb].float()
        logits = sampling.mask_logits(logits, mask, bool(forbid_eos), c.audio_eos_id)
        z, scale = logits, 1.0
        if sampled:
            in_topk = sampling.exact_topk_mask(logits, k)
            g = sampling.gumbel_from_seed(sampling.phase_seed(int(seed), cb).to(dev), cols)
            z = torch.where(in_topk, logits / temperature + g,
                            torch.full_like(logits, sampling.NEG_INF))
            scale = temperature
        want, got = int(torch.argmax(z)), int(codes[cb])
        if got != want:
            entry = (cb, float(z[want] - z[got]) * scale, bf16_ulp(float(logits[want])),
                     "argmax")
            if entry[1] >= entry[2] and sampled and not bool(in_topk.all()):
                neg = torch.full_like(logits, sampling.NEG_INF)
                kth = float(torch.where(in_topk, logits, -neg).min())
                first_out = float(torch.where(in_topk, neg, logits).max())
                runner_up = int(torch.argmax(torch.where(cols == want, neg, z)))
                edge = (kth - float(logits[got]) if not bool(in_topk[got]) else
                        float(logits[want]) - first_out if got == runner_up else None)
                if edge is not None and edge < bf16_ulp(kth):
                    entry = (cb, edge, bf16_ulp(kth), "top-k edge")
            gaps.append(entry)
        if cb < c.num_codebooks - 1:
            seq[cb + 1] = lt_mod._in_proj(weights.audio_emb[cb, got], lt)
    return gaps


def is_near_tie(gaps: list) -> bool:
    return bool(gaps) and all(g[1] < g[2] for g in gaps)


def compare_rows(label: str, a_name: str, b_name: str, a: np.ndarray, b: np.ndarray,
                 exact_only: bool, classify: Callable[[int, np.ndarray, np.ndarray], list]
                 ) -> dict:
    """One text's (or slot's) codes of two arms: EXACT, NEAR-TIE (the first
    differing frame a near-tie by ``classify(frame, a_row, b_row)``, which
    returns the gaps of both rows against the reference's plain LT) or
    MISMATCH. Returns {"ok", "status", "line", "frame", "gaps"}."""
    n = min(len(a), len(b))
    eq = np.all(a[:n] == b[:n], axis=1)
    if len(a) == len(b) and bool(eq.all()):
        return {"ok": True, "status": "EXACT", "frame": None, "gaps": [],
                "line": f"parity: {a_name} vs {b_name}, {label}: EXACT ({n}/{n} frames equal, "
                        f"lens {len(a)}/{len(b)})"}
    diff = np.where(~eq)[0]
    first = int(diff[0]) if len(diff) else n
    gaps = classify(first, a[first], b[first]) if first < n else []
    near = first < n and is_near_tie(gaps)
    status = "NEAR-TIE" if near else "MISMATCH"
    ok = near and not exact_only
    line = (f"parity: {a_name} vs {b_name}, {label}: {status} ({first}/{n} frames equal before "
            f"frame {first}, lens {len(a)}/{len(b)})" if near else
            f"parity: {a_name} vs {b_name}, {label}: {status} ({int(eq.sum())}/{n} frames "
            f"equal, lens {len(a)}/{len(b)})")
    if first < n:
        line += (f"\n  first mismatched frame: {first}  a={a[first].tolist()}  "
                 f"b={b[first].tolist()}  gaps (codebook, gap, ulp, kind): {gaps}")
    if near and exact_only:
        line += "\n  (this pair must be exact)"
    return {"ok": ok, "status": status, "line": line, "frame": first, "gaps": gaps}


# ------------------------------------------------------------- launch counters


def arm_kernels(arm: str, batched: bool = False) -> Dict[str, object]:
    """{name: wrapper module} of the kernels an arm launches on a card."""
    if batched:
        from ..ops.kernels import decoder_step_batched, frame_step_batched, lt_sampler_batched

        return ({"C": frame_step_batched} if arm == "fused" else
                {"7": lt_sampler_batched, "8": decoder_step_batched})
    from ..ops.kernels import decoder_step, frame_step, lt_sampler

    return {"A": frame_step} if arm == "fused" else {"4": lt_sampler, "5": decoder_step}


def all_kernels(batched: bool = False) -> Dict[str, object]:
    return {**arm_kernels("fused", batched), **arm_kernels("split", batched)}


def reset_launches(batched: bool = False) -> None:
    for mod in all_kernels(batched).values():
        mod.launches = 0


def read_launches(batched: bool = False) -> Dict[str, int]:
    return {k: int(mod.launches) for k, mod in all_kernels(batched).items()}


def check_launches(arm: str, device: torch.device, launches: Dict[str, int], least: int,
                   batched: bool = False) -> None:
    """A card arm launched each of its kernels at least ``least`` times and
    none of the other arm's; a CPU arm launched nothing."""
    own = set(arm_kernels(arm, batched)) if device.type == "cuda" else set()
    bad = {k: n for k, n in launches.items() if (n < least if k in own else n != 0)}
    if bad:
        raise RuntimeError(f"{arm} arm on {device}: launches {launches} (wanted >= {least} "
                           f"of {sorted(own)} and none of the others)")


# ------------------------------------------------------------- the arms


def make_engine(arm: str, weights, config, device: torch.device, dtype):
    """The arm's engine: the plain arm's on the CPU."""
    from ..runtime.engine import MagpieEngine

    return MagpieEngine(weights, config, device="cpu" if arm == "plain" else device,
                        compute_dtype=dtype, use_fused=arm != "split")


def run_arm(arm: str, engine, token_lists, temperature: float, warmup: bool = True) -> dict:
    """Every text through ``engine.synthesize_codes`` (seed 17); the launch
    counters reset after the warm-up (text 0, card arms only). Returns
    {"codes": [np.ndarray], "frames", "seconds", "fps", "launches"}."""
    if warmup and engine.device.type == "cuda" and token_lists:
        t0 = time.perf_counter()
        engine.synthesize_codes(token_lists[0], temperature=temperature, top_k=TOP_K,
                                seed=RUN_SEED)
        log(f"parity: {arm} warm-up {time.perf_counter() - t0:.1f}s")
    reset_launches()
    codes, total = [], 0
    t0 = time.perf_counter()
    for toks in token_lists:
        r = engine.synthesize_codes(toks, temperature=temperature, top_k=TOP_K, seed=RUN_SEED)
        codes.append(np.asarray(r.codes))
        total += r.n_frames
    dt = time.perf_counter() - t0
    launches = read_launches()
    check_launches(arm, engine.device, launches, total)
    log(f"parity: {arm}: {total} frames in {dt:.2f}s = {total / dt:.1f} fps "
        f"({engine.device}, launches {launches})")
    return {"codes": codes, "frames": total, "seconds": dt, "fps": total / dt,
            "launches": launches}


def rerun_hidden(engine, token_ids, frame: int, temperature: float):
    """The hidden state that feeds frame ``frame``'s LT in ``engine``'s loop
    (the loop re-run to it), with that frame's seed and forbid flag."""
    from ..io.magpie_weights import materialize_weights
    from ..models import magpie as magpie_mod
    from ..ops import sampling

    c = engine.config
    tokens, n = engine._pad_tokens(token_ids)
    key = sampling.prng_key(RUN_SEED)
    weights = materialize_weights(engine.weights)
    with torch.no_grad():
        xa_k, xa_v, state = magpie_mod.prepare(tokens, n, 0, engine.prepare_weights or weights, c)
        state = magpie_mod.decode_loop(xa_k, xa_v, state, n, weights, c, key, temperature,
                                       TOP_K, use_fused=engine.use_fused,
                                       int8_stream=engine.int8_stream, target_frames=frame)
    if state.frame_idx != frame or state.done:
        raise RuntimeError(f"re-run stopped at frame {state.frame_idx}, not {frame}")
    return (state.hidden, weights, sampling.frame_seeds(key, frame + 1)[frame],
            frame < c.min_generated_frames)


def run_parity(config, weights, token_lists, arms: Sequence[str], device: torch.device,
               dtype=torch.float32, temperature: float = 0.0,
               plain_texts: Optional[int] = None) -> dict:
    """The arms' codes and the comparisons. ``plain_texts``: the plain arm
    runs the first N texts only. Returns {"arms": {arm: run_arm's dict},
    "pairs": [compare_rows' dicts with "pair", "text"], "near_ties": int,
    "ok": bool}."""
    engines, runs = {}, {}
    for arm in arms:
        texts = token_lists if arm != "plain" or plain_texts is None else \
            token_lists[:plain_texts]
        engines[arm] = make_engine(arm, weights, config, device, dtype)
        runs[arm] = run_arm(arm, engines[arm], texts, temperature)
    pairs = [(a, b) for a, b in (("fused", "split"), ("plain", "fused"), ("plain", "split"))
             if a in runs and b in runs]
    results = []
    for a, b in pairs:
        exact_only = dtype == torch.float32 and {a, b} == {"fused", "split"}
        for i, (ca, cb) in enumerate(zip(runs[a]["codes"], runs[b]["codes"])):
            def classify(frame, row_a, row_b, i=i, a=a):
                hidden, w, seed, forbid = rerun_hidden(engines[a], token_lists[i], frame,
                                                       temperature)
                return (frame_gaps(hidden, row_a, w, config, seed, temperature, TOP_K, forbid)
                        + frame_gaps(hidden, row_b, w, config, seed, temperature, TOP_K, forbid))
            res = compare_rows(f"text {i}", a, b, ca, cb, exact_only, classify)
            results.append({**res, "pair": f"{a} vs {b}", "text": i})
    return {"arms": runs, "pairs": results,
            "near_ties": sum(r["status"] == "NEAR-TIE" for r in results),
            "ok": all(r["ok"] for r in results)}


def main(argv=None, base_config=None) -> int:
    """``base_config`` (tests): the config whose ``max_dec_steps`` /
    ``min_generated_frames`` become ``--frames`` (default ``MagpieConfig()``)."""
    from ..io.magpie_weights import random_magpie_weights
    from .timing import banner, parse_args

    def build(ap):
        ap.add_argument("--frames", type=int, default=300)
        ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
        ap.add_argument("--texts", type=int, default=3)
        ap.add_argument("--skip-split", action="store_true",
                        help="skip the separate-kernels (non-fused) path")
        ap.add_argument("--temp", type=float, default=0.0,
                        help="sampling temperature; temp>0 exercises the shared "
                             "deterministic counter-based sampler (exact top-k + seeded "
                             "Gumbel), which must also be bit-equal across the card's "
                             "paths at f32")

    args, device = parse_args(argv, "parity_decode", __doc__, build)
    dtype = DTYPES[args.dtype]
    config = parity_config(args.frames, base_config)
    weights = random_magpie_weights(config, seed=WEIGHT_SEED)
    log(f"parity: {banner(device)} dtype={args.dtype} frames={args.frames} "
        f"texts={args.texts} temp={args.temp}")
    arms = ["fused", "plain"] if args.skip_split else ["fused", "split", "plain"]
    res = run_parity(config, weights, make_token_lists(config, args.texts), arms, device,
                     dtype, args.temp)
    for r in res["pairs"]:
        print(r["line"], flush=True)
    print(f"parity: near-ties {res['near_ties']}; fps " + ", ".join(
        f"{arm} {run['fps']:.1f}" for arm, run in res["arms"].items()), flush=True)
    print("parity:", "PASS" if res["ok"] else "FAIL", flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
