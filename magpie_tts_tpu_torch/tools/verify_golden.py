"""Diff two golden-dump directories layer by layer (tools/verify_golden.py).

Given a reference dump tree (the reference engine, a NeMo hook dump in the
same ``.bin`` layout, the JAX package's ``tools/dump_golden.py`` or an
earlier build) and a candidate tree, reports the max / mean abs difference
of every reference tensor against per-component tolerances and exits 1 on
any failure or missing tensor.

Usage:
    python -m magpie_tts_tpu_torch.tools.verify_golden reference_dir candidate_dir \\
        [--tol PREFIX=TOL] [-q]

Default tolerances are the reference's achieved parity bars: encoder 8e-3,
decoder 3e-3, final projection 1e-4, LT codes exact, FSQ exact, codec audio
4.5e-3.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..io.golden import read_golden

# (prefix, max-abs-diff tolerance); first match wins. Exact (0.0) for integer
# dumps stored as float32.
DEFAULT_TOLERANCES = [
    ("tokens", 0.0),
    ("greedy_codes", 0.0),
    ("lt_greedy_codes", 0.0),
    ("codec_latent", 0.0),          # FSQ is exact integer math
    ("text_embedding", 1e-6),
    ("encoder_input", 1e-6),
    ("encoder", 8e-3),              # reference encoder bar
    ("xa_", 3e-3),
    ("decoder_input", 1e-5),
    ("decoder", 3e-3),              # reference decoder bar
    ("final_proj", 1e-4),
    ("lt_logits", 1e-3),
    ("codec_audio", 4.5e-3),        # reference codec bar
    ("codec", 1e-2),                # intermediate stages, pre-tanh scale
]


def tolerance_for(name: str, overrides) -> float:
    for prefix, tol in list(overrides) + DEFAULT_TOLERANCES:
        if name.startswith(prefix):
            return tol
    return 1e-3


def compare_dirs(ref_dir, cand_dir, overrides=(), quiet=False, out=None):
    """Diff every reference .bin against the candidate tree.

    Returns ``(n_ok, n_fail, n_missing, lines)`` where ``lines`` are the
    per-tensor report rows; shared by this CLI and ``tools.acceptance``.
    """
    ref_dir, cand_dir = Path(ref_dir), Path(cand_dir)
    ref_files = sorted(p.stem for p in ref_dir.glob("*.bin"))
    n_fail = n_missing = 0
    lines = []

    def emit(line, failed):
        lines.append(line)
        if out is not None and (failed or not quiet):
            print(line, file=out)

    for name in ref_files:
        cand = cand_dir / f"{name}.bin"
        if not cand.exists():
            emit(f"MISSING  {name}", True)
            n_missing += 1
            continue
        a = read_golden(ref_dir / f"{name}.bin")
        b = read_golden(cand)
        if a.shape != b.shape:
            emit(f"SHAPE    {name}: {a.shape} vs {b.shape}", True)
            n_fail += 1
            continue
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        mx = float(diff.max()) if diff.size else 0.0
        mean = float(diff.mean()) if diff.size else 0.0
        tol = tolerance_for(name, list(overrides))
        ok = mx <= tol
        if not ok:
            n_fail += 1
        emit(f"{'ok' if ok else 'FAIL':7s}  {name:28s} "
             f"max {mx:.3e}  mean {mean:.3e}  (tol {tol:g})", not ok)
    return len(ref_files) - n_fail - n_missing, n_fail, n_missing, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("reference_dir")
    ap.add_argument("candidate_dir")
    ap.add_argument("--tol", action="append", default=[], metavar="PREFIX=TOL",
                    help="override tolerance for dumps matching PREFIX")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="only print failures and the summary")
    args = ap.parse_args(argv)

    overrides = []
    for spec in args.tol:
        prefix, _, tol = spec.partition("=")
        overrides.append((prefix, float(tol)))

    ref_dir, cand_dir = Path(args.reference_dir), Path(args.candidate_dir)
    ref_files = sorted(p.stem for p in ref_dir.glob("*.bin"))
    if not ref_files:
        print(f"verify_golden: no .bin files in {ref_dir}", file=sys.stderr)
        return 2

    n_ok, n_fail, n_missing, _lines = compare_dirs(
        ref_dir, cand_dir, overrides, quiet=args.quiet, out=sys.stdout)

    extra = sorted(set(p.stem for p in cand_dir.glob("*.bin")) - set(ref_files))
    if extra and not args.quiet:
        print(f"note: candidate-only dumps ignored: {', '.join(extra)}")
    print(f"verify_golden: {n_ok}/{len(ref_files)} ok, "
          f"{n_fail} failed, {n_missing} missing")
    return 1 if (n_fail or n_missing) else 0


if __name__ == "__main__":
    sys.exit(main())
