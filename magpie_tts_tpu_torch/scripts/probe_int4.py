"""H100 counterpart of scripts/probe_int4.py: does a 4-bit weight pay in a
launch-sized GEMV?

Times x [8, 768] bf16 @ W [768, 3072] with W held as native int4 (kernel 11),
packed two nibbles per int8 (kernel 12) and bf16 (kernel 13), each widened in
the kernel (csrc/probe_gemv.cu), three ways: the CUDA-event mean of 30 calls
(best of 3, the probe's ``timed``); the CUDA-graph slope with the weight
resident in the 50 MB L2 (the same buffer every launch); the graph slope with
the weight streamed from HBM (a rotation over enough copies to pass the L2).
Beside them: the bound (bytes over 3.35 TB/s), the plain version's time,
one ``torch.matmul`` of bf16 x and the bf16 weight (cuBLAS; for the nibble
formats on the weight widened up front, four times their bytes) and the main
path's batched GEMM (``batched_gemm.batched_gemm`` on the bf16 weight at
B = 8: its split-K partials, not reduced), timed by graph slope L2-resident
and from HBM; the plan (``plan_gemv``) and the median of STAMP_RUNS
launches' phase stamps (``phase_us``). ``--k`` sets the inner width (the TPU
probe's is 768; 256 to 1024 in steps of 256).

    python -m magpie_tts_tpu_torch.scripts.probe_int4 [--k 768 ...] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops.kernels import batched_gemm, probe_gemv
from . import timing

IN, OUT = 768, 3072
N_LO, N_HI = 50, 450  # graph-slope launch counts
TIMED_N = 30
STAMP_RUNS = 5  # stamped launches whose phases are read (their median)


def make_inputs(device, k: int = IN) -> dict:
    """The probe's inputs, from numpy as scripts/probe_int4.py makes them
    (there k = 768): x = ones [8, k]; int weights default_rng(0).integers(-8,
    8) for both nibble formats; bf16 weights default_rng(0).normal. {fmt: (x,
    stored weight, the weight as bf16 values, the exact int weights or
    None)}."""
    x = torch.ones(probe_gemv.M, k, dtype=torch.bfloat16, device=device)
    w = np.random.default_rng(0).integers(-8, 8, size=(k, OUT))
    wb = torch.from_numpy(w.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    wn = torch.from_numpy(np.random.default_rng(0).normal(size=(k, OUT))).to(
        device=device, dtype=torch.bfloat16)
    return {"native_int4": (x, torch.from_numpy(probe_gemv.pack_native_int4(w)).to(device), wb,
                            w),
            "packed_int8": (x, torch.from_numpy(probe_gemv.pack_int8(w)).to(device), wb, w),
            "bf16": (x, wn, wn, None)}


def timed(fn, device, n: int = TIMED_N) -> float:
    """Best of 3 means of n calls (ms), as the TPU probe's ``timed``."""
    return min(timing.event_mean(fn, n, warmup=1, device=device) for _ in range(3))


STORAGE = {torch.uint8: "native_int4", torch.int8: "packed_int8", torch.bfloat16: "bf16"}


def gemv_work(w: torch.Tensor) -> tuple:
    """(bytes, flops) of one call: the stored weight, x and the output once."""
    K, N, _ = probe_gemv.dims(w, STORAGE[w.dtype])
    nbytes = w.numel() * w.element_size() + probe_gemv.M * K * 2 + probe_gemv.M * N * 4
    return nbytes, 2.0 * probe_gemv.M * K * N


def probe(fmt: str, device, n_lo: int = N_LO, n_hi: int = N_HI, reps: int = timing.REPS,
          timed_n: int = TIMED_N, k: int = IN) -> dict:
    """One format at inner width k: error, times (event mean, graph L2,
    graph HBM), plain, cuBLAS, the main path's batched GEMM, bound, the plan
    and, on a card, phase stamps. Times in ms."""
    x, w, wb, wint = make_inputs(device, k)[fmt]
    out = probe_gemv.gemv(x, w, fmt)
    plain = probe_gemv.gemv_reference(x, w, fmt)
    ref = (np.ones((probe_gemv.M, k), np.float32) @ wint.astype(np.float32)
           if wint is not None else plain.cpu().numpy())
    got = out.cpu().numpy()
    plan = probe_gemv.plan_gemv(fmt, k, OUT)
    res = {"format": fmt, "k": k, "n": OUT, "max_abs_err": float(np.abs(got - ref).max()),
           "max_abs_ref": float(np.abs(ref).max()),
           "bit_equal_plain": bool(torch.equal(out, plain))}
    copies = [w] + [w.clone() for _ in range(timing.copies_past_l2(w.numel() * w.element_size())
                                             - 1)]
    libw = [wb] + [wb.clone() for _ in range(timing.copies_past_l2(wb.numel() * 2) - 1)]
    kernel = lambda i, h, ws=(w,): probe_gemv.gemv(x, ws[i % len(ws)], fmt)
    library = lambda i, h, ws=(wb,): torch.matmul(x, ws[i % len(ws)])
    res["ms"] = timed(lambda: probe_gemv.gemv(x, w, fmt), device, timed_n)
    res["graph_l2_ms"] = timing.graph_slope(kernel, out, n_lo, n_hi, reps)["per_launch_ms"]
    res["graph_hbm_ms"] = timing.graph_slope(
        lambda i, h: kernel(i, h, copies), out, n_lo, n_hi, reps)["per_launch_ms"]
    res["hbm_copies"] = len(copies)
    res["plain_ms"] = timing.event_mean(lambda: probe_gemv.gemv_reference(x, w, fmt),
                                        max(2, timed_n // 10), warmup=1, device=device)
    res["library_ms"] = timed(lambda: torch.matmul(x, wb), device, timed_n)
    res["library_graph_l2_ms"] = timing.graph_slope(library, out, n_lo, n_hi,
                                                    reps)["per_launch_ms"]
    res["library_graph_hbm_ms"] = timing.graph_slope(
        lambda i, h: library(i, h, libw), out, n_lo, n_hi, reps)["per_launch_ms"]
    # the main path's GEMM (kernels C, 7, 8) on the bf16 weight: split-K
    # partials [splits, 8, N], reduced by the next kernel of a frame, not here
    main = lambda i, h, ws=(wb,): batched_gemm.batched_gemm(x, k, OUT, w=ws[i % len(ws)],
                                                            dtype=torch.bfloat16)
    res["main_gemm_ms"] = timing.graph_slope(main, out, n_lo, n_hi, reps)["per_launch_ms"]
    res["main_gemm_hbm_ms"] = timing.graph_slope(
        lambda i, h: main(i, h, libw), out, n_lo, n_hi, reps)["per_launch_ms"]
    res["main_gemm_splits"] = batched_gemm.plan_gemm(k, OUT).splits
    res["plan"] = {"tile": plan.tile, "tiles": plan.tiles, "splits": plan.splits,
                   "kchunk": plan.kchunk, "ctas": plan.ctas}
    if device.type == "cuda":
        runs = [probe_gemv.gemv_stamps(x, w, fmt) for _ in range(STAMP_RUNS)]
        res["stamped_bit_equal"] = all(bool(torch.equal(o, out)) for o, _ in runs)
        phases = [probe_gemv.read_phases(st) for _, st in runs]
        res["phase_us"] = {key: float(np.median([ph[key] for ph in phases]))
                           for key in phases[0]}
    res.update(timing.bound(*gemv_work(w)))
    del copies, libw
    return res


LABELS = {"bf16": "bf16     ", "native_int4": "native i4", "packed_int8": "packed i8"}


def report(res: dict) -> str:
    us = lambda k: f"{res[k] * 1e3:8.3f}"
    widened = " on the widened weight (4x the bytes)" if res["format"] != "bf16" else ""
    p = res["plan"]
    return (f"{LABELS[res['format']]} K {res['k']}: {us('ms')} us event mean, {us('graph_l2_ms')} "
            f"us graph (L2), {us('graph_hbm_ms')} us graph (HBM, {res['hbm_copies']} copies)  "
            f"(max err {res['max_abs_err']}); plan {p['tiles']} tiles x {p['splits']} splits; "
            f"plain {us('plain_ms')} us; cuBLAS bf16{widened} {us('library_ms')} / "
            f"{us('library_graph_l2_ms')} / {us('library_graph_hbm_ms')} us; main-path GEMM "
            f"({res['main_gemm_splits']} split-K partials, not reduced) {us('main_gemm_ms')} / "
            f"{us('main_gemm_hbm_ms')} us; bound {us('bound_ms')} us ({res['bound_by']})")


def main(argv=None) -> int:
    args, device = timing.parse_args(
        argv, "probe_int4", __doc__,
        lambda ap: ap.add_argument("--k", type=int, nargs="+", default=[IN],
                                   help="inner widths (multiples of 256 in [256, 1024])"))
    for k in args.k:
        print(f"{timing.banner(device)} [{k}x{OUT} weight, widened in the kernel]",
              file=sys.stderr)
        for fmt in ("bf16", "native_int4", "packed_int8"):
            res = probe(fmt, device, k=k)
            print(report(res), flush=True)
            print(json.dumps({"probe": "probe_int4", "device": str(device), **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
