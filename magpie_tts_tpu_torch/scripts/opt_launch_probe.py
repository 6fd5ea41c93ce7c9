"""H100 counterpart of scripts/opt_launch_probe.py: what does a launch cost,
and what do more blocks and a streamed weight add?

Kernel 17 (csrc/probe_copy.cu): the copy kernel on [32, 768] bf16 at grid 1,
8 and 20, then at grid 8 with a [8, 512, 1024] bf16 weight of which each
block reads its own 1 MB slab (the TPU probe's per-step block DMA), chained
launch after launch as the TPU probe's ``fori_loop`` chains ITERS = 100. The
TPU's grid steps run in order on one core; here they are thread blocks that
run at once, so the grid measures a launch plus block scheduling. Each line
gives the CUDA-graph slope (device time a launch) and the eager slope (as
issued from Python) over N_LO / N_HI launches, and the chained result after
ITERS launches against the plain version's (from zeros at grid 8: 764, the
bf16 spacing above 256 being 2). The streamed line also gives the slope with
the weight rotated past the 50 MB L2.

The TPU script's "LT shell (all ablated)" arm is not ported: it times kernel
7 under trace-time ablation knobs whose outputs are wrong by design
(ROADMAP.md, "Not ported: removals").

    python -m magpie_tts_tpu_torch.scripts.opt_launch_probe [--device cuda|cpu]
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops.kernels import probe_copy
from . import timing
from .opt_slope_probe import copy_yardsticks

ITERS = 100
N_LO, N_HI = 50, 450
B = 32
WIDTH = 768
DTYPE = torch.bfloat16


def minimal_probe(B: int, grid_n: int, streamed_mb: int = 0, device="cuda"):
    """(body, x0, slab): the chained copy at ``grid_n`` blocks, x0 zeros, and
    with ``streamed_mb`` a zero [grid_n, 512, 1024] bf16 weight (as the TPU
    probe's)."""
    x0 = torch.zeros(B, WIDTH, dtype=DTYPE, device=device)
    slab = (torch.zeros(grid_n, 512, 1024, dtype=DTYPE, device=device) if streamed_mb
            else None)

    def body(i, h, slabs=(slab,)):
        return probe_copy.copy(h, grid_n, slab=slabs[i % len(slabs)])[0]

    return body, x0, slab


def run(label: str, B: int, grid_n: int, streamed_mb: int, device, n_lo: int = N_LO,
        n_hi: int = N_HI, reps: int = timing.REPS, iters: int = ITERS) -> dict:
    body, x0, slab = minimal_probe(B, grid_n, streamed_mb, device)
    got = timing.chain(body, x0, iters)
    want, slab_cpu = x0.cpu(), None if slab is None else slab.cpu()
    for _ in range(iters):
        want = probe_copy.copy_reference(want, grid_n, slab=slab_cpu)[0]
    res = {"probe": label, "grid_n": grid_n, "streamed_mb": streamed_mb,
           "chained_value": float(got.float().reshape(-1)[0]),
           "bit_equal_plain": bool(torch.equal(got.cpu(), want))}
    res["graph"] = timing.graph_slope(body, x0, n_lo, n_hi, reps)
    res["eager"] = timing.eager_slope(body, x0, n_lo, n_hi, reps)
    if slab is not None:
        ring = [slab] + [slab.clone() for _ in range(
            timing.copies_past_l2(slab.numel() * 2) - 1)]
        res["graph_hbm"] = timing.graph_slope(lambda i, h: body(i, h, ring), x0, n_lo, n_hi,
                                              reps)
        res["hbm_copies"] = len(ring)
        del ring
    res.update(copy_yardsticks(device, x0, grid_n, n_lo, n_hi, reps, slab=slab))
    line = (f"{label:44s} graph {timing.fmt(res['graph'])} | eager {timing.fmt(res['eager'])}"
            f" | after {iters}: {res['chained_value']} (plain equal {res['bit_equal_plain']})")
    if slab is not None:
        line += f" | HBM ({res['hbm_copies']} copies) {timing.fmt(res['graph_hbm'])}"
    line += (f" | plain {res['plain_ms'] * 1e3:.1f} us, torch.add "
             f"{res['library']['per_launch_ms'] * 1e3:.3f} us, bound "
             f"{res['bound']['bound_ms'] * 1e3:.3f} us")
    print(line, file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    device, _ = timing.parse_device(argv, "opt_launch_probe", __doc__)
    print(timing.banner(device), file=sys.stderr)
    with torch.no_grad():
        for grid_n in (1, 8, 20):
            run(f"minimal copy kernel grid=({grid_n},)", B, grid_n, 0, device)
        run("minimal + 1MB streamed block/step grid=(8,)", B, 8, 1, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
