"""H100 counterpart of scripts/opt_int8_attend_probe.py: does an int8 K / V
cache pay in the per-slot attend?

Kernel 14 (csrc/probe_attend.cu, a block per (head, slot)) over a
[8, 640, 768] cache in three modes: ``bf16`` (the K / V dequantized to bf16,
the baseline), ``i8mixed`` (int8 K / V read as is, s_k folded into the
scores and s_v into the probabilities) and ``i8cast`` (int8 K / V
dequantized to bf16 in the kernel before either dot). The inputs and the
quantization are the TPU probe's (default_rng(0); per-row absmax / 127
scales). First the agreement of bf16(dequant) and i8mixed, then ns per
slot-attend at rows 320 and 640, L2-resident and from HBM (see
opt_attend_probe for the harness).

    python -m magpie_tts_tpu_torch.scripts.opt_int8_attend_probe [--device cuda|cpu]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops.kernels import probe_attend
from . import timing
from .opt_attend_probe import D, GB, ROWS, S, agreement, report, slopes


def make_inputs(device) -> dict:
    """{"bf16": ..., "i8": ...} tensors of scripts/opt_int8_attend_probe.py
    main(): q, the int8 K / V with their row scales, and their dequantized
    bf16 values (with zero scales, which the bf16 mode ignores)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((GB, D))).to(device=device, dtype=torch.bfloat16)
    kf = rng.standard_normal((GB, S, D)).astype(np.float32) * 0.1
    vf = rng.standard_normal((GB, S, D)).astype(np.float32) * 0.1
    ks = (np.abs(kf).max(axis=2) / 127.0).astype(np.float32)
    vs = (np.abs(vf).max(axis=2) / 127.0).astype(np.float32)
    kq = np.clip(np.rint(kf / ks[..., None]), -127, 127).astype(np.int8)
    vq = np.clip(np.rint(vf / vs[..., None]), -127, 127).astype(np.int8)
    t = lambda a, dt=None: torch.from_numpy(a).to(device=device, dtype=dt)
    zs = torch.zeros(GB, S, dtype=torch.float32, device=device)
    return {"bf16": {"q": q, "k": t(kq * ks[..., None], torch.bfloat16),
                     "v": t(vq * vs[..., None], torch.bfloat16), "sk": zs, "sv": zs},
            "i8": {"q": q, "k": t(kq), "v": t(vq), "sk": t(ks), "sv": t(vs)}}


def inputs_for(mode: str, x: dict) -> dict:
    return x["bf16"] if mode == "bf16" else x["i8"]


def main(argv=None) -> int:
    device, _ = timing.parse_device(argv, "opt_int8_attend_probe", __doc__)
    print(timing.banner(device), file=sys.stderr)
    x = make_inputs(device)
    a = probe_attend.attend(*(x["bf16"][n] for n in ("q", "k", "v", "sk", "sv")), 320, 1, "bf16")
    b = probe_attend.attend(*(x["i8"][n] for n in ("q", "k", "v", "sk", "sv")), 320, 1,
                            "i8mixed")
    print("bf16(dequant)-vs-i8mixed max abs diff:", float((a - b).abs().max()), "of scale",
          float(a.abs().max()), file=sys.stderr)
    for mode in ("bf16", "i8mixed", "i8cast"):
        print(json.dumps({"probe": "opt_int8_attend_probe",
                          "agreement": agreement(mode, 320, 1, inputs_for(mode, x))}), flush=True)
        for rows in ROWS:
            res = slopes(mode, rows, inputs_for(mode, x), device)
            print(report(res), file=sys.stderr, flush=True)
            print(json.dumps({"probe": "opt_int8_attend_probe", "device": str(device), **res}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
