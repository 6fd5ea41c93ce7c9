"""H100 counterpart of scripts/opt_attend_probe.py: which work decomposition
of the per-slot attend suits the card?

Kernel 18 (csrc/probe_attend.cu) in two orientations over a [8, 640, 768]
bf16 K / V cache, 12 heads of 64: ``tr`` (a block per (head, slot), warps
walking the rows through the head's 64-wide slice, as kernel C attends
today) and ``cur`` (a block per slot, one contiguous 768-wide read scores
all heads of a row). First their agreement, then ns per slot-attend at rows
320 and 640 by the CUDA-graph slope over 64 and 1024 launches (each launch
one attend of all 8 slots, added into the output as the TPU kernel's grid
steps add), twice: with one K / V copy, resident in the 50 MB L2 (the TPU
probe's compute-only question), and rotating over copies past the L2 (the
decode loop's case). Beside them: the eager slope, the plain version, and
two yardsticks timed the same two ways on the same K / V:
``F.scaled_dot_product_attention`` on the strided head view of the same
memory (with the kernels it launched: a copy kernel there means it copied
the view), and the main path's attention (ops/kernels/decode_attention.py,
the frame kernels' two launches, q as float32).

    python -m magpie_tts_tpu_torch.scripts.opt_attend_probe [--device cuda|cpu]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels import decode_attention, probe_attend
from . import timing

D, H, S, GB = 768, 12, 640, 8
DH = D // H
I_LO, I_HI = 64, 1024  # launches of the two graphs
ROWS = (320, 640)


def make_inputs(device) -> dict:
    """scripts/opt_attend_probe.py main()'s inputs, from default_rng(0)."""
    rng = np.random.default_rng(0)
    bf = lambda a: torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)
    q = bf(rng.standard_normal((GB, D)))
    k = bf(rng.standard_normal((GB, S, D)) * 0.1)
    v = bf(rng.standard_normal((GB, S, D)) * 0.1)
    return {"q": q, "k": k, "v": v, "sk": None, "sv": None}


def attend_work(mode: str, rows: int) -> tuple:
    """(bytes, flops) of one launch: K and V rows (int8 + two float32 scales
    a row in the i8 modes), q and the output (read and written)."""
    kv = 1 if mode in probe_attend.INT8_MODES else 2
    per_row = 2 * D * kv + (8 if mode in probe_attend.INT8_MODES else 0)
    nbytes = GB * (rows * per_row + D * 2 + 2 * D * 4)
    return nbytes, GB * 2.0 * 2 * rows * D


def agreement(mode: str, rows: int, iters: int, x: dict) -> dict:
    """Kernel (or, on the CPU, plain) against the plain version."""
    args = (x["q"], x["k"], x["v"], x["sk"], x["sv"], rows)
    got = probe_attend.attend(*args, iters, mode)
    want = probe_attend.attend_reference(*args, iters, mode)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return {"mode": mode, "rows": rows, "iters": iters, "max_abs_err": err, "max_abs": scale,
            "rel_err": err / scale}


def library_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rows: int) -> torch.Tensor:
    """The library yardstick: ``F.scaled_dot_product_attention`` on bf16 q
    [G, D] and the strided head view of ``k[:, :rows]`` / ``v[:, :rows]``
    (bf16) -> [G, D] bf16."""
    G, _, D = k.shape
    heads = lambda t: t[:, :rows].view(G, rows, D // DH, DH).transpose(1, 2)
    return F.scaled_dot_product_attention(q.view(G, D // DH, 1, DH), heads(k),
                                          heads(v)).reshape(G, D)


def sdpa_kernels(x: dict, rows: int) -> list:
    """Names of the CUDA kernels one ``library_sdpa`` call launches (the
    profiler; empty where it records none)."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            library_sdpa(x["q"], x["k"], x["v"], rows)
            torch.cuda.synchronize()
        return sorted({e.name for e in prof.events() if e.device_type.name == "CUDA"})
    except Exception as e:  # the profiler is a yardstick's detail, not the probe's result
        return [f"not measured ({type(e).__name__}: {e})"]


def _rotation(x: dict, mode: str) -> list:
    """K / V (and scale) copies past the L2, the first the original."""
    per = sum(x[n].numel() * x[n].element_size() for n in ("k", "v"))
    n = timing.copies_past_l2(per)
    clone = lambda t: t.clone() if t is not None else None
    return [x] + [{**x, **{n_: clone(x[n_]) for n_ in ("k", "v", "sk", "sv")}}
                  for _ in range(n - 1)]


def main_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rows: int) -> torch.Tensor:
    """The main path's attention yardstick: ``decode_attention`` (the frame
    kernels' two-launch attention, alone) on q as float32 [G, D] and bf16
    K / V -> [G, D] float32 (values in bf16)."""
    return decode_attention.decode_attention(q.float(), k, v, k.shape[2] // DH,
                                             probe_attend.INV, rows=rows)


def _bf16_kv(y: dict, mode: str) -> tuple:
    """The bf16 K / V the yardsticks read: as they are, or in the i8 modes
    their dequantized values (i8cast's function)."""
    if mode not in probe_attend.INT8_MODES:
        return y["k"], y["v"]
    deq = lambda t, s: (t.float() * s[..., None]).to(torch.bfloat16)
    return deq(y["k"], y["sk"]), deq(y["v"], y["sv"])


def slopes(mode: str, rows: int, x: dict, device, i_lo: int = I_LO, i_hi: int = I_HI,
           reps: int = 6) -> dict:
    """ns per slot-attend (graph slope, L2-resident and HBM; eager slope),
    the plain version's ms, SDPA's and the main path's attention's ms
    (graph slope, L2-resident and HBM), the bound and, on a card, one
    launch's phase stamps (L2-resident)."""
    out = torch.zeros(GB, D, dtype=torch.float32, device=device)
    ring = _rotation(x, mode)

    def body(ring):
        def launch(i, o):
            y = ring[i % len(ring)]
            return probe_attend.attend_accumulate(o, x["q"], y["k"], y["v"], y["sk"], y["sv"],
                                                  rows, mode)
        return launch

    res = {"mode": mode, "rows": rows, "hbm_copies": len(ring)}
    res["graph_l2_ms"] = timing.graph_slope(body([x]), out, i_lo, i_hi, reps)["per_launch_ms"]
    res["graph_hbm_ms"] = timing.graph_slope(body(ring), out, i_lo, i_hi, reps)["per_launch_ms"]
    res["eager_ms"] = timing.eager_slope(body([x]), out, i_lo, i_hi, reps)["per_launch_ms"]
    for k in ("graph_l2_ms", "graph_hbm_ms", "eager_ms"):
        res[k.replace("_ms", "_ns_per_slot")] = res[k] * 1e6 / GB
    args = (x["q"], x["k"], x["v"], x["sk"], x["sv"], rows)
    res["plain_ms"] = timing.event_mean(lambda: probe_attend.attend_once_reference(*args, mode),
                                        3, warmup=1, device=device)
    # The yardsticks on bf16 K / V (the i8 modes' dequantized values), one
    # copy and the same rotation past the L2.
    kv = [_bf16_kv(y, mode) for y in ring]
    q = x["q"]
    for key, fn in (("library", library_sdpa), ("main_attention", main_attention)):
        def yard(ring_kv, fn=fn):
            return lambda i, h: fn(q, *ring_kv[i % len(ring_kv)], rows)
        res[f"{key}_ms"] = timing.graph_slope(yard(kv[:1]), out, i_lo, i_hi, reps)["per_launch_ms"]
        res[f"{key}_hbm_ms"] = timing.graph_slope(yard(kv), out, i_lo, i_hi, reps)["per_launch_ms"]
    res["library_event_ms"] = timing.event_mean(lambda: library_sdpa(q, *kv[0], rows), 30,
                                                device=device)
    if device.type == "cuda":
        res["library_kernels"] = sdpa_kernels({**x, "k": kv[0][0], "v": kv[0][1]}, rows)
    if device.type == "cuda":
        res["phase_us"] = probe_attend.read_phases(
            probe_attend.attend_stamps(x["q"], x["k"], x["v"], x["sk"], x["sv"], rows, mode))
    res.update(timing.bound(*attend_work(mode, rows)))
    del ring, kv
    return res


def report(res: dict) -> str:
    line = (f"{res['mode']:8s} rows={res['rows']}: {res['graph_l2_ns_per_slot']:8.1f} ns/slot-attend "
            f"graph (L2), {res['graph_hbm_ns_per_slot']:8.1f} graph (HBM, {res['hbm_copies']} "
            f"copies), {res['eager_ns_per_slot']:8.1f} eager; per launch of {GB} slots "
            f"{res['graph_l2_ms'] * 1e3:.3f} / {res['graph_hbm_ms'] * 1e3:.3f} us, plain "
            f"{res['plain_ms'] * 1e3:.1f} us, bound {res['bound_ms'] * 1e3:.3f} us "
            f"({res['bound_by']})")
    us = lambda key: f"{res[key] * 1e3:.3f}"
    return line + (f"; SDPA {us('library_ms')} / {us('library_hbm_ms')} us graph (L2 / HBM), "
                   f"{us('library_event_ms')} us event mean, kernels "
                   f"{res.get('library_kernels', 'not measured')}; main path's attention "
                   f"{us('main_attention_ms')} / {us('main_attention_hbm_ms')} us graph (L2 / HBM)"
                   + _phases(res))


def _phases(res: dict) -> str:
    ph = res.get("phase_us")
    if ph is None:
        return ""
    return "; stamps, last block us: " + ", ".join(
        f"{n} {ph[f'{n}_last_us']:.2f}" for n in probe_attend.STAMP_NAMES[1:])


def main(argv=None) -> int:
    device, _ = timing.parse_device(argv, "opt_attend_probe", __doc__)
    print(timing.banner(device), file=sys.stderr)
    x = make_inputs(device)
    a = probe_attend.attend(x["q"], x["k"], x["v"], None, None, 320, 1, "cur")
    b = probe_attend.attend(x["q"], x["k"], x["v"], None, None, 320, 1, "tr")
    print("cur-vs-tr max abs diff:", float((a - b).abs().max()), file=sys.stderr)
    for mode in ("cur", "tr"):
        print(json.dumps({"probe": "opt_attend_probe", "agreement": agreement(mode, 320, 1, x)}),
              flush=True)
        for rows in ROWS:
            res = slopes(mode, rows, x, device)
            print(report(res), file=sys.stderr, flush=True)
            print(json.dumps({"probe": "opt_attend_probe", "device": str(device), **res}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
