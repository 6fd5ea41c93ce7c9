"""H100 counterpart of scripts/opt_slope_probe.py: per-launch device time by
the slope between two chain lengths.

Every probe chains launches, each fed the previous one's result and its own
index ``i`` (the TPU probe's ``fori_loop`` body), captures ``N_LO`` and
``N_HI`` of them in two CUDA graphs and reports (T_hi - T_lo) / (N_HI - N_LO):
the device time of one launch, with no host work between launches. Beside it
the eager slope, the same chains issued from Python: the difference is the
host's cost of a launch.

Probes:
  minimal   kernel 15: the copy kernel at grid 8 (csrc/probe_copy.cu)
  constblk  kernel 16: the same plus 10 constant bf16 blocks (2.02 MB) read
            on every call
  single    kernel A, the single-stream frame (pos context_frames + 40)
  fused     kernel C, the batched frame, B = MAGPIE_PROBE_B slots
  split     kernels 7 + 8 with the frame-embedding glue
  dec       kernel 8, the batched decoder step
  lt        kernel 7, the batched LT sampler
  q8        kernels A and C with the dense, int8 and Q8_0 weight streams, at
            pos +40 and +340
  lockstep  the whole lockstep loop (``synthesize_codes_batched_program``),
            fused (C) then split (7 + 8), glue included: a host-clock slope
            over ``max_steps`` (LOCKSTEP_N_LO / LOCKSTEP_N_HI frames)
A probe name may carry the position offset: ``fused:340``. The frame probes
run in bf16 (the TPU script's DT), B = MAGPIE_PROBE_B (default 32; any 1..64),
temp MAGPIE_PROBE_TEMP (default 0.7) for ``fused``, each launch seeded with
its index. Frame chains are FRAME_N_LO / FRAME_N_HI frames long.

    python -m magpie_tts_tpu_torch.scripts.opt_slope_probe [probe ...] [--device cuda|cpu]
"""

from __future__ import annotations

import functools
import json
import os
import sys

import numpy as np
import torch

from ..ops.kernels import probe_copy
from . import timing

N_LO, N_HI = 50, 450
FRAME_N_LO, FRAME_N_HI = 20, 100   # frame kernels: 2-8 ms a launch, ~260 graph nodes each
LOCKSTEP_N_LO, LOCKSTEP_N_HI = 50, 450   # the TPU probe's N_LO / N_HI, in frames
REPS = timing.REPS
MAX_LAUNCHES = 4096  # the longest frame chain a probe seeds
DT = torch.bfloat16
WIDTH = 768
# scripts/opt_slope_probe.py probe_constblk's 10 constant blocks: 1,009,664
# bf16 values.
WSHAPES = [(768, 256), (8, 256), (16, 256), (8, 256), (256, 768),
           (256, 256), (8, 256), (256, 1024), (1024, 256), (8, 2048)]
DEFAULT_PROBES = ["minimal", "constblk", "lt", "fused"]


def probe_b() -> int:
    return int(os.environ.get("MAGPIE_PROBE_B", "32"))


def emit(label: str, res: dict, **extra) -> dict:
    """Print one probe's slopes as a text line (stderr) and a JSON line."""
    g, e = res["graph"], res["eager"]
    line = f"{label:46s} graph {timing.fmt(g)} | eager {timing.fmt(e)}"
    if "bound" in extra:
        line += (f" | plain {extra['plain_ms'] * 1e3:.1f} us, torch.add "
                 f"{extra['library']['per_launch_ms'] * 1e3:.3f} us, bound "
                 f"{extra['bound']['bound_ms'] * 1e3:.3f} us")
    print(line, file=sys.stderr, flush=True)
    out = {"probe": label, "graph_ms": g["per_launch_ms"], "eager_ms": e["per_launch_ms"],
           "graph": g, "eager": e, **extra}
    print(json.dumps(out), flush=True)
    return out


def slopes(label: str, body, init, n_lo: int, n_hi: int, reps: int, **extra) -> dict:
    return emit(label, {"graph": timing.graph_slope(body, init, n_lo, n_hi, reps),
                        "eager": timing.eager_slope(body, init, n_lo, n_hi, reps)}, **extra)


def const_blocks(device) -> list:
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.normal(0, 0.1, s)).to(device=device, dtype=DT) for s in WSHAPES]


def copy_yardsticks(device, x0, grid_n: int, n_lo: int, n_hi: int, reps: int, consts=(),
                    slab=None) -> dict:
    """Beside a copy probe's slopes: its bound (x read, out written, the
    constant blocks or slabs read once), the plain version's CUDA-event mean
    and the graph slope of one ``torch.add`` a launch (the library call)."""
    nbytes = 2 * x0.numel() * x0.element_size() + 4 * grid_n + sum(
        t.numel() * t.element_size() for t in (*consts, *(() if slab is None else (slab,))))
    plain = timing.event_mean(lambda: probe_copy.copy_reference(x0, grid_n, consts, slab), 3,
                              warmup=1, device=device)
    library = timing.graph_slope(lambda i, h: torch.add(h, grid_n - 1), x0, n_lo, n_hi, reps)
    return {"bound": timing.bound(nbytes), "plain_ms": plain, "library": library}


def probe_minimal(device, n_lo: int = N_LO, n_hi: int = N_HI, reps: int = REPS) -> dict:
    x0 = torch.full((probe_b(), WIDTH), 1e-3, dtype=DT, device=device)
    body = lambda i, h: probe_copy.copy(h, 8)[0]
    return slopes("minimal copy kernel grid=(8,)", body, x0, n_lo, n_hi, reps,
                  **copy_yardsticks(device, x0, 8, n_lo, n_hi, reps))


def probe_constblk(device, n_lo: int = N_LO, n_hi: int = N_HI, reps: int = REPS) -> dict:
    ws = const_blocks(device)
    x0 = torch.full((probe_b(), WIDTH), 1e-3, dtype=DT, device=device)
    body = lambda i, h: probe_copy.copy(h, 8, consts=ws)[0]
    nbytes = sum(w.numel() for w in ws) * 2
    return slopes(f"+10 const blocks ({nbytes / 1e6:.2f}MB) grid=(8,)", body, x0, n_lo, n_hi,
                  reps, const_bytes=nbytes,
                  **copy_yardsticks(device, x0, 8, n_lo, n_hi, reps, consts=ws))


# ------------------------------------------------------------ frame kernels


@functools.lru_cache(maxsize=1)
def _weights(device: torch.device):
    """(config, float32 weights, bf16 weights) at 357M width, seed 0."""
    from ..config import MagpieConfig
    from ..io.magpie_weights import random_magpie_weights

    c = MagpieConfig()
    w32 = random_magpie_weights(c, seed=0).to(device=device)
    return c, w32, w32.to(dtype=DT)


@functools.lru_cache(maxsize=2)
def _state(device: torch.device, B: int):
    """Random xa K / V and caches at the TPU probe's scale (N(0, 0.3)), made
    on the device: B slots (B = 0: the single stream)."""
    c, _, _ = _weights(device)
    gen = torch.Generator(device=device).manual_seed(0)
    E, S, D, L = 64, c.max_seq, c.d_model, c.dec_layers
    lead = (B, L) if B else (L,)
    rnd = lambda *shape: (torch.randn(shape, generator=gen, device=device) * 0.3).to(DT)
    return dict(xa_k=rnd(*lead, E, c.d_xa), xa_v=rnd(*lead, E, c.d_xa),
                k_cache=rnd(*lead, S, D), v_cache=rnd(*lead, S, D),
                enc_lens=torch.full((max(B, 1),), 50, dtype=torch.int32, device=device))


@functools.lru_cache(maxsize=1)
def _streams(device: torch.device):
    """(int8, Q8_0) weight streams of the float32 decoder."""
    from ..io.magpie_weights import q8_stream_from_arrays, quantize_decoder_stream

    _, w32, _ = _weights(device)
    with torch.no_grad():
        return quantize_decoder_stream(w32.decoder), q8_stream_from_arrays(w32.decoder).to(device)


def _batched_args(device, pos_off: int):
    c, _, w = _weights(device)
    B = probe_b()
    pos = c.context_frames + pos_off
    valid = (torch.arange(c.max_seq, device=device)[None, :] <= pos).expand(B, -1).contiguous()
    seeds = (torch.arange(MAX_LAUNCHES, dtype=torch.int32, device=device)[:, None]
             + torch.arange(B, dtype=torch.int32, device=device)[None, :]).contiguous()
    return c, w, B, pos, valid, seeds


def _init_rows(c, B: int, device):
    return torch.full((B, c.d_model) if B else (c.d_model,), 0.5, dtype=DT, device=device)


def _single_body(device, stream=None, pos_off: int = 40):
    from ..ops.kernels import frame_step as fs

    c, _, w = _weights(device)
    d = _state(device, 0)
    pos = c.context_frames + pos_off

    def body(i, carry):
        h, kc, vc = carry
        _, _, h2, kc, vc = fs.frame_step(h, pos, d["xa_k"], d["xa_v"], kc, vc, w, c, i, 0.7, 80,
                                         False, enc_length=50, stream=stream)
        return h2, kc, vc

    return body, (_init_rows(c, 0, device), d["k_cache"], d["v_cache"])


def _fused_body(device, stream=None, pos_off: int = 40, temp: float = 0.7):
    from ..ops.kernels import frame_step_batched as fsb

    c, w, B, pos, valid, seeds = _batched_args(device, pos_off)
    d = _state(device, B)
    posemb = w.decoder.pos_emb[pos][None, :].expand(B, -1)
    forbid = torch.zeros(B, dtype=torch.bool, device=device)
    maycont = torch.ones(B, dtype=torch.bool, device=device)

    def body(i, carry):
        h, kc, vc = carry
        _, _, h2, kc, vc = fsb.frame_step_batched(h, pos, valid, maycont, posemb, d["xa_k"],
                                                  d["xa_v"], kc, vc, w, c, d["enc_lens"],
                                                  seeds[i], temp, 80, forbid, stream=stream)
        return h2, kc, vc

    return body, (_init_rows(c, B, device), d["k_cache"], d["v_cache"])


def probe_single(device, pos_off: int = 40, n_lo: int = FRAME_N_LO, n_hi: int = FRAME_N_HI,
                 reps: int = REPS) -> dict:
    """Kernel A, the single-stream fused frame."""
    body, init = _single_body(device, pos_off=pos_off)
    return slopes(f"single-stream frame kernel (pos_off={pos_off})", body, init, n_lo, n_hi,
                  reps, kernel="A", pos_off=pos_off)


def probe_fused(device, pos_off: int = 40, n_lo: int = FRAME_N_LO, n_hi: int = FRAME_N_HI,
                reps: int = REPS) -> dict:
    """Kernel C, the batched fused frame, at MAGPIE_PROBE_TEMP."""
    temp = float(os.environ.get("MAGPIE_PROBE_TEMP", "0.7"))
    body, init = _fused_body(device, pos_off=pos_off, temp=temp)
    return slopes(f"fused frame kernel B={probe_b()} (pos_off={pos_off}, temp={temp})", body,
                  init, n_lo, n_hi, reps, kernel="C", pos_off=pos_off, B=probe_b())


def probe_dec(device, pos_off: int = 40, n_lo: int = FRAME_N_LO, n_hi: int = FRAME_N_HI,
              reps: int = REPS) -> dict:
    """Kernel 8, the batched decoder step."""
    from ..ops.kernels import decoder_step_batched as dsb

    c, w, B, pos, valid, _ = _batched_args(device, pos_off)
    d = _state(device, B)

    def body(i, carry):
        h, kc, vc = carry
        return dsb.decode_step_batched(h, pos, valid, d["xa_k"], d["xa_v"], kc, vc, w, c,
                                       d["enc_lens"]), kc, vc

    return slopes(f"decoder kernel B={B} (pos_off={pos_off})", body,
                  (_init_rows(c, B, device), d["k_cache"], d["v_cache"]), n_lo, n_hi, reps,
                  kernel="8", pos_off=pos_off, B=B)


def probe_lt(device, n_lo: int = FRAME_N_LO, n_hi: int = FRAME_N_HI, reps: int = REPS) -> dict:
    """Kernel 7, the batched LT sampler (temp 0.7, each launch its seeds)."""
    from ..ops.kernels import lt_sampler_batched as ltsb

    c, w, B, _, _, seeds = _batched_args(device, 40)
    forbid = torch.zeros(B, dtype=torch.bool, device=device)

    def body(i, h):
        ltsb.sample_frame_codes_batched(h, w, c, seeds[i], 0.7, 80, forbid)
        return h

    return slopes(f"LT sampler kernel B={B}", body, _init_rows(c, B, device), n_lo, n_hi, reps,
                  kernel="7", B=B)


def probe_split(device, pos_off: int = 40, n_lo: int = FRAME_N_LO, n_hi: int = FRAME_N_HI,
                reps: int = REPS) -> dict:
    """Kernels 7 + 8 with the frame-embedding glue (the split frame)."""
    from ..models.magpie import audio_frame_embedding
    from ..ops.kernels import decoder_step_batched as dsb
    from ..ops.kernels import lt_sampler_batched as ltsb

    c, w, B, pos, valid, seeds = _batched_args(device, pos_off)
    d = _state(device, B)
    forbid = torch.zeros(B, dtype=torch.bool, device=device)
    posemb = w.decoder.pos_emb[pos][None, :]

    def body(i, carry):
        h, kc, vc = carry
        s, _ = ltsb.sample_frame_codes_batched(h, w, c, seeds[i], 0.7, 80, forbid)
        x_pe = audio_frame_embedding(s, w, c) + posemb
        return dsb.decode_step_batched(x_pe, pos, valid, d["xa_k"], d["xa_v"], kc, vc, w, c,
                                       d["enc_lens"]), kc, vc

    return slopes(f"split kernels + glue B={B} (pos_off={pos_off})", body,
                  (_init_rows(c, B, device), d["k_cache"], d["v_cache"]), n_lo, n_hi, reps,
                  kernel="7+8", pos_off=pos_off, B=B)


def probe_q8(device, n_lo: int = FRAME_N_LO, n_hi: int = FRAME_N_HI, reps: int = REPS,
             pos_offs=(40, 340)) -> list:
    """Kernels A and C with each weight stream: dense, int8 columns, Q8_0."""
    int8, q8 = _streams(device)
    out = []
    for label, stream in (("dense", None), ("int8-col", int8), ("q8-native", q8)):
        for pos_off in pos_offs:
            body, init = _single_body(device, stream, pos_off)
            out.append(slopes(f"single [{label}] (pos_off={pos_off})", body, init, n_lo, n_hi,
                              reps, kernel="A", stream=label, pos_off=pos_off))
    for label, stream in (("dense", None), ("int8-col", int8), ("q8-native", q8)):
        for pos_off in pos_offs:
            body, init = _fused_body(device, stream, pos_off)
            out.append(slopes(f"batched B={probe_b()} [{label}] (pos_off={pos_off})", body, init,
                              n_lo, n_hi, reps, kernel="C", stream=label, pos_off=pos_off,
                              B=probe_b()))
    return out


def probe_lockstep(device, n_lo: int = LOCKSTEP_N_LO, n_hi: int = LOCKSTEP_N_HI,
                   reps: int = REPS, config=None, B: int = None) -> list:
    """The product-level lockstep loop (``models.magpie
    .synthesize_codes_batched_program``), fused (kernel C) then split
    (kernels 7 + 8 with the embedding glue), as scripts/opt_slope_probe.py's
    ``probe_lockstep``: B streams of T = 64 tokens, temp 0.7, top_k 80, bf16
    weights (seed 0; ``config`` default ``MagpieConfig()``). Each arm's ms a
    frame is ``parity_batched.time_loop``'s slope of the whole call's host
    wall time over ``n_lo`` / ``n_hi`` forced frames (fresh keys each run,
    best of ``reps``): the per-frame cost INCLUDING all loop glue (the
    per-frame masks, the EOS bookkeeping, the host's launch enqueue, the
    all-done read every 8 frames). No CUDA graph: the glue is the point.

    What it answers on the H100: how much of a lockstep frame is host glue.
    Set its slope beside the CUDA-graph slope of one kernel-C frame (or of
    7 + 8) at the same B and dtype (PERF.md's kernel table, rows 6-8, or
    ``probe_fused`` / ``probe_split`` here): the difference is what the host
    adds to each frame."""
    from ..io.magpie_weights import random_magpie_weights
    from ..models import magpie as magpie_mod
    from ..ops import sampling
    from .parity_batched import T_TOKENS, time_loop

    if config is None:
        c, _, w = _weights(device)
    else:
        c, w = config, random_magpie_weights(config, seed=0).to(device=device, dtype=DT)
    replica = (w, magpie_mod.float32_products(w))
    B = B or probe_b()

    def make(cfg, B, seed):
        toks = np.full((B, T_TOKENS), 2, np.int64)
        toks[:, 0] = cfg.text_bos_id
        toks[:, -1] = cfg.text_eos_id
        base = sampling.prng_key(seed)
        return {"tokens": toks, "lens": [T_TOKENS] * B, "spk": [0] * B,
                "keys": [sampling.fold_in(base, i) for i in range(B)]}

    out = []
    for label, fused, kernel in (("fused kernel", True, "C"), ("split kernels", False, "7+8")):
        t = time_loop(c, replica, B, n_lo, n_hi, fused, reps, make)
        res = {**t, "per_launch_ms": t["ms_a_step"]}
        name = f"lockstep loop [{label}] B={B}"
        print(f"{name:46s} host {timing.fmt(res).replace('us/launch', 'us/frame')}",
              file=sys.stderr, flush=True)
        line = {"probe": name, "host_ms": res["per_launch_ms"], "host": res, "kernel": kernel,
                "B": B}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


PROBES = {"minimal": probe_minimal, "constblk": probe_constblk, "dec": probe_dec,
          "lt": probe_lt, "fused": probe_fused, "split": probe_split, "single": probe_single,
          "q8": probe_q8, "lockstep": probe_lockstep}
# The TPU script's probes that have no counterpart here (ROADMAP.md).
NOT_PORTED = {"anatomy": "uses the TPU kernels' trace-time ablation knobs; on the H100 "
                         "chip_profile.py's per-family device times answer it"}


def main(argv=None) -> int:
    device, names = timing.parse_device(argv, "opt_slope_probe", __doc__, names=True)
    names = names or DEFAULT_PROBES
    for nm in names:
        base = nm.split(":", 1)[0]
        if base not in PROBES:
            why = NOT_PORTED.get(base, f"unknown; probes: {', '.join(PROBES)}")
            print(f"opt_slope_probe: probe {base!r} is not ported: {why}", file=sys.stderr)
            return 2
    print(timing.banner(device), file=sys.stderr)
    with torch.no_grad():
        for nm in names:
            if ":" in nm:   # e.g. fused:340 -> probe_fused(device, pos_off=340)
                nm, arg = nm.split(":", 1)
                PROBES[nm](device, pos_off=int(arg))
            else:
                PROBES[nm](device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
