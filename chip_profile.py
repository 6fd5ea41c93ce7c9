"""Profile of the PyTorch/CUDA port on one NVIDIA GPU: where the batched frame
kernel's time goes, and the fused frame against the split path.

Run from the root of a checkout:
    python3 chip_profile.py [frame|split|fused|stream|slope|lt|q8|gemv|copy|admission|all]
                            [--root DIR]

frame: kernel C (csrc/frame_step_batched.cu) at full 357M width, random
    weights, write row 300, for each (B, temperature, rows attended) of
    FRAME_CASES: host enqueue ms per frame (REPS launches, then one sync),
    CUDA-event ms per frame, and device ms per frame in all and by kernel
    family, from ``torch.profiler``.
split: one decode frame as each loop runs it, at 357M width, row 300,
    temp 0.7: single stream fused (kernel A, then the host EOS read) and
    split (kernel 4, the host EOS read, the embedding, kernel 5), and at B=8
    fused (kernel C) and split (kernel 7, the EOS bookkeeping, the embedding
    + posemb, kernel 8); then each of the four split kernels alone. Per
    frame: host wall ms (REPS frames, then one sync; the single-stream loops
    sync every frame), device ms in all and by kernel family, and launches
    by family.
fused: the fused rows of ``split`` alone. They use only what the package
    had before the split path, so ``--root DIR`` (another checkout's root,
    whose package is imported and built instead of this one's) compares two
    commits in one call.
stream: kernels A and 5 (single stream) and C and 8 (B=8) at 357M width,
    row 300, temp 0.7, with each weight stream (dense float32, int8 columns,
    Q8_0 blocks): host wall ms, device ms in all and by kernel family, and
    launches per frame, as ``split`` reports them.
slope: kernels A and 5 (B = 1), kernel 4 (B = 1, temp 0.7 and 0), kernel 7
    (B = 8, 32, 64) and kernel C (B = 8, 32) at 357M width, row 300, temp
    0.7, dense float32 and bf16: device ms a frame by CUDA-graph slope
    (scripts/timing.py graph_slope, SLOPE_N frames a graph), and the
    grid-barrier probe's us a barrier; with ``--root DIR`` another
    checkout's kernels, so parent and change time in turns in one call.
    The persistent kernels (A, 5 since their redesign) are also broken down
    in ``frame``, ``split`` and ``stream`` by their phase stamps (block 0's
    %globaltimer at each phase's start, prologue end and barrier arrival):
    ms a frame in GEMV work, attention, LayerNorm / epilogue, sampling and
    barrier wait (``stamp_ms``), and the barriers counted.
lt: the LT samplers' rows of ``slope`` alone (kernels 4 and 7), and kernel
    4's phase-stamp breakdown in both dtypes (``profile_lt_stamps``).
q8: kernel 10 (csrc/q8_dequant.cu) on every block-stored tensor of a 357M
    Q8_0 GGUF (chip_smoke's writer, the converter's allowlist), float32 and
    bf16: device ms a tensor by CUDA-graph slope (Q8_N dequants a graph)
    beside its CUDA-event mean, and their sums (one ``materialize``); with
    ``--root DIR`` another checkout's kernel, for turns.
gemv: the GEMV probes (kernels 11-13, csrc/probe_gemv.cu) at x [8, K] @
    W [K, 3072] for K in GEMV_K: ``scripts/probe_int4.probe`` (graph slopes
    L2-resident and from HBM beside cuBLAS and the main path's batched GEMM,
    the plan, phase stamps), plus the SHA-256 of each kernel's float32
    output on a seeded normal bf16 x (bits to hold across commits) and the
    slopes L2-resident / from HBM at every K split the kernel takes
    (``splits_ms``: the sweep behind ``plan_gemv``'s rule).
    ``--root DIR`` takes a checkout whose ``probe`` has ``k`` (this
    design's on); an older kernel is timed in turns by its own checkout's
    ``python -m magpie_tts_tpu_torch.scripts.probe_int4``.
copy: the copy probes (kernels 15-17, csrc/probe_copy.cu), each form the
    probes time: minimal (grid 8), constblk (grid 8, 10 constant blocks),
    grid 1 / 8 / 20 and streamed (grid 8, a 1 MB slab a step). Each form's
    graph slope L2-resident and, for constblk and streamed, from HBM, the
    eager slope, ``torch.add``'s graph slope, the plain version's event mean
    and the bound (``scripts/opt_slope_probe`` / ``opt_launch_probe``, as
    the smoke runs them); the plan; the graph slopes at every CTA count a
    step of COPY_CTAS (``ctas_ms``, L2-resident / from HBM: the sweep behind
    ``plan_copy``'s rule); the median of STAMP_RUNS launches' phase stamps
    (``phase_us``). A parent without ``ctas`` is timed in turns by its own
    ``opt_slope_probe`` / ``opt_launch_probe``.
admission: ``prepare_batch`` (profile_admission): rows of groups against
    the request alone with the products folded (the port's) and as a
    per-request-shaped bmm, device work by family at M = 1 / 8 / 32, and bf16
    at M = 1 on the float32 copies against widening per product.

Every result is one JSON line on stdout; the card's nvidia-smi name and power
limit come first.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

FRAME_CASES = [(1, 0.7, 640), (1, 0.7, 301), (8, 0.0, 301), (8, 0.7, 640), (8, 0.7, 301),
               (32, 0.7, 640), (32, 0.7, 301)]
REPS = 20
SLOPE_N = (4, 16, 3)   # graph slopes: frames a graph, lo / hi, and replays
GEMV_K = (256, 512, 768, 1024)
GEMV_N = (50, 450, 5)  # the split sweep's slopes: launches a graph, lo / hi, and replays
COPY_CTAS = (1, 2, 3, 4, 6, 8, 12, 16)
STAMP_RUNS = 5
# Kernel families by the device kernels' names (csrc/): the split-row
# attention's two launches, the batched frames' tensor-core GEMM, the
# single-stream GEMV, the reducers and the LT sampling.
# A parent checkout's (--root) names from before the split-row attention
# and the tensor-core GEMM come last: attention_kernel, gemm_splitk_kernel.
FAMILIES = {"persistent": ("frame_persistent_kernel",),
            "attention": ("attention_scores_kernel", "attention_pv_kernel", "attention_kernel"),
            "gemm": ("gemm_mma_kernel", "gemm_splitk_kernel"), "gemv": ("gemv_splitk_kernel",),
            "combine_ln": ("combine_ln_kernel", "decoder_input_kernel"),
            "lt_persistent": ("lt_persistent_kernel",),
            "lt_sample": ("lt_sample_kernel",), "reduce_act": ("reduce_act_kernel",),
            "qkv_scatter": ("qkv_scatter_kernel",)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _device_events(prof):
    """The profiler's device-side events (kernels, copies) as (name, start us,
    end us), user annotations left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def _family(name: str) -> str:
    for fam, kernels in FAMILIES.items():
        if any(k in name for k in kernels):
            return fam
    return "other"


def stamp_breakdown(run, plan=None, reps: int = 5) -> dict:
    """Mean ms a frame by phase group from the persistent kernel's stamps:
    ``run(stamps)`` launches one frame writing them. GEMV / attention: the
    phases' work after their prologue; LayerNorm / epilogue (residual,
    norm, partial sums; an in-block one-chunk attention counts as
    attention) and sampling: the prologues; barrier wait: from block 0's
    arrival to the next phase's start. Also the barriers, the span and,
    with the frame's ``plan`` (frame_step.plan_frame), ms a frame by phase
    name (prologue + work, every layer's summed; ``wait``: the barriers
    after them)."""
    import torch

    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs

    groups = dict.fromkeys(("gemv", "attention", "ln_epilogue", "sampling", "barrier_wait"), 0.0)
    total, barriers = 0.0, None
    by_phase: dict = {}
    for _ in range(reps + 1):
        stamps = torch.zeros(1 + fs.STAMP_WORDS * 512, dtype=torch.int64, device="cuda")
        run(stamps)
        torch.cuda.synchronize()
        recs = fs.read_stamps(stamps)
        if barriers is None:          # the first run warms up and is not counted
            barriers = len(recs) - 1
            continue
        pro_group = {"ln": "ln_epilogue", "none": "ln_epilogue", "sampling": "sampling",
                     "attention": "attention"}
        names = [ph.name for ph in plan.phases] if plan is not None else [None] * len(recs)
        if len(names) != len(recs):
            raise AssertionError(f"{len(recs)} phases stamped, the plan has {len(names)}")
        for r, nxt, name in zip(recs, recs[1:] + [None], names):
            if name is not None:
                ph = by_phase.setdefault(name, {"ms": 0.0, "wait": 0.0})
                ph["ms"] += (r["end"] - r["start"]) / 1e6 / reps
                if nxt is not None:
                    ph["wait"] += (nxt["start"] - r["end"]) / 1e6 / reps
            groups[pro_group[r["pro"]]] += (r["pro_end"] - r["start"]) / 1e6 / reps
            work = {"gemv": "gemv", "attention": "attention"}.get(r["work"], "ln_epilogue")
            groups[work] += (r["end"] - r["pro_end"]) / 1e6 / reps
            if nxt is not None:
                groups["barrier_wait"] += (nxt["start"] - r["end"]) / 1e6 / reps
        total += (recs[-1]["end"] - recs[0]["start"]) / 1e6 / reps
    out = {"stamp_ms": groups, "stamp_span_ms": total, "barriers": barriers}
    if by_phase:
        out["by_phase_ms"] = {k: {kk: round(vv, 5) for kk, vv in v.items()}
                              for k, v in by_phase.items()}
    return out


def _stamped(fs_module) -> bool:
    """Whether the imported package's frame kernels write phase stamps (a
    parent checkout's may not)."""
    return hasattr(fs_module, "read_stamps")


def profile_persistent(dev) -> None:
    """Kernels A and 5 at B = 1, rows 301 and 640, float32 dense: the stamp
    breakdown of one frame."""
    import torch

    from chip_smoke import prod_weights
    from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs

    if not _stamped(fs):
        return
    c, w = prod_weights(dev)
    S, L, D, E = c.max_seq, c.dec_layers, c.d_model, 32
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=0.5: torch.randn(*shape, generator=gen, device=dev) * s
    one = dict(xa_k=rnd(L, E, c.d_xa), xa_v=rnd(L, E, c.d_xa), k_cache=rnd(L, S, D),
               v_cache=rnd(L, S, D), weights=w, config=c, enc_length=E)
    hidden = rnd(D, s=1.0)
    with torch.no_grad():
        for rows in (301, 640):
            pos = rows - 1
            for path, run in (
                    ("frame_step", lambda st: fs.frame_step(hidden, pos, seed=7, temperature=0.7,
                                                            top_k=80, forbid_eos=False,
                                                            stamps=st, **one)),
                    ("decoder_step", lambda st: ds.decode_step(hidden, pos, stamps=st, **one))):
                plan = fs.plan_frame(c, E, path == "frame_step")
                emit({"phase": "frame", "path": path, "B": 1, "rows": rows, "temperature": 0.7,
                      **stamp_breakdown(run, plan)})


LT_SLOPE_B = (8, 32, 64)   # kernel 7's slots in ``slope``
C_SLOPE_B = (8, 32)        # kernel C's


def profile_slope(dev, lt_only: bool = False) -> None:
    """By CUDA-graph slope (device ms a frame, dense, float32 and bf16, row
    300, temp 0.7): kernel A and 5 at B = 1, kernel 4 at B = 1 and at temp 0
    (the difference over 8 codebooks: the draw's top-k and Gumbel passes),
    kernel 7 at LT_SLOPE_B slots and kernel C at C_SLOPE_B slots; then the
    grid-barrier probe. ``lt_only``: the LT samplers' rows alone (4 and 7)."""
    import torch

    from chip_smoke import prod_weights
    from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
    from magpie_tts_tpu_torch.scripts import timing

    bmax = max(LT_SLOPE_B)
    for dtype in ("float32", "bfloat16"):
        c, w = prod_weights(dev, dtype)
        T = w.decoder.qkv.dtype
        S, L, D, E, row = c.max_seq, c.dec_layers, c.d_model, 32, 300
        gen = torch.Generator(device=dev).manual_seed(0)
        rnd = lambda *shape, s=0.5: (torch.randn(*shape, generator=gen, device=dev) * s).to(T)
        kc, vc = rnd(L, S, D), rnd(L, S, D)
        xa = dict(xa_k=rnd(L, E, c.d_xa), xa_v=rnd(L, E, c.d_xa), weights=w, config=c,
                  enc_length=E)
        hidden = rnd(bmax, D, s=1.0)
        seeds = torch.arange(bmax, dtype=torch.int32, device=dev)
        forbid = torch.zeros(bmax, dtype=torch.bool, device=dev)

        def a_body(i, h):
            return fs.frame_step(h, row, k_cache=kc, v_cache=vc, seed=i, temperature=0.7,
                                 top_k=80, forbid_eos=False, **xa)[2]

        def five_body(i, h):
            return ds.decode_step(h, row, k_cache=kc, v_cache=vc, **xa)

        def four_body(temp):
            def body(i, h):
                lts.sample_frame_codes(h, w, c, i, temp, 80, False)
                return h
            return body

        def seven_body(B):
            def body(i, h):
                ltsb.sample_frame_codes_batched(h, w, c, seeds[:B], 0.7, 80, forbid[:B])
                return h
            return body

        bodies = [] if lt_only else [("frame_step", 1, a_body, hidden[0]),
                                     ("decoder_step", 1, five_body, hidden[0])]
        bodies += [("lt_sampler", 1, four_body(0.7), hidden[0]),
                   ("lt_sampler_temp0", 1, four_body(0.0), hidden[0])]
        bodies += [("lt_sampler_batched", B, seven_body(B), hidden[:B].contiguous())
                   for B in LT_SLOPE_B]
        with torch.no_grad():
            for path, B, body, h0 in bodies:
                t = timing.graph_slope(body, h0, *SLOPE_N)
                emit({"phase": "slope", "path": path, "dtype": dtype, "B": B, "row": row,
                      "graph_ms": t["per_launch_ms"], "n": SLOPE_N})
            del kc, vc
            torch.cuda.empty_cache()
            for B in () if lt_only else C_SLOPE_B:
                kb, vb = rnd(B, L, S, D), rnd(B, L, S, D)
                args = dict(valid=(torch.arange(S, device=dev) <= row)[None].expand(B, -1),
                            may_continue=torch.ones(B, dtype=torch.bool, device=dev),
                            posemb=w.decoder.pos_emb[row][None].expand(B, -1),
                            xa_k=rnd(B, L, E, c.d_xa), xa_v=rnd(B, L, E, c.d_xa), k_cache=kb,
                            v_cache=vb, weights=w, config=c,
                            enc_lengths=torch.full((B,), E, dtype=torch.int32, device=dev),
                            seeds=seeds[:B], temperature=0.7, top_k=80, forbid_eos=forbid[:B],
                            rows=row + 1)

                def c_body(i, h, args=args):
                    return fsb.frame_step_batched(h, row, **args)[2]

                t = timing.graph_slope(c_body, hidden[:B].contiguous(), *SLOPE_N)
                emit({"phase": "slope", "path": "frame_step_batched", "dtype": dtype, "B": B,
                      "row": row, "graph_ms": t["per_launch_ms"], "n": SLOPE_N})
                del kb, vb, args
                torch.cuda.empty_cache()
        del w, xa
        torch.cuda.empty_cache()
    if hasattr(fs, "barrier_probe") and not lt_only:
        from chip_smoke import barrier_cost

        emit({"phase": "slope", "path": "barrier_probe", **barrier_cost(dev, SLOPE_N)})


def profile_lt_stamps(dev) -> None:
    """Kernel 4 at B = 1, dense, float32 and bf16, temp 0.7: the stamp
    breakdown of one frame by phase group and by phase name
    (frame_step.plan_lt)."""
    import torch

    from chip_smoke import prod_weights
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts

    if not hasattr(fs, "plan_lt"):
        return
    for dtype in ("float32", "bfloat16"):
        c, w = prod_weights(dev, dtype)
        gen = torch.Generator(device=dev).manual_seed(0)
        hidden = torch.randn(c.d_model, generator=gen, device=dev).to(w.decoder.qkv.dtype)
        with torch.no_grad():
            run = lambda st: lts.sample_frame_codes(hidden, w, c, 7, 0.7, 80, False, stamps=st)
            emit({"phase": "lt_stamps", "path": "lt_sampler", "dtype": dtype, "B": 1,
                  "temperature": 0.7, **stamp_breakdown(run, fs.plan_lt(c))})
        del w
        torch.cuda.empty_cache()


Q8_N = (2, 8)   # kernel 10's graph slopes: dequants a graph, lo / hi


def profile_q8(dev) -> None:
    """Kernel 10 on every block-stored tensor of a 357M Q8_0 GGUF, float32
    and bf16: graph slope and event mean per tensor and summed."""
    import torch

    from chip_smoke import write_model_gguf
    from magpie_tts_tpu_torch.config import MagpieConfig
    from magpie_tts_tpu_torch.io.magpie_weights import load_magpie_weights, q8_blocks
    from magpie_tts_tpu_torch.ops.kernels import q8_dequant
    from magpie_tts_tpu_torch.scripts import timing

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "magpie_q8.gguf")
        write_model_gguf(path, MagpieConfig(), seed=0, quant="q8_0")
        _, native = load_magpie_weights(path, q8_native=True)
    found = {name: blk.to(dev) for name, blk in q8_blocks(native).items()}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            total = {"graph_ms": 0.0, "event_ms": 0.0}
            for name, blk in found.items():
                args = (blk.q, blk.s, blk.torch_shape, blk.transform, dtype)
                body = lambda i, h, args=args: (q8_dequant.dequantize(*args), h)[1]
                graph = timing.graph_slope(body, blk.q, *Q8_N)["per_launch_ms"]
                event = timing.event_mean(lambda args=args: q8_dequant.dequantize(*args), reps=10)
                total["graph_ms"] += graph
                total["event_ms"] += event
                emit({"phase": "q8", "tensor": name, "shape": list(blk.q.shape),
                      "transform": blk.transform, "dtype": str(dtype).replace("torch.", ""),
                      "graph_ms": graph, "event_ms": event})
                torch.cuda.empty_cache()
            emit({"phase": "q8", "tensor": "all", "tensors": len(found),
                  "dtype": str(dtype).replace("torch.", ""), **total})


def profile_gemv(dev) -> None:
    """Kernels 11-13 by ``probe_int4.probe`` with the outputs' SHA-256 and
    the split sweep (see ``gemv`` above); one JSON line a (format, K)."""
    import hashlib

    import torch

    from magpie_tts_tpu_torch.ops.kernels import probe_gemv
    from magpie_tts_tpu_torch.scripts import probe_int4, timing

    slope = lambda body, init: timing.graph_slope(body, init, *GEMV_N)["per_launch_ms"]
    with torch.no_grad():
        for k in GEMV_K:
            inputs = probe_int4.make_inputs(dev, k)
            xr = torch.from_numpy(np.random.default_rng(7).standard_normal((8, k))).to(
                device=dev, dtype=torch.bfloat16)
            for fmt in probe_gemv.FORMATS:
                res = probe_int4.probe(fmt, dev, k=k)
                x, w = inputs[fmt][:2]
                out = probe_gemv.gemv(xr, w, fmt)
                res["sha256_random_x"] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
                copies = [w] + [w.clone() for _ in range(
                    timing.copies_past_l2(w.numel() * w.element_size()) - 1)]
                steps = probe_gemv.plan_gemv(fmt, k, probe_int4.OUT).steps(k)
                res["splits_ms"] = {}
                for sp in (s for s in range(1, probe_gemv.MAX_CLUSTER + 1) if steps % s == 0):
                    body = lambda i, h, ws=(w,), sp=sp: probe_gemv.gemv(
                        x, ws[i % len(ws)], fmt, splits=sp)
                    res["splits_ms"][sp] = (slope(body, out),
                                            slope(lambda i, h: body(i, h, copies), out))
                del copies
                emit({"phase": "gemv", **res})
                torch.cuda.empty_cache()


def profile_copy(dev) -> None:
    """Kernels 15-17 by the probes' own functions, the CTA sweep and the
    phase stamps (see ``copy`` above); one JSON line a copy form."""
    import torch

    from magpie_tts_tpu_torch.ops.kernels import probe_copy
    from magpie_tts_tpu_torch.scripts import opt_launch_probe, opt_slope_probe, timing

    slope = lambda body, init: timing.graph_slope(body, init, *GEMV_N)["per_launch_ms"]
    with torch.no_grad():
        consts = opt_slope_probe.const_blocks(dev)
        slab = torch.zeros(8, 512, 1024, dtype=torch.bfloat16, device=dev)
        full = torch.full((opt_slope_probe.probe_b(), opt_slope_probe.WIDTH), 1e-3,
                          dtype=torch.bfloat16, device=dev)
        zeros = torch.zeros(32, opt_launch_probe.WIDTH, dtype=torch.bfloat16, device=dev)
        # name: (the probe's result, grid_n, x0, the weight the launch reads or None, the key)
        forms = {
            "minimal": (lambda: opt_slope_probe.probe_minimal(dev), 8, full, None, None),
            "constblk": (lambda: opt_slope_probe.probe_constblk(dev), 8, full, consts, "consts"),
            "grid1": (lambda: opt_launch_probe.run("minimal copy kernel grid=(1,)", 32, 1, 0,
                                                   dev), 1, zeros, None, None),
            "grid8": (lambda: opt_launch_probe.run("minimal copy kernel grid=(8,)", 32, 8, 0,
                                                   dev), 8, zeros, None, None),
            "grid20": (lambda: opt_launch_probe.run("minimal copy kernel grid=(20,)", 32, 20, 0,
                                                    dev), 20, zeros, None, None),
            "streamed": (lambda: opt_launch_probe.run(
                "minimal + 1MB streamed block/step grid=(8,)", 32, 8, 1, dev), 8, zeros, slab,
                "slab")}
        for name, (probe, g, x0, weight, key) in forms.items():
            res = {"form": name, **probe()}
            kw = {} if key is None else {key: weight}
            ring = None
            if key is not None:
                nbytes = sum(t.numel() * 2 for t in (weight if key == "consts" else [weight]))
                ring = [weight] + [[t.clone() for t in weight] if key == "consts" else
                                   weight.clone()
                                   for _ in range(timing.copies_past_l2(nbytes) - 1)]
            res["ctas_ms"] = {}
            for c in COPY_CTAS:
                body = lambda i, h, c=c, ws=(weight,): probe_copy.copy(
                    h, g, **({} if key is None else {key: ws[i % len(ws)]}), ctas=c)[0]
                res["ctas_ms"][c] = (slope(body, x0),
                                     slope(lambda i, h: body(i, h, ws=ring), x0) if ring else None)
            runs = [probe_copy.copy_stamps(x0, g, ctas=None, **kw) for _ in range(STAMP_RUNS)]
            plain = probe_copy.copy_reference(x0.cpu(), g, **{k: (
                [t.cpu() for t in v] if k == "consts" else v.cpu()) for k, v in kw.items()})
            res["stamped_bit_equal"] = all(torch.equal(o.cpu(), plain[0]) and
                                           torch.equal(cs.cpu(), plain[1]) for o, cs, _ in runs)
            phases = [probe_copy.read_phases(st) for _, _, st in runs]
            res["phase_us"] = {k: float(np.median([ph[k] for ph in phases])) for k in phases[0]}
            emit({"phase": "copy", **res})
            del ring
            torch.cuda.empty_cache()


def profile_frame(dev) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from magpie_tts_tpu_torch.config import MagpieConfig
    from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb

    c = MagpieConfig()
    w = random_magpie_weights(c, seed=0).to(device=dev)
    S, L, D, E = c.max_seq, c.dec_layers, c.d_model, 128
    write_row = 300
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=0.5: torch.randn(*shape, generator=gen, device=dev) * s
    bmax = max(b for b, _, _ in FRAME_CASES)
    k_base, v_base = rnd(bmax, L, S, D), rnd(bmax, L, S, D)
    xa_k, xa_v = rnd(bmax, L, E, c.d_xa), rnd(bmax, L, E, c.d_xa)
    hidden = rnd(bmax, D, s=1.0)
    valid = torch.zeros(bmax, S, dtype=torch.bool, device=dev)
    valid[:, :write_row] = True
    for B, temp, rows in FRAME_CASES:
        kc, vc = k_base[:B].clone(), v_base[:B].clone()
        args = dict(hidden=hidden[:B].contiguous(), write_row=write_row, valid=valid[:B],
                    may_continue=torch.ones(B, dtype=torch.bool, device=dev),
                    posemb=w.decoder.pos_emb[write_row][None].expand(B, -1),
                    xa_k=xa_k[:B].contiguous(), xa_v=xa_v[:B].contiguous(), k_cache=kc,
                    v_cache=vc, weights=w, config=c,
                    enc_lengths=torch.full((B,), 32, dtype=torch.int32, device=dev),
                    seeds=torch.arange(B, dtype=torch.int32, device=dev),
                    temperature=temp, top_k=80,
                    forbid_eos=torch.zeros(B, dtype=torch.bool, device=dev), rows=rows)
        with torch.no_grad():
            for _ in range(3):
                fsb.frame_step_batched(**args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                fsb.frame_step_batched(**args)
            enqueue = (time.perf_counter() - t0) * 1e3 / REPS
            end.record()
            torch.cuda.synchronize()
            event = start.elapsed_time(end) / REPS
            # One traced warm-up step first: the tracer misses launches at its start.
            traced = []
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                         on_trace_ready=lambda p: traced.append(_device_events(p))) as prof:
                for reps in (1, REPS):
                    for _ in range(reps):
                        fsb.frame_step_batched(**args)
                    torch.cuda.synchronize()
                    prof.step()
        by_family: dict = {}
        launches: dict = {}
        for name, t0_us, t1_us in traced[0]:
            if _is_copy(name):
                continue
            fam = _family(name)
            by_family[fam] = by_family.get(fam, 0.0) + (t1_us - t0_us) / 1e3 / REPS
            launches[fam] = launches.get(fam, 0) + 1
        emit({"phase": "frame", "B": B, "temperature": temp, "rows": rows,
              "enqueue_ms": enqueue, "event_ms": event,
              "device_ms": sum(by_family.values()),
              "device_ms_by_family": by_family,
              "launches_per_frame": {k: v / REPS for k, v in launches.items()}})


def _profile_frames(frame, reps: int = REPS) -> dict:
    """Host wall ms per frame over ``reps`` calls of ``frame()`` then one
    sync, and the device ms per frame in all and by kernel family (copies
    excluded), with launches per frame by family, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        frame()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    traced = []
    # One traced warm-up step first: the tracer misses launches at its start.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.append(_device_events(p))) as prof:
        for n in (1, reps):
            for _ in range(n):
                frame()
            torch.cuda.synchronize()
            prof.step()
    by_family: dict = {}
    launches: dict = {}
    for name, t0_us, t1_us in traced[0]:
        if _is_copy(name):
            continue
        fam = _family(name)
        by_family[fam] = by_family.get(fam, 0.0) + (t1_us - t0_us) / 1e3 / reps
        launches[fam] = launches.get(fam, 0) + 1
    return {"wall_ms": wall, "device_ms": sum(by_family.values()),
            "device_ms_by_family": by_family,
            "launches_per_frame": {k: v / reps for k, v in launches.items()}}


def profile_split(dev, split: bool) -> None:
    """One frame as the loops run it, fused and (with ``split``) split."""
    import torch

    from magpie_tts_tpu_torch.config import MagpieConfig
    from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
    from magpie_tts_tpu_torch.models.magpie import audio_frame_embedding
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb

    c = MagpieConfig()
    w = random_magpie_weights(c, seed=0).to(device=dev)
    S, L, D, E, B, row = c.max_seq, c.dec_layers, c.d_model, 128, 8, 300
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=0.5: torch.randn(*shape, generator=gen, device=dev) * s
    kc, vc = rnd(B, L, S, D), rnd(B, L, S, D)
    xa_k, xa_v = rnd(B, L, E, c.d_xa), rnd(B, L, E, c.d_xa)
    hidden = rnd(B, D, s=1.0)
    eos = c.audio_eos_id
    one = dict(xa_k=xa_k[0], xa_v=xa_v[0], k_cache=kc[0], v_cache=vc[0], weights=w, config=c)
    valid = (torch.arange(S, device=dev) <= row)[None].expand(B, -1)
    posemb = w.decoder.pos_emb[row][None].expand(B, -1)
    enc = torch.full((B,), 32, dtype=torch.int32, device=dev)
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    forbid = torch.zeros(B, dtype=torch.bool, device=dev)
    batched = dict(xa_k=xa_k, xa_v=xa_v, k_cache=kc, v_cache=vc, weights=w, config=c)

    def fused_one():
        sampled, argmax, _, _, _ = fs.frame_step(hidden[0], row, seed=7, temperature=0.7,
                                                 top_k=80, forbid_eos=False, enc_length=32,
                                                 **one)
        return bool(((sampled == eos) | (argmax == eos)).any().cpu())

    def fused_batched():
        sampled, argmax, _, _, _ = fsb.frame_step_batched(
            hidden, row, valid, torch.ones(B, dtype=torch.bool, device=dev), posemb,
            enc_lengths=enc, seeds=seeds, temperature=0.7, top_k=80, forbid_eos=forbid,
            rows=row + 1, **batched)
        return ((sampled == eos) | (argmax == eos)).any(-1)

    frames = {("fused", 1): fused_one, ("fused", B): fused_batched}
    if split:
        from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
        from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
        from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts
        from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb

        def split_one():
            sampled, argmax = lts.sample_frame_codes(hidden[0], w, c, 7, 0.7, 80, False)
            done = bool(((sampled == eos) | (argmax == eos)).any().cpu())
            ds.decode_step(audio_frame_embedding(sampled, w, c), row, enc_length=32, **one)
            return done

        def split_batched():
            sampled, argmax = ltsb.sample_frame_codes_batched(hidden, w, c, seeds, 0.7, 80,
                                                              forbid)
            is_eos = ((sampled == eos) | (argmax == eos)).any(-1)
            x_pe = audio_frame_embedding(sampled, w, c) + posemb
            dsb.decode_step_batched(x_pe, row, valid, enc_lengths=enc, rows=row + 1, **batched)
            return is_eos

        emb = audio_frame_embedding(torch.zeros(c.num_codebooks, dtype=torch.int32, device=dev),
                                    w, c)
        x_pe = audio_frame_embedding(torch.zeros(B, c.num_codebooks, dtype=torch.int32,
                                                 device=dev), w, c) + posemb
        frames.update({
            ("split", 1): split_one, ("split", B): split_batched,
            ("lt_sampler", 1): lambda: lts.sample_frame_codes(hidden[0], w, c, 7, 0.7, 80, False),
            ("decoder_step", 1): lambda: ds.decode_step(emb, row, enc_length=32, **one),
            ("lt_sampler_batched", B): lambda: ltsb.sample_frame_codes_batched(
                hidden, w, c, seeds, 0.7, 80, forbid),
            ("decoder_step_batched", B): lambda: dsb.decode_step_batched(
                x_pe, row, valid, enc_lengths=enc, rows=row + 1, **batched)})
    with torch.no_grad():
        for (path, b), frame in frames.items():
            emit({"phase": "split" if split else "fused", "path": path, "B": b, "row": row,
                  "temperature": 0.7, **_profile_frames(frame)})


def profile_stream(dev) -> None:
    """Kernels A, 5, C and 8 by weight stream, one frame each."""
    import torch

    from chip_smoke import prod_streams, prod_weights
    from magpie_tts_tpu_torch.models.magpie import audio_frame_embedding
    from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
    from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb

    c, w = prod_weights(dev)
    q8, deq, int8 = prod_streams(dev)
    S, L, D, E, B, row = c.max_seq, c.dec_layers, c.d_model, 128, 8, 300
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=0.5: torch.randn(*shape, generator=gen, device=dev) * s
    kc, vc = rnd(B, L, S, D), rnd(B, L, S, D)
    xa_k, xa_v = rnd(B, L, E, c.d_xa), rnd(B, L, E, c.d_xa)
    hidden = rnd(B, D, s=1.0)
    valid = (torch.arange(S, device=dev) <= row)[None].expand(B, -1)
    posemb = w.decoder.pos_emb[row][None].expand(B, -1)
    enc = torch.full((B,), 32, dtype=torch.int32, device=dev)
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    forbid = torch.zeros(B, dtype=torch.bool, device=dev)
    codes = torch.zeros(B, c.num_codebooks, dtype=torch.int32, device=dev)
    x_pe = audio_frame_embedding(codes, w, c) + posemb
    with torch.no_grad():
        for mode, weights, stream in (("dense", w, None), ("int8", w, int8), ("q8", deq, q8)):
            one = dict(xa_k=xa_k[0], xa_v=xa_v[0], k_cache=kc[0], v_cache=vc[0],
                       weights=weights, config=c, stream=stream)
            batched = dict(xa_k=xa_k, xa_v=xa_v, k_cache=kc, v_cache=vc, weights=weights,
                           config=c, stream=stream)
            frames = {
                ("frame_step", 1): lambda: fs.frame_step(
                    hidden[0], row, seed=7, temperature=0.7, top_k=80, forbid_eos=False,
                    enc_length=32, **one),
                ("decoder_step", 1): lambda: ds.decode_step(x_pe[0], row, enc_length=32, **one),
                ("frame_step_batched", B): lambda: fsb.frame_step_batched(
                    hidden, row, valid, torch.ones(B, dtype=torch.bool, device=dev), posemb,
                    enc_lengths=enc, seeds=seeds, temperature=0.7, top_k=80, forbid_eos=forbid,
                    rows=row + 1, **batched),
                ("decoder_step_batched", B): lambda: dsb.decode_step_batched(
                    x_pe, row, valid, enc_lengths=enc, rows=row + 1, **batched)}
            for (path, b), frame in frames.items():
                emit({"phase": "stream", "stream": mode, "path": path, "B": b, "row": row,
                      "temperature": 0.7, **_profile_frames(frame)})
            if _stamped(fs):
                for path, run in (
                        ("frame_step", lambda st: fs.frame_step(
                            hidden[0], row, seed=7, temperature=0.7, top_k=80, forbid_eos=False,
                            enc_length=32, stamps=st, **one)),
                        ("decoder_step", lambda st: ds.decode_step(
                            x_pe[0], row, enc_length=32, stamps=st, **one))):
                    emit({"phase": "stream", "stream": mode, "path": path, "B": 1, "row": row,
                          "temperature": 0.7, **stamp_breakdown(run)})


ADMIT_BUCKET, ADMIT_M_MAX = 32, 32


def _per_request_products(a, b):
    """``matmul_f32`` with every product of a weight in the request's own
    shape: a strided-batched ``bmm`` over the leading dims (the weight
    broadcast, stride 0) in place of torch.matmul's M x T rows."""
    import torch

    a, b = a.float(), b.float()
    if b.dim() != 2:
        return torch.matmul(a, b)
    if a.dim() == 2:
        return torch.bmm(a[:, None, :], b.expand(a.shape[0], *b.shape))[:, 0]
    a3 = a.reshape(-1, *a.shape[-2:])
    out = torch.bmm(a3, b.expand(a3.shape[0], *b.shape))
    return out.reshape(*a.shape[:-1], b.shape[-1])


def profile_admission(dev) -> None:
    """``prepare_batch`` at 357M, bucket 32, random weights: (1) rows of
    groups of M = 2, 8, 32 against each request's group of 1, in both
    dtypes, with the products as the port runs them (torch.matmul folds M x
    T rows) and as a strided-batched bmm of the request's own shape: the
    share of elements bit-equal and the largest difference over the largest
    value; (2) device work at M = 1, 8, 32 by family (torch.profiler:
    cuBLAS GEMM / GEMV / split-K reduce, PyTorch kernels, copies and fills);
    (3) bf16 at M = 1 on the float32 copies against widening per product,
    host ms in turns (copy, widen, widen, copy)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from magpie_tts_tpu_torch.config import MagpieConfig
    from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
    from magpie_tts_tpu_torch.models import decoder as decoder_mod
    from magpie_tts_tpu_torch.models import magpie as magpie_mod
    from magpie_tts_tpu_torch.ops import attention, conv_ffn

    c = MagpieConfig()
    w32 = random_magpie_weights(c, seed=0).to(device=dev)
    rng = np.random.default_rng(3)
    lens = [int(n) for n in rng.integers(1, ADMIT_BUCKET + 1, ADMIT_M_MAX)]
    lens[0], lens[1] = 1, ADMIT_BUCKET
    tokens = np.zeros((ADMIT_M_MAX, ADMIT_BUCKET), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(2, c.text_vocab_size - 2, n)
    tokens = torch.from_numpy(tokens).to(dev)
    spk = [i % c.num_speakers for i in range(ADMIT_M_MAX)]
    modules = (attention, conv_ffn, decoder_mod)
    folded = attention.matmul_f32

    def group(m, w, first=0):
        return magpie_mod.prepare_batch(tokens[first:first + m], lens[first:first + m],
                                        spk[first:first + m], w, c)

    def family(name):
        if name.startswith(("Memcpy", "Memset")):
            return name.split()[0].lower()
        if "splitKreduce" in name:
            return "cublas_splitk_reduce"
        if "gemv" in name.lower():
            return "cublas_gemv"
        if "gemm" in name.lower() or "cutlass" in name:
            return "cublas_gemm"
        return "torch"

    for dtype in ("float32", "bfloat16"):
        w = magpie_mod.float32_products(w32.to(dtype=getattr(torch, dtype)))
        with torch.no_grad():
            for form, fn in (("folded", folded), ("per_request_bmm", _per_request_products)):
                for mod in modules:
                    mod.matmul_f32 = fn
                try:
                    alone = [group(1, w, i) for i in range(ADMIT_M_MAX)]
                    for m in (2, 8, ADMIT_M_MAX):
                        got = group(m, w)
                        equal, rel = [], []
                        for k in range(5):
                            a = torch.cat([alone[i][k] for i in range(m)])
                            equal.append(float((got[k] == a).float().mean()))
                            rel.append(float((got[k].float() - a.float()).abs().max()
                                             / a.float().abs().max()))
                        emit({"phase": "admission", "what": "rows_vs_alone", "dtype": dtype,
                              "products": form, "M": m, "share_bit_equal": min(equal),
                              "max_rel": max(rel)})
                finally:
                    for mod in modules:
                        mod.matmul_f32 = folded
            work = {}
            for m in (1, 8, ADMIT_M_MAX):
                group(m, w)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    group(m, w)
                    torch.cuda.synchronize()
                fams: dict = {}
                for e in prof.events():
                    if e.device_type == DeviceType.CUDA:
                        fams[family(e.name)] = fams.get(family(e.name), 0) + 1
                work[m] = fams
            emit({"phase": "admission", "what": "device_work", "dtype": dtype,
                  "by_family": work, "total": {m: sum(f.values()) for m, f in work.items()}})
            if dtype == "bfloat16":
                widen = w32.to(dtype=torch.bfloat16)
                ms = {"copy": [], "widen": []}
                for who in ("copy", "widen", "widen", "copy"):
                    weights = w if who == "copy" else widen
                    group(1, weights)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(5):
                        group(1, weights)
                    torch.cuda.synchronize()
                    ms[who].append((time.perf_counter() - t0) * 1e3 / 5)
                emit({"phase": "admission", "what": "bf16_m1_host_ms", **ms,
                      "copy_bytes": sum(getattr(getattr(w, part), n).numel() * 4
                                        for part, names in magpie_mod.PREPARE_PRODUCTS.items()
                                        for n in names)})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    args = sys.argv[1:]
    root = Path(__file__).resolve().parent
    if "--root" in args:
        i = args.index("--root")
        root = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.path.insert(0, str(root))
    from chip_smoke import card_line
    from magpie_tts_tpu_torch.ops.kernels import build
    from magpie_tts_tpu_torch.runtime.engine import resolve_device

    what = args[0] if args else "all"
    if what not in ("frame", "split", "fused", "stream", "slope", "lt", "q8", "gemv", "copy",
                    "admission", "all"):
        print("usage: python3 chip_profile.py "
              "[frame|split|fused|stream|slope|lt|q8|gemv|copy|admission|all] [--root DIR]",
              file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    emit({"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda,
          "package": str(Path(build.__file__).resolve().parents[3])})
    build.load_library()
    if what in ("frame", "all"):
        profile_frame(dev)
        profile_persistent(dev)
    if what in ("slope", "all"):
        profile_slope(dev)
    if what == "lt":
        profile_slope(dev, lt_only=True)
        profile_lt_stamps(dev)
    if what == "q8":
        profile_q8(dev)
    if what == "gemv":
        profile_gemv(dev)
    if what in ("copy", "all"):
        profile_copy(dev)
    if what in ("split", "fused", "all"):
        profile_split(dev, split=what != "fused")
    if what in ("stream", "all"):
        profile_stream(dev)
    if what in ("admission", "all"):
        profile_admission(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
