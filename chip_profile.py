"""Profile of the PyTorch/CUDA port on one NVIDIA GPU: where the batched frame
kernel's time goes, the fused frame against the split path, and where
``serve``'s time goes.

Run from the root of a checkout:
    python3 chip_profile.py [frame|split|fused|stream|slope|serve|all] [--root DIR]

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
slope: kernels A and 5 at 357M width, row 300, temp 0.7, dense float32 and
    bf16: device ms a frame by CUDA-graph slope (scripts/timing.py
    graph_slope, SLOPE_N frames a graph); with ``--root DIR`` another
    checkout's kernels, so parent and change time in turns in one call.
    The persistent kernels (A, 5 since their redesign) are also broken down
    in ``frame``, ``split`` and ``stream`` by their phase stamps (block 0's
    %globaltimer at each phase's start, prologue end and barrier arrival):
    ms a frame in GEMV work, attention, LayerNorm / epilogue, sampling and
    barrier wait (``stamp_ms``), and the barriers counted.
serve: ``cli.main serve`` on random production-width GGUFs (chip_smoke's),
    16-frame segments, temp 0.7, for each (slots, requests) of SERVE_CASES,
    after one warm-up run: an unprofiled run (serve's aggregate fps and the
    wall seconds spent in admission, segments and ``decode_batch``) and a
    profiled run. ``busy_share`` is the device's busy time inside serve's
    loop window (the ``serve.loop`` span, the window of serve's
    aggregate-fps line) over that window's length; busy time is the union of
    the kernels' intervals, copies excluded.

Every result is one JSON line on stdout; the card's nvidia-smi name and power
limit come first.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

FRAME_CASES = [(1, 0.7, 640), (1, 0.7, 301), (8, 0.0, 301), (8, 0.7, 640), (8, 0.7, 301),
               (32, 0.7, 640), (32, 0.7, 301)]
SERVE_CASES = [(4, 6), (8, 16), (32, 48)]
SERVE_SEGMENT = 16
REPS = 20
SLOPE_N = (4, 16, 3)   # graph slopes: frames a graph, lo / hi, and replays
# Kernel families by the device kernels' names (csrc/): the split-row
# attention's two launches, the batched frames' tensor-core GEMM, the
# single-stream GEMV, the reducers and the LT sampling.
# A parent checkout's (--root) names from before the split-row attention
# and the tensor-core GEMM come last: attention_kernel, gemm_splitk_kernel.
FAMILIES = {"persistent": ("frame_persistent_kernel",),
            "attention": ("attention_scores_kernel", "attention_pv_kernel", "attention_kernel"),
            "gemm": ("gemm_mma_kernel", "gemm_splitk_kernel"), "gemv": ("gemv_splitk_kernel",),
            "combine_ln": ("combine_ln_kernel", "decoder_input_kernel"),
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


def profile_slope(dev) -> None:
    """Kernels A and 5 by CUDA-graph slope (dense, float32 and bf16, row
    300): ms a frame, device only."""
    import torch

    from chip_smoke import prod_weights
    from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.scripts import timing

    for dtype in ("float32", "bfloat16"):
        c, w = prod_weights(dev, dtype)
        T = w.decoder.qkv.dtype
        S, L, D, E, row = c.max_seq, c.dec_layers, c.d_model, 32, 300
        gen = torch.Generator(device=dev).manual_seed(0)
        rnd = lambda *shape, s=0.5: (torch.randn(*shape, generator=gen, device=dev) * s).to(T)
        kc, vc = rnd(L, S, D), rnd(L, S, D)
        xa = dict(xa_k=rnd(L, E, c.d_xa), xa_v=rnd(L, E, c.d_xa), weights=w, config=c,
                  enc_length=E)
        hidden = rnd(D, s=1.0)

        def a_body(i, h):
            return fs.frame_step(h, row, k_cache=kc, v_cache=vc, seed=i, temperature=0.7,
                                 top_k=80, forbid_eos=False, **xa)[2]

        def five_body(i, h):
            return ds.decode_step(h, row, k_cache=kc, v_cache=vc, **xa)

        with torch.no_grad():
            for path, body in (("frame_step", a_body), ("decoder_step", five_body)):
                t = timing.graph_slope(body, hidden, *SLOPE_N)
                emit({"phase": "slope", "path": path, "dtype": dtype, "B": 1, "row": row,
                      "graph_ms": t["per_launch_ms"], "n": SLOPE_N})
        del w, kc, vc, xa
        torch.cuda.empty_cache()
    if hasattr(fs, "barrier_probe"):
        from chip_smoke import barrier_cost

        emit({"phase": "slope", "path": "barrier_probe", **barrier_cost(dev, SLOPE_N)})


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


class _StageTimer:
    """Wall seconds spent inside a few methods, by name."""

    def __init__(self, targets):
        self.targets = targets       # [(owner, attribute name)]
        self.seconds = {name: 0.0 for _, name in targets}
        self._saved = []

    def __enter__(self):
        for owner, name in self.targets:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))

            def timed(*a, _fn=fn, _name=name, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self.seconds[_name] += time.perf_counter() - t0
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _serve_once(tmp: Path, slots: int, n_requests: int, seed0: int):
    """One cli.main serve run; returns (stderr, frames)."""
    from chip_smoke import SERVE_TEXTS
    from magpie_tts_tpu_torch import cli

    lines = [json.dumps({"id": f"q{i}", "text": SERVE_TEXTS[i % len(SERVE_TEXTS)],
                         "seed": seed0 + i}) for i in range(n_requests)]
    argv = ["serve", "-m", str(tmp / "magpie.gguf"), "-c", str(tmp / "codec.gguf"),
            "--out-dir", str(tmp / "serve"), "--slots", str(slots), "--segment-frames",
            str(SERVE_SEGMENT), "--temp", "0.7", "--device", "cuda"]
    out, err, stdin = io.StringIO(), io.StringIO(), sys.stdin
    sys.stdin = io.StringIO("\n".join(lines) + "\n")
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        sys.stdin = stdin
    results = [json.loads(ln) for ln in out.getvalue().splitlines()]
    if rc != 0 or len(results) != n_requests or any("error" in r for r in results):
        raise AssertionError(f"serve run failed (rc {rc}): {err.getvalue()[-2000:]}")
    return err.getvalue(), sum(r["frames"] for r in results)


def _busy_share(prof) -> dict:
    """Union of kernel intervals inside the serve.loop span, over the span."""
    from torch.autograd import DeviceType

    spans = [e for e in prof.events() if e.name == "serve.loop" and e.device_type == DeviceType.CPU]
    if len(spans) != 1:
        raise AssertionError(f"the profile holds {len(spans)} serve.loop spans, want 1")
    ws, we = spans[0].time_range.start, spans[0].time_range.end
    kernels = sorted((max(t0, ws), min(t1, we)) for name, t0, t1 in _device_events(prof)
                     if not _is_copy(name) and t1 > ws and t0 < we)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return {"window_s": (we - ws) / 1e6, "device_busy_s": busy / 1e6,
            "busy_share": busy / (we - ws), "kernels_in_window": len(kernels)}


def profile_serve() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import write_ggufs
    from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine

    fps_re = re.compile(r"(\d+) frames in ([0-9.]+)s \(([0-9.]+) aggregate fps")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_ggufs(tmp)
        _serve_once(tmp, 8, 2, 1000)   # warm-up: kernel build, CUDA init
        for slots, n_req in SERVE_CASES:
            stages = [(ContinuousBatchingEngine, "_admit_pending"),
                      (ContinuousBatchingEngine, "_segment"), (CodecEngine, "decode_batch")]
            with _StageTimer(stages) as timer:
                log, frames = _serve_once(tmp, slots, n_req, 0)
            m = fps_re.search(log)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                plog, _ = _serve_once(tmp, slots, n_req, 0)
                torch.cuda.synchronize()
            pm = fps_re.search(plog)
            emit({"phase": "serve", "slots": slots, "requests": n_req, "frames": frames,
                  "serve_s": float(m.group(2)), "fps": float(m.group(3)),
                  "stage_wall_s": timer.seconds,
                  "profiled": {"serve_s": float(pm.group(2)), "fps": float(pm.group(3)),
                               **_busy_share(prof)}})


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
    if what not in ("frame", "split", "fused", "stream", "slope", "serve", "all"):
        print("usage: python3 chip_profile.py [frame|split|fused|stream|slope|serve|all] "
              "[--root DIR]",
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
    if what in ("split", "fused", "all"):
        profile_split(dev, split=what != "fused")
    if what in ("stream", "all"):
        profile_stream(dev)
    if what in ("serve", "all"):
        profile_serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
