"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero):
1. the card (nvidia-smi name + power limit), torch / CUDA versions, and the
   build of the hand-written kernels from csrc/ (nvcc, sm_90a);
2. each kernel against its plain PyTorch version on the card at full 357M
   width: the frame step at several cache positions and temperatures, the
   batched frame step at B=8 and B=32 with ring-style masks and at serve's B
   with its arguments as the continuous and lockstep engines pass them
   (attention bound, broadcast rows), the codec conv
   for every (C_in, C_out, k, dilation, residual) class a decode runs; with
   both times;
3. the main path through the user entry point: production-width random
   GGUFs, ``magpie_tts_tpu_torch.cli.main`` with ``--device cuda``, the WAV
   checked, and the kernels' launch counts checked against the loop;
4. the serve path on the same GGUFs: ``cli.main(["serve", ...])`` with JSONL
   requests on a stdin stand-in, every WAV checked, the batched kernel's
   launches checked against the segments run.

The line before last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

FRAME_TOL = 1e-4   # hidden / cache rows: GEMV summation order differs from torch.matmul
CONV_ATOL = 1e-4   # conv outputs of O(1): summation order differs from F.conv1d
CONV_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- GGUF files

def write_model_gguf(path: str, config, seed: int) -> None:
    """Random-weight Magpie GGUF with the converter's tensor names, hparams
    and a small tokenizer payload."""
    from magpie_tts_tpu_torch.io.gguf import GGUFWriter

    c = config
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.02):
        return rng.normal(0, scale, size=shape).astype(np.float32)

    def g(*shape):
        return (1.0 + rng.normal(0, 0.05, size=shape)).astype(np.float32)

    wr = GGUFWriter()
    wr.add_metadata("general.architecture", "magpie")
    for key, val in (("d_model", c.d_model), ("d_ffn", c.d_ffn), ("d_head", c.d_head),
                     ("encoder_layers", c.enc_layers), ("decoder_layers", c.dec_layers),
                     ("encoder_heads", c.enc_heads), ("enc_kernel", c.enc_kernel),
                     ("decoder_sa_heads", c.dec_sa_heads),
                     ("decoder_xa_heads", c.dec_xa_heads), ("dec_xa_d_head", c.dec_xa_d_head),
                     ("local_transformer_dim", c.lt_dim), ("lt_ffn_dim", c.lt_ffn_dim),
                     ("text_vocab_size", c.text_vocab_size),
                     ("num_codebooks", c.num_codebooks), ("codebook_size", c.codebook_size),
                     ("vocab_size_per_codebook", c.vocab_per_cb),
                     ("num_baked_speakers", c.num_speakers),
                     ("baked_context_frames", c.context_frames),
                     ("text_bos_id", c.text_bos_id), ("text_eos_id", c.text_eos_id),
                     ("audio_bos_id", c.audio_bos_id), ("audio_eos_id", c.audio_eos_id),
                     ("max_dec_steps", c.max_dec_steps),
                     ("min_generated_frames", c.min_generated_frames),
                     ("max_pos", c.max_pos)):
        wr.add_metadata(f"magpie.{key}", val)
    vocab = (["a", "b", "c", "d", "e", "f"] + [",", ".", "!", "?", ":", ";"] +
             [chr(x) for x in range(ord("A"), ord("Z") + 1)] +
             [f"t{i}" for i in range(38, 93)] + [" ", "<pad>", "<oov>"])
    wr.add_metadata("magpie.tokenizer.vocab", "\n".join(vocab))
    wr.add_metadata("magpie.tokenizer.dict", "hello\tabcd\nworld\tfeda")
    wr.add_metadata("magpie.tokenizer.space", 93)
    wr.add_metadata("magpie.tokenizer.pad", 94)
    wr.add_metadata("magpie.tokenizer.oov", 95)

    D, F = c.d_model, c.d_ffn
    wr.add_tensor("text_embedding.weight", w(c.text_vocab_size, D))
    wr.add_tensor("encoder.position_embeddings.weight", w(c.max_pos, D))
    for i in range(c.enc_layers):
        p = f"encoder.layers.{i}"
        wr.add_tensor(f"{p}.norm_self.weight", g(D))
        wr.add_tensor(f"{p}.self_attention.qkv_net.weight", w(3 * D, D))
        wr.add_tensor(f"{p}.self_attention.o_net.weight", w(D, D))
        wr.add_tensor(f"{p}.norm_pos_ff.weight", g(D))
        wr.add_tensor(f"{p}.pos_ff.proj.conv.weight", w(F, D, c.enc_kernel))
        wr.add_tensor(f"{p}.pos_ff.o_net.conv.weight", w(D, F, c.enc_kernel))
    wr.add_tensor("encoder.norm_out.weight", g(D))
    wr.add_tensor("decoder.position_embeddings.weight", w(c.max_pos, D))
    for i in range(c.dec_layers):
        p = f"decoder.layers.{i}"
        wr.add_tensor(f"{p}.norm_self.weight", g(D))
        wr.add_tensor(f"{p}.self_attention.qkv_net.weight", w(3 * D, D))
        wr.add_tensor(f"{p}.self_attention.o_net.weight", w(D, D))
        wr.add_tensor(f"{p}.norm_xattn_query.weight", g(D))
        wr.add_tensor(f"{p}.norm_xattn_memory.weight", g(D))
        wr.add_tensor(f"{p}.cross_attention.q_net.weight", w(c.d_xa, D))
        wr.add_tensor(f"{p}.cross_attention.kv_net.weight", w(2 * c.d_xa, D))
        wr.add_tensor(f"{p}.cross_attention.o_net.weight", w(D, c.d_xa))
        wr.add_tensor(f"{p}.norm_pos_ff.weight", g(D))
        wr.add_tensor(f"{p}.pos_ff.proj.conv.weight", w(F, D, 1))
        wr.add_tensor(f"{p}.pos_ff.o_net.conv.weight", w(D, F, 1))
    wr.add_tensor("decoder.norm_out.weight", g(D))
    for i in range(c.num_codebooks):
        wr.add_tensor(f"audio_embeddings.{i}.weight", w(c.vocab_per_cb, D))
    wr.add_tensor("baked_context_embedding.weight",
                  w(c.num_speakers, c.context_frames * D))
    wr.add_tensor("final_proj.weight", w(c.num_codebooks * c.vocab_per_cb, D))
    wr.add_tensor("final_proj.bias", w(c.num_codebooks * c.vocab_per_cb))
    wr.add_tensor("local_transformer_in_projection.weight", w(c.lt_dim, D))
    wr.add_tensor("local_transformer_in_projection.bias", w(c.lt_dim))
    wr.add_tensor("local_transformer.position_embeddings.weight", w(c.lt_max_pos, c.lt_dim))
    lp = "local_transformer.layers.0"
    wr.add_tensor(f"{lp}.norm_self.weight", g(c.lt_dim))
    wr.add_tensor(f"{lp}.self_attention.qkv_net.weight", w(3 * c.lt_dim, c.lt_dim))
    wr.add_tensor(f"{lp}.self_attention.o_net.weight", w(c.lt_dim, c.lt_dim))
    wr.add_tensor(f"{lp}.norm_pos_ff.weight", g(c.lt_dim))
    wr.add_tensor(f"{lp}.pos_ff.proj.conv.weight", w(c.lt_ffn_dim, c.lt_dim, 1))
    wr.add_tensor(f"{lp}.pos_ff.o_net.conv.weight", w(c.lt_dim, c.lt_ffn_dim, 1))
    for i in range(c.num_codebooks):
        wr.add_tensor(f"local_transformer_out_projections.{i}.weight",
                      w(c.vocab_per_cb, c.lt_dim))
        wr.add_tensor(f"local_transformer_out_projections.{i}.bias", w(c.vocab_per_cb))
    wr.write(path)


def write_codec_gguf(path: str, config, seed: int) -> None:
    """Random-weight nano-codec GGUF with the converter's tensor names."""
    from magpie_tts_tpu_torch.io.gguf import GGUFWriter

    c = config
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.1):
        return rng.normal(0, scale, size=shape).astype(np.float32)

    def a(n):
        return rng.uniform(0.4, 1.4, size=(1, n, 1)).astype(np.float32)

    wr = GGUFWriter()
    wr.add_metadata("general.architecture", "nano-codec")
    for key in ("sample_rate", "num_codebooks", "codebook_size", "hop_length",
                "latent_dim", "base_channels"):
        wr.add_metadata(f"codec.{key}", getattr(c, key))
    for i, (r, ch, k) in enumerate(zip(c.up_sample_rates, c.up_channels, c.up_kernels)):
        wr.add_metadata(f"codec.up_sample_rates_{i}", r)
        wr.add_metadata(f"codec.up_channels_{i}", ch)
        wr.add_metadata(f"codec.up_kernels_{i}", k)
    wr.add_tensor("dec.pre.weight", w(c.base_channels, c.latent_dim, c.pre_conv_kernel))
    wr.add_tensor("dec.pre.bias", w(c.base_channels))
    in_chs = (c.base_channels,) + c.up_channels[:-1]
    for i, (in_ch, out_ch, k_up) in enumerate(zip(in_chs, c.up_channels, c.up_kernels)):
        wr.add_tensor(f"dec.act.{i}.activation.snake_act.alpha", a(in_ch // 2))
        wr.add_tensor(f"dec.up.{i}.c.weight", w(in_ch, 1, k_up))
        wr.add_tensor(f"dec.up.{i}.c.bias", w(out_ch))
        for j, k in enumerate(c.resblock_kernel_sizes):
            for kk in range(len(c.resblock_dilations)):
                p = f"dec.rl.{i}.rb.{j}.rb.{kk}"
                wr.add_tensor(f"{p}.in_act.alpha", a(out_ch // 2))
                wr.add_tensor(f"{p}.in_conv.weight", w(out_ch, out_ch, k))
                wr.add_tensor(f"{p}.in_conv.bias", w(out_ch))
                wr.add_tensor(f"{p}.sk_act.alpha", a(out_ch // 2))
                wr.add_tensor(f"{p}.sk_conv.weight", w(out_ch, out_ch, k))
                wr.add_tensor(f"{p}.sk_conv.bias", w(out_ch))
    wr.add_tensor("dec.post_act.alpha", a(c.up_channels[-1] // 2))
    wr.add_tensor("dec.post.weight", w(1, c.up_channels[-1], c.post_conv_kernel))
    wr.add_tensor("dec.post.bias", w(1))
    wr.write(path)


# ------------------------------------------------------------------ phases

def check_frame_step(dev) -> dict:
    """Kernel A vs frame_step_reference at full width on the card."""
    import torch

    from magpie_tts_tpu_torch.config import MagpieConfig
    from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
    from magpie_tts_tpu_torch.models import magpie as magpie_mod
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs

    c = MagpieConfig()
    w = random_magpie_weights(c, seed=0).to(device=dev)
    rng = np.random.default_rng(0)
    enc_len = 20
    tokens = torch.tensor(rng.integers(2, c.text_vocab_size - 2, size=32), device=dev)
    with torch.no_grad():
        xa_k, xa_v, st = magpie_mod.prepare(tokens, enc_len, 0, w, c)
    # Rows past the speaker context hold random K/V of the prefill's scale.
    scale = float(st.k_cache[:, :c.context_frames].std())
    gen = torch.Generator(device=dev).manual_seed(0)
    filler = lambda: torch.randn(st.k_cache.shape, generator=gen, device=dev) * scale
    k_base = torch.where(torch.arange(c.max_seq, device=dev)[None, :, None] < c.context_frames + 1,
                         st.k_cache, filler())
    v_base = torch.where(torch.arange(c.max_seq, device=dev)[None, :, None] < c.context_frames + 1,
                         st.v_cache, filler())
    # 111, 300 and 610 at 357M width: the first decode row, mid-cache, near full.
    positions = (c.context_frames + 1, c.max_seq // 2 - 20, c.max_seq - 30)
    worst, flips = 0.0, 0
    with torch.no_grad():
        for pos in positions:
            for temp in (0.0, 0.7):
                seed = 1000 + pos
                kk, vk = k_base.clone(), v_base.clone()
                kr, vr = k_base.clone(), v_base.clone()
                sk, ak, hk, _, _ = fs.frame_step(st.hidden, pos, xa_k, xa_v, kk, vk, w, c, seed,
                                                 temp, 80, False, enc_length=enc_len)
                sr, ar, hr, _, _ = fs.frame_step_reference(st.hidden, pos, xa_k, xa_v, kr, vr, w,
                                                           c, seed, temp, 80, False,
                                                           enc_length=enc_len)
                torch.cuda.synchronize()
                n_diff = int((sk != sr).sum()) + int((ak != ar).sum())
                err = max(float((hk - hr).abs().max()), float((kk - kr).abs().max()),
                          float((vk - vr).abs().max()))
                log(f"frame_step pos {pos} temp {temp}: codes differing {n_diff} "
                    f"(kernel {sk.tolist()} plain {sr.tolist()}), max |hidden/cache err| {err:.3g}")
                if temp == 0.0 and n_diff:
                    raise AssertionError(f"frame_step codes differ at temp 0, pos {pos}")
                flips += n_diff if temp > 0 else 0
                if err > FRAME_TOL:
                    raise AssertionError(f"frame_step disagrees at pos {pos}: {err} > {FRAME_TOL}")
                worst = max(worst, err)
        log(f"frame_step: differing codes at temp 0.7 over 3 positions: {flips}")
        # Times at the middle position, temp 0.7 (its cache row is rewritten per call).
        args = (st.hidden, positions[1], xa_k, xa_v, k_base.clone(), v_base.clone(), w, c, 7, 0.7, 80,
                False)
        ms = time_ms(lambda: fs.frame_step(*args, enc_length=enc_len), reps=50)
        plain_ms = time_ms(lambda: fs.frame_step_reference(*args, enc_length=enc_len), reps=5)
    log(f"frame_step time at pos {positions[1]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "temp07_code_flips": flips}


def _ring_valid(B: int, S: int, write_row: int, rng):
    """Per-slot valid rows as the ring cache leaves them: runs of different
    lengths and starts, some wrapping past S - 1; the last slot empty."""
    valid = np.zeros((B, S), bool)
    for b in range(B - 1):
        n = int(rng.integers(60, 400))
        valid[b, (write_row + 1 + int(rng.integers(0, S)) + np.arange(n)) % S] = True
    valid[:, write_row] = False
    return valid


def check_engine_arguments(fsb, kind: str, x: dict, k_base, v_base, temp: float, w, c,
                           dev) -> int:
    """Kernel C with its arguments as an engine passes them, against the plain
    version, and against itself with the attention bound at max_seq (bit for
    bit: rows past the bound hold no valid row). ``continuous``: valid rows
    behind the shared write row and ``rows`` the end of the segment, as the
    ring engine tracks it (the last slot empty); ``lockstep``: one broadcast
    row ``arange(S) <= pos`` and one posemb row (stride 0), ``rows = pos + 1``.
    Returns the number of codes differing from plain (0 at temp 0)."""
    import torch

    B, S, r = x["hidden"].shape[0], c.max_seq, x["write_row"]
    if kind == "continuous":
        rows, live = min(S, r + SERVE_SEGMENT), slice(0, B - 1)
        valid = np.zeros((B, S), bool)
        for b in range(B - 1):
            valid[b, r - 1 - b * (r // B):r] = True
        x["valid"] = torch.tensor(valid, device=dev)
    else:
        rows, live = r + 1, slice(0, B)
        x["valid"] = (torch.arange(S, device=dev) <= r)[None].expand(B, -1)
        x["posemb"] = w.decoder.pos_emb[r][None].expand(B, -1)
    caches = [(k_base.clone(), v_base.clone()) for _ in range(3)]
    (kk, vk), (kf, vf), (kr, vr) = caches
    sk, ak, hk, _, _ = fsb.frame_step_batched(k_cache=kk, v_cache=vk, temperature=temp,
                                              rows=rows, **x)
    sf, af, hf, _, _ = fsb.frame_step_batched(k_cache=kf, v_cache=vf, temperature=temp,
                                              rows=S, **x)
    sr, ar, hr, _, _ = fsb.frame_step_batched_reference(k_cache=kr, v_cache=vr,
                                                        temperature=temp, rows=rows, **x)
    torch.cuda.synchronize()
    bound_exact = (torch.equal(sk, sf) and torch.equal(ak, af) and
                   all(torch.equal(a[live], b[live]) for a, b in ((hk, hf), (kk, kf), (vk, vf))))
    n_diff = int((sk != sr).sum()) + int((ak != ar).sum())
    err = max(float((a[live] - b[live]).abs().max()) for a, b in ((hk, hr), (kk, kr), (vk, vr)))
    log(f"frame_step_batched as {kind} passes it, B {B} row {r} rows {rows} temp {temp}: "
        f"codes differing from plain {n_diff} of {2 * sk.numel()}, max |hidden/cache err| "
        f"{err:.3g}, equal to rows={S} bit for bit: {bound_exact}")
    if not bound_exact:
        raise AssertionError(f"frame_step_batched with rows={rows} differs from rows={S} "
                             f"({kind}, row {r})")
    if (temp == 0.0 and n_diff) or err > FRAME_TOL:
        raise AssertionError(f"frame_step_batched disagrees with plain as {kind} passes it, "
                             f"row {r}, temp {temp}: {n_diff} codes, err {err}")
    return n_diff


def check_frame_step_batched(dev) -> dict:
    """Kernel C vs frame_step_batched_reference at full width on the card."""
    import torch

    from magpie_tts_tpu_torch.config import MagpieConfig
    from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
    from magpie_tts_tpu_torch.models import magpie as magpie_mod
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb

    c = MagpieConfig()
    w = random_magpie_weights(c, seed=0).to(device=dev)
    rng = np.random.default_rng(1)
    E = 128
    Bmax = 32
    with torch.no_grad():
        tokens = torch.tensor(rng.integers(2, c.text_vocab_size - 2, size=(Bmax, 32)), device=dev)
        enc = [int(n) for n in rng.integers(8, 33, Bmax)]
        xa_k, xa_v, k_ctx, v_ctx, hidden = magpie_mod.prepare_batch(
            tokens, enc, [b % c.num_speakers for b in range(Bmax)], w, c)
    pad = (0, 0, 0, E - xa_k.shape[2])
    xa_k = torch.nn.functional.pad(xa_k, pad).contiguous()
    xa_v = torch.nn.functional.pad(xa_v, pad).contiguous()
    # Cache rows hold random K/V of the prefill's scale.
    scale = float(k_ctx[:, :, :c.context_frames].std())
    gen = torch.Generator(device=dev).manual_seed(2)
    k_base = torch.randn(k_ctx.shape, generator=gen, device=dev) * scale
    v_base = torch.randn(v_ctx.shape, generator=gen, device=dev) * scale
    del k_ctx, v_ctx

    def inputs(B, write_row):
        return dict(
            hidden=hidden[:B].contiguous(), write_row=write_row,
            valid=torch.tensor(_ring_valid(B, c.max_seq, write_row, rng), device=dev),
            may_continue=torch.tensor(rng.random(B) < 0.8, device=dev),
            posemb=w.decoder.pos_emb[torch.tensor(rng.integers(c.context_frames + 1, c.max_seq, B),
                                                   device=dev)],
            xa_k=xa_k[:B].contiguous(), xa_v=xa_v[:B].contiguous(),
            enc_lengths=torch.tensor(enc[:B], dtype=torch.int32, device=dev),
            seeds=torch.tensor(rng.integers(-2**31, 2**31, B), dtype=torch.int32, device=dev),
            forbid_eos=torch.tensor(rng.random(B) < 0.3, device=dev),
            weights=w, config=c, top_k=80)

    worst, flips = 0.0, 0
    with torch.no_grad():
        for B in (8, Bmax):
            for write_row in (5, c.max_seq // 2, c.max_seq - 10):
                for temp in (0.0, 0.7):
                    x = inputs(B, write_row)
                    kk, vk = k_base[:B].clone(), v_base[:B].clone()
                    kr, vr = k_base[:B].clone(), v_base[:B].clone()
                    sk, ak, hk, _, _ = fsb.frame_step_batched(k_cache=kk, v_cache=vk,
                                                              temperature=temp, **x)
                    sr, ar, hr, _, _ = fsb.frame_step_batched_reference(
                        k_cache=kr, v_cache=vr, temperature=temp, **x)
                    torch.cuda.synchronize()
                    n_diff = int((sk != sr).sum()) + int((ak != ar).sum())
                    live = slice(0, B - 1)   # the last slot has no valid row
                    err = max(float((hk[live] - hr[live]).abs().max()),
                              float((kk[live] - kr[live]).abs().max()),
                              float((vk[live] - vr[live]).abs().max()))
                    finite = all(bool(torch.isfinite(t).all()) for t in (hk, kk, vk))
                    log(f"frame_step_batched B {B} row {write_row} temp {temp}: codes "
                        f"differing {n_diff} of {2 * sk.numel()}, max |hidden/cache err| "
                        f"{err:.3g} (live slots), finite {finite}")
                    if temp == 0.0 and n_diff:
                        raise AssertionError(f"frame_step_batched codes differ at temp 0, "
                                             f"B {B}, row {write_row}")
                    flips += n_diff if temp > 0 else 0
                    if err > FRAME_TOL or not finite:
                        raise AssertionError(f"frame_step_batched disagrees at B {B}, row "
                                             f"{write_row}: {err} > {FRAME_TOL} or not finite")
                    worst = max(worst, err)
        log(f"frame_step_batched: differing codes at temp 0.7 over 6 cases: {flips}")
        for kind in ("continuous", "lockstep"):
            for write_row in ((200, c.max_seq - 24) if kind == "continuous"
                              else (c.context_frames + 1, 400)):
                for temp in (0.0, 0.7):
                    flips += check_engine_arguments(fsb, kind, inputs(SERVE_SLOTS, write_row),
                                                    k_base[:SERVE_SLOTS], v_base[:SERVE_SLOTS],
                                                    temp, w, c, dev)
        # Times at B=8 (and B=32), write row 300 (357M), temp 0.7.
        time_row = c.max_seq // 2 - 20
        times = {}
        for B in (8, Bmax):
            x = inputs(B, time_row)
            kk, vk = k_base[:B].clone(), v_base[:B].clone()
            times[B] = time_ms(lambda: fsb.frame_step_batched(k_cache=kk, v_cache=vk,
                                                              temperature=0.7, **x), reps=30)
        x = inputs(8, time_row)
        kk, vk = k_base[:8].clone(), v_base[:8].clone()
        plain_ms = time_ms(lambda: fsb.frame_step_batched_reference(
            k_cache=kk, v_cache=vk, temperature=0.7, **x), reps=3, warmup=1)
    log(f"frame_step_batched time at row {time_row}, temp 0.7: B=8 kernel {times[8]:.4f} ms "
        f"({times[8] / 8:.4f} ms per slot), plain {plain_ms:.4f} ms; B={Bmax} kernel "
        f"{times[Bmax]:.4f} ms ({times[Bmax] / Bmax:.4f} ms per slot)")
    return {"max_abs_err": worst, "ms": times[8], "plain_ms": plain_ms, "ms_b32": times[Bmax],
            "temp07_code_flips": flips}


def check_codec_conv(dev, frames: int = 32) -> dict:
    """Kernel B vs the plain HalfSnake + conv for every conv class of a decode
    of ``frames`` frames; times are summed over the 92 convs of that decode."""
    import torch

    from magpie_tts_tpu_torch.config import CodecConfig
    from magpie_tts_tpu_torch.io.codec_weights import random_codec_weights
    from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc

    cfg = CodecConfig()
    cw = random_codec_weights(cfg, seed=0).to(device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    # (name, T, w, b, alpha, dilation, residual?, multiplicity per decode)
    classes = [("pre", frames, cw.pre_conv_w, cw.pre_conv_b, None, 1, False, 1)]
    T = frames
    for s, (stage, rate) in enumerate(zip(cw.stages, cfg.up_sample_rates)):
        T *= rate
        for j, branch in enumerate(stage.resblocks):
            for blk, d in zip(branch, cfg.resblock_dilations):
                classes.append((f"s{s}.in.k{blk.in_conv_w.shape[0]}.d{d}", T, blk.in_conv_w,
                                blk.in_conv_b, blk.in_alpha, d, False, 1))
            blk = branch[0]
            classes.append((f"s{s}.sk.k{blk.sk_conv_w.shape[0]}.res", T, blk.sk_conv_w,
                            blk.sk_conv_b, blk.sk_alpha, 1, True, len(branch)))
    classes.append(("post", T, cw.post_conv_w, cw.post_conv_b, cw.post_alpha, 1, False, 1))
    if sum(m for *_, m in classes) != 92:
        raise AssertionError("conv classes do not add up to 92 convs per decode")

    worst, total_ms, total_plain = 0.0, 0.0, 0.0
    with torch.no_grad():
        for name, T, wt, b, alpha, d, res, mult in classes:
            k, c_in, c_out = wt.shape
            x = torch.randn(1, T, c_in, generator=gen, device=dev) * 0.5
            r = torch.randn(1, T, c_out, generator=gen, device=dev) * 0.5 if res else None
            got = cc.snake_causal_conv(x, wt, b, alpha, d, cfg.leaky_slope, residual=r)
            want = cc.snake_causal_conv_reference(x, wt, b, alpha, d, cfg.leaky_slope, r)
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=CONV_ATOL, rtol=CONV_RTOL):
                raise AssertionError(f"codec conv {name} ({c_in}->{c_out}, k{k}, d{d}, T{T}) "
                                     f"disagrees: max abs err {err}")
            t_k = time_ms(lambda: cc.snake_causal_conv(x, wt, b, alpha, d, 0.01, residual=r), 5)
            t_p = time_ms(lambda: cc.snake_causal_conv_reference(x, wt, b, alpha, d, 0.01, r), 5)
            log(f"codec_conv {name:18s} {c_in:4d}->{c_out:4d} k{k:2d} d{d} T{T:6d} "
                f"res={int(res)}: max abs err {err:.3g}, kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
            worst = max(worst, err)
            total_ms += t_k * mult
            total_plain += t_p * mult
    log(f"codec_conv: 92 convs of a {frames}-frame decode: kernel {total_ms:.4f} ms, "
        f"plain {total_plain:.4f} ms")
    return {"max_abs_err": worst, "ms": total_ms, "plain_ms": total_plain}


def write_ggufs(tmp: Path):
    """Production-width random GGUFs (max_dec_steps cut to 128 frames)."""
    from magpie_tts_tpu_torch.config import CodecConfig, MagpieConfig

    mcfg = dataclasses.replace(MagpieConfig(), max_dec_steps=128)
    ccfg = CodecConfig()
    t0 = time.perf_counter()
    write_model_gguf(str(tmp / "magpie.gguf"), mcfg, seed=0)
    write_codec_gguf(str(tmp / "codec.gguf"), ccfg, seed=1)
    log(f"wrote production-width GGUFs in {time.perf_counter() - t0:.1f} s")
    return mcfg, ccfg


def run_main_path(tmp: Path, mcfg, ccfg, card: str) -> dict:
    """cli.main at full width on random GGUFs; checks the WAV and launch counts."""
    from magpie_tts_tpu_torch import cli
    from magpie_tts_tpu_torch.io.wav import read_wav
    from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs

    hop = ccfg.hop_length
    out = tmp / "out.wav"
    argv = ["-m", str(tmp / "magpie.gguf"), "-c", str(tmp / "codec.gguf"),
            "-t", "hello world", "-o", str(out), "--device", "cuda",
            "--temp", "0.7", "--seed", "0"]
    err = io.StringIO()
    fs.launches = 0
    cc.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    frame_launches, conv_launches = fs.launches, cc.launches
    log(err.getvalue().rstrip())
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    samples, sr = read_wav(str(out))
    n_frames = len(samples) // hop
    if n_frames == 0 or len(samples) != n_frames * hop or sr != mcfg.sample_rate:
        raise AssertionError(f"bad WAV: {len(samples)} samples at {sr} Hz")
    if not np.all(np.isfinite(samples)) or float(np.std(samples)) == 0.0:
        raise AssertionError("WAV samples are not finite or are constant")
    # The loop runs one frame step per kept frame, plus the EOS frame when it
    # stopped before max_dec_steps.
    want_steps = n_frames + (1 if n_frames < mcfg.max_dec_steps else 0)
    if frame_launches != want_steps:
        raise AssertionError(f"frame_step launched {frame_launches}x for {want_steps} steps")
    if conv_launches != 92:
        raise AssertionError(f"codec conv launched {conv_launches}x, want 92 per decode")
    m = re.search(r"in ([0-9.]+)s \(([0-9.]+) fps", err.getvalue())
    synth_s, fps = (float(m.group(1)), float(m.group(2))) if m else (float("nan"),) * 2
    log(f"main path: {n_frames} frames, {len(samples)} samples, frame_step launches "
        f"{frame_launches}, conv launches {conv_launches}, synth {synth_s} s = {fps} fps "
        f"(cli.main wall {wall:.2f} s incl. load) on {card}")
    return {"frame_launches": frame_launches, "conv_launches": conv_launches,
            "n_frames": n_frames, "fps": fps}


SERVE_SLOTS, SERVE_SEGMENT = 8, 16  # serve's default slots
SERVE_TEXTS = ["hello world", "hello, world!", "world hello.", "abc def", "hello abc world",
               "def, hello"]


def run_serve(tmp: Path, mcfg, ccfg, card: str) -> dict:
    """cli.main serve at full width: six JSONL requests and a malformed line on
    a stdin stand-in; checks every result, the error line, the WAVs, and the
    batched kernel's and codec conv's launch counts."""
    from magpie_tts_tpu_torch import cli
    from magpie_tts_tpu_torch.io.wav import read_wav
    from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
    from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine

    hop = ccfg.hop_length
    lines = [json.dumps({"id": f"r{i}", "text": t, "seed": i})
             for i, t in enumerate(SERVE_TEXTS)]
    lines.insert(3, '{"id": "bad", "text": ')
    counts = {"segments": 0, "decode_batch": 0}

    def counted(fn, key):
        def wrapper(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapper

    argv = ["serve", "-m", str(tmp / "magpie.gguf"), "-c", str(tmp / "codec.gguf"),
            "--out-dir", str(tmp / "serve"), "--slots", str(SERVE_SLOTS),
            "--segment-frames", str(SERVE_SEGMENT), "--temp", "0.7", "--device", "cuda"]
    out, err = io.StringIO(), io.StringIO()
    seg_fn, dec_fn, stdin = ContinuousBatchingEngine._segment, CodecEngine.decode_batch, sys.stdin
    ContinuousBatchingEngine._segment = counted(seg_fn, "segments")
    CodecEngine.decode_batch = counted(dec_fn, "decode_batch")
    sys.stdin = io.StringIO("\n".join(lines) + "\n")
    try:
        fsb.launches = 0
        cc.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        batched_launches, conv_launches = fsb.launches, cc.launches
    finally:
        ContinuousBatchingEngine._segment, CodecEngine.decode_batch = seg_fn, dec_fn
        sys.stdin = stdin
    log(err.getvalue().rstrip())
    if rc != 0:
        raise AssertionError(f"cli.main serve returned {rc}")
    results = [json.loads(ln) for ln in out.getvalue().splitlines()]
    errors = [r for r in results if "error" in r]
    done = {r["id"]: r for r in results if "error" not in r}
    if len(errors) != 1 or sorted(done) != sorted(f"r{i}" for i in range(len(SERVE_TEXTS))):
        raise AssertionError(f"serve results: {results}")
    frames = 0
    for r in done.values():
        samples, sr = read_wav(r["wav"])
        if r["frames"] <= 0 or len(samples) != r["frames"] * hop or sr != mcfg.sample_rate:
            raise AssertionError(f"bad serve WAV for {r}: {len(samples)} samples at {sr} Hz")
        if not np.all(np.isfinite(samples)) or float(np.std(samples)) == 0.0:
            raise AssertionError(f"serve WAV of {r['id']} is not finite or is constant")
        frames += r["frames"]
    want = counts["segments"] * SERVE_SEGMENT
    if batched_launches == 0 or batched_launches != want:
        raise AssertionError(f"frame_step_batched launched {batched_launches}x for "
                             f"{counts['segments']} segments of {SERVE_SEGMENT}")
    if conv_launches == 0 or conv_launches != 92 * counts["decode_batch"]:
        raise AssertionError(f"codec conv launched {conv_launches}x for "
                             f"{counts['decode_batch']} decode_batch calls")
    m = re.search(r"in ([0-9.]+)s \(([0-9.]+) aggregate fps", err.getvalue())
    fps = float(m.group(2)) if m else float("nan")
    log(f"serve path: {len(done)} requests, {frames} frames, {counts['segments']} segments, "
        f"frame_step_batched launches {batched_launches}, conv launches {conv_launches} "
        f"({counts['decode_batch']} decode_batch calls), {fps} aggregate fps "
        f"(cli.main serve wall {wall:.2f} s incl. load) on {card}")
    return {"batched_launches": batched_launches, "conv_launches": conv_launches,
            "frames": frames, "fps": fps}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from magpie_tts_tpu_torch.ops.kernels import build
    from magpie_tts_tpu_torch.runtime.engine import resolve_device

    dev = resolve_device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.load_library()
    log(f"kernel library {build.library_path().name}: built in "
        f"{build.build_seconds if build.build_seconds is not None else 0.0:.1f} s "
        f"(load total {time.perf_counter() - t0:.1f} s)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    fs_res = check_frame_step(dev)
    fsb_res = check_frame_step_batched(dev)
    cc_res = check_codec_conv(dev)
    with tempfile.TemporaryDirectory() as tmp:
        mcfg, ccfg = write_ggufs(Path(tmp))
        main_res = run_main_path(Path(tmp), mcfg, ccfg, card)
        serve_res = run_serve(Path(tmp), mcfg, ccfg, card)

    log(f"summary: e2e {main_res['fps']} fps over {main_res['n_frames']} frames; serve "
        f"{serve_res['fps']} aggregate fps over {serve_res['frames']} frames; batched frame "
        f"B=32 {fsb_res['ms_b32']} ms; codec_conv also replaces "
        f"magpie_tts_tpu/ops/pallas_kernels/codec_conv.py:373 (snake_causal_conv_packed); "
        f"on {card}")
    log(json.dumps({"kernels": [
        {"name": "frame_step", "route": "cuda",
         "source": "magpie_tts_tpu_torch/csrc/frame_step.cu",
         "replaces": "magpie_tts_tpu/ops/pallas_kernels/frame_step.py:352",
         "launches": main_res["frame_launches"], "max_abs_err": fs_res["max_abs_err"],
         "ms": fs_res["ms"], "plain_ms": fs_res["plain_ms"]},
        {"name": "frame_step_batched", "route": "cuda",
         "source": "magpie_tts_tpu_torch/csrc/frame_step_batched.cu",
         "replaces": "magpie_tts_tpu/ops/pallas_kernels/frame_step_batched.py:591",
         "launches": serve_res["batched_launches"], "max_abs_err": fsb_res["max_abs_err"],
         "ms": fsb_res["ms"], "plain_ms": fsb_res["plain_ms"]},
        {"name": "codec_conv", "route": "cuda",
         "source": "magpie_tts_tpu_torch/csrc/codec_conv.cu",
         "replaces": "magpie_tts_tpu/ops/pallas_kernels/codec_conv.py:157",
         "launches": main_res["conv_launches"], "max_abs_err": cc_res["max_abs_err"],
         "ms": cc_res["ms"], "plain_ms": cc_res["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
