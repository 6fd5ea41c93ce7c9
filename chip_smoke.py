"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero):
1. the card (nvidia-smi name + power limit), torch / CUDA versions, and the
   build of the hand-written kernels from csrc/ (nvcc, sm_90a);
2. each kernel against its plain PyTorch version on the card at full 357M
   width: the frame step at several cache positions and temperatures, the
   batched frame step at B=8 and B=32 with ring-style masks and at serve's B
   with its arguments as the continuous and lockstep engines pass them
   (attention bound, broadcast rows), the codec conv for every (C_in, C_out,
   k, dilation, residual) class a decode runs, and the split path's four
   kernels (LT sampler and decoder step, single-stream and batched, the
   batched decoder step also with the engines' arguments); the split path
   also against the fused kernels on the same state; with both times, each
   kernel's bound and, where one PyTorch call computes the same function,
   that call's time;
3. the main path through the user entry point: production-width random
   GGUFs, ``magpie_tts_tpu_torch.cli.main`` with ``--device cuda``, the WAV
   checked, and the kernels' launch counts checked against the loop; then
   the same with ``--no-fused`` (the split kernels, none of the fused one);
4. the serve path on the same GGUFs: ``cli.main(["serve", ...])`` with JSONL
   requests on a stdin stand-in, every WAV checked, the batched kernel's
   launches checked against the segments run; then the same under
   ``MAGPIE_NO_FUSED=1`` (the split batched kernels, none of the fused one).

The line before last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import os
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

FRAME_TOL = 1e-4   # hidden / cache rows: GEMV summation order differs from torch.matmul
SPLIT_TOL = 1e-5   # the split kernels: against plain, and split against fused
CONV_ATOL = 1e-4   # conv outputs of O(1): summation order differs from F.conv1d
CONV_RTOL = 1e-5
# An H100 SXM's published peaks (NVIDIA's datasheet): device memory
# rate, and float32 outside the tensor cores (every kernel here is SIMT f32).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
F32 = 4


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


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for a function: the larger of the
    bytes it must move over the memory rate and its operations over the
    float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def lt_work(c, B: int):
    """(bytes, flops) of B slots' LT sampling: every LT weight and output head
    read once, each slot's hidden row and its 8 sampled embedding rows read,
    its codes written; the matrix products' flops (the 9-row attention and the
    sampling passes are small beside them)."""
    D, LT, LF, V, n = c.d_model, c.lt_dim, c.lt_ffn_dim, c.vocab_per_cb, c.num_codebooks
    weights = D * LT + LT + n * LT + 2 * LT + 4 * LT * LT + 2 * LT * LF + n * (LT * V + V)
    nbytes = F32 * (weights + B * (D + n * D)) + B * 2 * n * 4
    flops = B * n * 2 * (D * LT + 4 * LT * LT + 2 * LT * LF + LT * V)
    return nbytes, flops


def dec_work(c, kv_rows, enc_rows, input_rows: int = 2):
    """(bytes, flops) of one decoder step for slots attending kv_rows[b]
    existing cache rows and enc_rows[b] cross-attention rows: every decoder
    weight read once; per slot its rows of K and V, its cross-attention K/V
    rows and ``input_rows`` rows of input (the embedding and its posemb row)
    read, its new K/V rows and hidden written."""
    D, F, X, L = c.d_model, c.d_ffn, c.d_xa, c.dec_layers
    mats = 3 * D * D + D * D + D * X + X * D + 2 * D * F
    nbytes = F32 * (L * (mats + 3 * D) + D)
    flops = 0
    for r, e in zip(kv_rows, enc_rows):
        nbytes += F32 * (2 * L * r * D + 2 * L * e * X + input_rows * D + 2 * L * D + D)
        flops += 2 * L * mats + 4 * L * (r + 1) * D + 4 * L * e * X
    return nbytes, flops


@functools.lru_cache(maxsize=1)
def prod_weights(dev):
    """Random 357M weights (seed 0) on the card, made once for every phase."""
    from magpie_tts_tpu_torch.config import MagpieConfig
    from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights

    c = MagpieConfig()
    return c, random_magpie_weights(c, seed=0).to(device=dev)


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

SINGLE_ENC = 20


@functools.lru_cache(maxsize=1)
def single_state(dev):
    """One stream after prepare() at 357M width, and K/V caches whose rows
    past the speaker context hold random K/V of the prefill's scale."""
    import torch

    from magpie_tts_tpu_torch.models import magpie as magpie_mod

    c, w = prod_weights(dev)
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(2, c.text_vocab_size - 2, size=32), device=dev)
    with torch.no_grad():
        xa_k, xa_v, st = magpie_mod.prepare(tokens, SINGLE_ENC, 0, w, c)
    scale = float(st.k_cache[:, :c.context_frames].std())
    gen = torch.Generator(device=dev).manual_seed(0)
    filler = lambda: torch.randn(st.k_cache.shape, generator=gen, device=dev) * scale
    ctx = torch.arange(c.max_seq, device=dev)[None, :, None] < c.context_frames + 1
    k_base = torch.where(ctx, st.k_cache, filler())
    v_base = torch.where(ctx, st.v_cache, filler())
    # 111, 300 and 610 at 357M width: the first decode row, mid-cache, near full.
    positions = (c.context_frames + 1, c.max_seq // 2 - 20, c.max_seq - 30)
    return c, w, xa_k, xa_v, st.hidden, k_base, v_base, positions


def check_frame_step(dev) -> dict:
    """Kernel A vs frame_step_reference at full width on the card."""
    import torch

    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs

    c, w, xa_k, xa_v, hidden, k_base, v_base, positions = single_state(dev)
    enc_len = SINGLE_ENC
    worst, flips = 0.0, 0
    with torch.no_grad():
        for pos in positions:
            for temp in (0.0, 0.7):
                seed = 1000 + pos
                kk, vk = k_base.clone(), v_base.clone()
                kr, vr = k_base.clone(), v_base.clone()
                sk, ak, hk, _, _ = fs.frame_step(hidden, pos, xa_k, xa_v, kk, vk, w, c, seed,
                                                 temp, 80, False, enc_length=enc_len)
                sr, ar, hr, _, _ = fs.frame_step_reference(hidden, pos, xa_k, xa_v, kr, vr, w,
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
        args = (hidden, positions[1], xa_k, xa_v, k_base.clone(), v_base.clone(), w, c, 7, 0.7, 80,
                False)
        ms = time_ms(lambda: fs.frame_step(*args, enc_length=enc_len), reps=50)
        plain_ms = time_ms(lambda: fs.frame_step_reference(*args, enc_length=enc_len), reps=5)
    log(f"frame_step time at pos {positions[1]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    lt_b, lt_f = lt_work(c, 1)
    dec_b, dec_f = dec_work(c, [positions[1]], [enc_len], input_rows=1)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "temp07_code_flips": flips,
            **bound(lt_b + dec_b, lt_f + dec_f)}


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


BATCH_MAX, BATCH_ENC = 32, 128


@functools.lru_cache(maxsize=1)
def batched_state(dev):
    """BATCH_MAX prepared streams at 357M width (xa padded to BATCH_ENC rows)
    and K/V caches of random rows at the prefill's scale."""
    import torch

    from magpie_tts_tpu_torch.models import magpie as magpie_mod

    c, w = prod_weights(dev)
    rng = np.random.default_rng(1)
    Bmax, E = BATCH_MAX, BATCH_ENC
    with torch.no_grad():
        tokens = torch.tensor(rng.integers(2, c.text_vocab_size - 2, size=(Bmax, 32)), device=dev)
        enc = [int(n) for n in rng.integers(8, 33, Bmax)]
        xa_k, xa_v, k_ctx, v_ctx, hidden = magpie_mod.prepare_batch(
            tokens, enc, [b % c.num_speakers for b in range(Bmax)], w, c)
    pad = (0, 0, 0, E - xa_k.shape[2])
    xa_k = torch.nn.functional.pad(xa_k, pad).contiguous()
    xa_v = torch.nn.functional.pad(xa_v, pad).contiguous()
    scale = float(k_ctx[:, :, :c.context_frames].std())
    gen = torch.Generator(device=dev).manual_seed(2)
    k_base = torch.randn(k_ctx.shape, generator=gen, device=dev) * scale
    v_base = torch.randn(v_ctx.shape, generator=gen, device=dev) * scale
    return c, w, hidden, xa_k, xa_v, k_base, v_base, enc


def batched_inputs(dev, B: int, write_row: int, rng) -> dict:
    """Kernel C's arguments for B slots of batched_state: ring-style masks
    (the last slot empty), random may_continue / posemb rows / seeds /
    forbid_eos."""
    import torch

    c, w, hidden, xa_k, xa_v, _, _, enc = batched_state(dev)
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


def check_frame_step_batched(dev) -> dict:
    """Kernel C vs frame_step_batched_reference at full width on the card."""
    import torch

    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb

    c, w, _, _, _, k_base, v_base, enc = batched_state(dev)
    rng = np.random.default_rng(1)
    Bmax = BATCH_MAX
    inputs = lambda B, write_row: batched_inputs(dev, B, write_row, rng)

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
        times, timed = {}, {}
        for B in (8, Bmax):
            x = timed[B] = inputs(B, time_row)
            kk, vk = k_base[:B].clone(), v_base[:B].clone()
            times[B] = time_ms(lambda: fsb.frame_step_batched(k_cache=kk, v_cache=vk,
                                                              temperature=0.7, **x), reps=30)
        x = timed[8]
        kk, vk = k_base[:8].clone(), v_base[:8].clone()
        plain_ms = time_ms(lambda: fsb.frame_step_batched_reference(
            k_cache=kk, v_cache=vk, temperature=0.7, **x), reps=3, warmup=1)
    log(f"frame_step_batched time at row {time_row}, temp 0.7: B=8 kernel {times[8]:.4f} ms "
        f"({times[8] / 8:.4f} ms per slot), plain {plain_ms:.4f} ms; B={Bmax} kernel "
        f"{times[Bmax]:.4f} ms ({times[Bmax] / Bmax:.4f} ms per slot)")
    lt_b, lt_f = lt_work(c, 8)
    dec_b, dec_f = dec_work(c, x["valid"].sum(-1).tolist(), x["enc_lengths"].tolist(),
                            input_rows=1)
    return {"max_abs_err": worst, "ms": times[8], "plain_ms": plain_ms, "ms_b32": times[Bmax],
            "temp07_code_flips": flips, **bound(lt_b + dec_b, lt_f + dec_f)}


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

    worst, total_ms, total_plain, total_lib, nbytes, flops = 0.0, 0.0, 0.0, 0.0, 0, 0
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
            # The library yardstick: one cuDNN conv1d (float32, TF32 off) of the
            # same shapes; it leaves out the HalfSnake and the residual add.
            x_nct, w_oik = x.transpose(1, 2).contiguous(), wt.permute(2, 1, 0).contiguous()
            t_l = time_ms(lambda: torch.nn.functional.conv1d(x_nct, w_oik, b, dilation=d,
                                                             padding=(k - 1) * d), 5)
            log(f"codec_conv {name:18s} {c_in:4d}->{c_out:4d} k{k:2d} d{d} T{T:6d} "
                f"res={int(res)}: max abs err {err:.3g}, kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                f"conv1d {t_l:.4f} ms")
            worst = max(worst, err)
            total_ms += t_k * mult
            total_plain += t_p * mult
            total_lib += t_l * mult
            n_alpha = 0 if alpha is None else alpha.numel()
            nbytes += mult * F32 * (T * c_in + k * c_in * c_out + c_out + n_alpha
                                    + T * c_out * (2 if res else 1))
            flops += mult * 2 * T * k * c_in * c_out
    log(f"codec_conv: 92 convs of a {frames}-frame decode: kernel {total_ms:.4f} ms, "
        f"plain {total_plain:.4f} ms, conv1d {total_lib:.4f} ms")
    return {"max_abs_err": worst, "ms": total_ms, "plain_ms": total_plain,
            "library_ms": total_lib, **bound(nbytes, flops)}


def _eos(sampled, argmax, c):
    return ((sampled == c.audio_eos_id) | (argmax == c.audio_eos_id)).any(-1)


def _max_err(pairs, live=slice(None)) -> float:
    return max(float((a[live] - b[live]).abs().max()) for a, b in pairs)


def check_split_single(dev) -> dict:
    """Kernels 4 (LT sampler) and 5 (decoder step) against their plain
    versions at full width, and the split frame (kernel 4, the embedding,
    kernel 5) against kernel A on the same state: codes exact, floats within
    SPLIT_TOL, at positions 111 / 300 / 610 and temperatures 0 / 0.7."""
    import torch

    from magpie_tts_tpu_torch.models.magpie import audio_frame_embedding
    from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts

    c, w, xa_k, xa_v, hidden, k_base, v_base, positions = single_state(dev)
    enc_len = SINGLE_ENC
    err_dec, err_fused = 0.0, 0.0
    with torch.no_grad():
        for pos in positions:
            for temp in (0.0, 0.7):
                seed, forbid = 2000 + pos, pos == positions[0]
                sk, ak = lts.sample_frame_codes(hidden, w, c, seed, temp, 80, forbid)
                sr, ar = lts.sample_frame_codes_reference(hidden, w, c, seed, temp, 80, forbid)
                emb = audio_frame_embedding(sk, w, c)
                (kk, vk), (kr, vr), (kf, vf) = [(k_base.clone(), v_base.clone()) for _ in range(3)]
                hk = ds.decode_step(emb, pos, xa_k, xa_v, kk, vk, w, c, enc_length=enc_len)
                hr = ds.decode_step_reference(emb, pos, xa_k, xa_v, kr, vr, w, c,
                                              enc_length=enc_len)
                sf, af, hf, _, _ = fs.frame_step(hidden, pos, xa_k, xa_v, kf, vf, w, c, seed, temp,
                                                 80, forbid, enc_length=enc_len)
                torch.cuda.synchronize()
                n_plain = int((sk != sr).sum()) + int((ak != ar).sum())
                n_fused = int((sk != sf).sum()) + int((ak != af).sum())
                e_plain = _max_err(((hk, hr), (kk, kr), (vk, vr)))
                e_fused = _max_err(((hk, hf), (kk, kf), (vk, vf)))
                log(f"split pos {pos} temp {temp}: lt_sampler codes differing from plain "
                    f"{n_plain}, from frame_step {n_fused}; decoder_step max |hidden/cache err| "
                    f"{e_plain:.3g} vs plain, {e_fused:.3g} (split frame) vs frame_step")
                if n_plain or n_fused or e_plain > SPLIT_TOL or e_fused > SPLIT_TOL:
                    raise AssertionError(f"split path disagrees at pos {pos}, temp {temp}")
                err_dec, err_fused = max(err_dec, e_plain), max(err_fused, e_fused)
        pos = positions[1]
        k_t, v_t = k_base.clone(), v_base.clone()
        lt_args = (hidden, w, c, 7, 0.7, 80, False)
        dec_args = (emb, pos, xa_k, xa_v, k_t, v_t, w, c)
        times = {
            "lt": time_ms(lambda: lts.sample_frame_codes(*lt_args), reps=50),
            "lt_plain": time_ms(lambda: lts.sample_frame_codes_reference(*lt_args), reps=5),
            "dec": time_ms(lambda: ds.decode_step(*dec_args, enc_length=enc_len), reps=50),
            "dec_plain": time_ms(lambda: ds.decode_step_reference(*dec_args, enc_length=enc_len),
                                 reps=5)}
    log(f"split times (temp 0.7; decoder step at pos {pos}): lt_sampler {times['lt']:.4f} ms, "
        f"plain {times['lt_plain']:.4f} ms; decoder_step {times['dec']:.4f} ms, plain "
        f"{times['dec_plain']:.4f} ms; max |split frame - frame_step| {err_fused:.3g}")
    return {"lt": {"max_abs_err": 0.0, "ms": times["lt"], "plain_ms": times["lt_plain"],
                   **bound(*lt_work(c, 1))},
            "dec": {"max_abs_err": err_dec, "ms": times["dec"], "plain_ms": times["dec_plain"],
                    **bound(*dec_work(c, [pos], [enc_len]))},
            "split_vs_fused_err": err_fused}


def check_split_engine_arguments(kind: str, x: dict, k_base, v_base, dev) -> float:
    """Kernel 8 with its arguments as an engine passes them, against the
    plain version and against itself with the attention bound at max_seq
    (bit for bit). ``continuous``: rows behind ring row r plus row r as the
    segment writes it before the step, ``rows`` the end of the segment;
    ``lockstep``: one broadcast row ``arange(S) <= pos`` (stride 0), ``rows =
    pos + 1``. Returns the largest difference from plain."""
    import torch

    from magpie_tts_tpu_torch.models.magpie import audio_frame_embedding
    from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb

    w, c = x["weights"], x["config"]
    B, S, r = x["hidden"].shape[0], c.max_seq, x["write_row"]
    sampled, argmax = ltsb.sample_frame_codes_batched(x["hidden"], w, c, x["seeds"], 0.7, 80,
                                                      x["forbid_eos"])
    x_pe = audio_frame_embedding(sampled, w, c)
    if kind == "continuous":
        rows, live = min(S, r + SERVE_SEGMENT), slice(0, B - 1)
        valid = np.zeros((B, S), bool)
        for b in range(B - 1):
            valid[b, r - 1 - b * (r // B):r] = True
        valid = torch.tensor(valid, device=dev)
        valid[:, r] = x["may_continue"] & ~_eos(sampled, argmax, c)
        x_pe = x_pe + x["posemb"]
    else:
        rows, live = r + 1, slice(0, B)
        valid = (torch.arange(S, device=dev) <= r)[None].expand(B, -1)
        x_pe = x_pe + w.decoder.pos_emb[r][None].expand(B, -1)
    (kk, vk), (kf, vf), (kr, vr) = [(k_base.clone(), v_base.clone()) for _ in range(3)]
    step = (x_pe, r, valid, x["xa_k"], x["xa_v"])
    hk = dsb.decode_step_batched(*step, kk, vk, w, c, x["enc_lengths"], rows=rows)
    hf = dsb.decode_step_batched(*step, kf, vf, w, c, x["enc_lengths"], rows=S)
    hr = dsb.decode_step_batched_reference(*step, kr, vr, w, c, x["enc_lengths"], rows=rows)
    torch.cuda.synchronize()
    bound_exact = all(torch.equal(a[live], b[live]) for a, b in ((hk, hf), (kk, kf), (vk, vf)))
    err = _max_err(((hk, hr), (kk, kr), (vk, vr)), live)
    log(f"decoder_step_batched as {kind} passes it, B {B} row {r} rows {rows}: max "
        f"|hidden/cache err| {err:.3g}, equal to rows={S} bit for bit: {bound_exact}")
    if not bound_exact or err > SPLIT_TOL:
        raise AssertionError(f"decoder_step_batched as {kind} passes it, row {r}: bound exact "
                             f"{bound_exact}, err {err}")
    return err


def check_split_batched(dev) -> dict:
    """Kernels 7 (batched LT sampler) and 8 (batched decoder step) against
    their plain versions at full width, B = 8 and 32 with ring masks (the
    last slot empty), write rows 111 / 300 / 610, temperatures 0 / 0.7; the
    split frame (kernel 7, the embedding + posemb, kernel 8 with the write
    row valid as kernel C decides it) against kernel C on the same state;
    kernel 8 also with the engines' arguments."""
    import torch

    from magpie_tts_tpu_torch.models.magpie import audio_frame_embedding
    from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb

    c, w, _, _, _, k_base, v_base, _ = batched_state(dev)
    rng = np.random.default_rng(3)
    rows_of = (c.context_frames + 1, c.max_seq // 2 - 20, c.max_seq - 30)
    err_dec, err_fused = 0.0, 0.0

    def split_frame(x, temp, caches):
        (kk, vk), (kr, vr) = caches
        sample = (x["hidden"], w, c, x["seeds"], temp, 80, x["forbid_eos"])
        sk, ak = ltsb.sample_frame_codes_batched(*sample)
        sr, ar = ltsb.sample_frame_codes_batched_reference(*sample)
        r = x["write_row"]
        valid = x["valid"].clone()
        valid[:, r] = x["may_continue"] & ~_eos(sk, ak, c)
        step = (audio_frame_embedding(sk, w, c) + x["posemb"], r, valid, x["xa_k"], x["xa_v"])
        hk = dsb.decode_step_batched(*step, kk, vk, w, c, x["enc_lengths"])
        hr = dsb.decode_step_batched_reference(*step, kr, vr, w, c, x["enc_lengths"])
        return (sk, ak, hk), (sr, ar, hr), step

    with torch.no_grad():
        for B in (8, BATCH_MAX):
            for r in rows_of:
                for temp in (0.0, 0.7):
                    x = batched_inputs(dev, B, r, rng)
                    (kk, vk), (kr, vr), (kf, vf) = [(k_base[:B].clone(), v_base[:B].clone())
                                                    for _ in range(3)]
                    (sk, ak, hk), (sr, ar, hr), _ = split_frame(x, temp, ((kk, vk), (kr, vr)))
                    sf, af, hf, _, _ = fsb.frame_step_batched(k_cache=kf, v_cache=vf,
                                                              temperature=temp, **x)
                    torch.cuda.synchronize()
                    live = slice(0, B - 1)   # the last slot has no valid row
                    n_plain = int((sk != sr).sum()) + int((ak != ar).sum())
                    n_fused = int((sk != sf).sum()) + int((ak != af).sum())
                    e_plain = _max_err(((hk, hr), (kk, kr), (vk, vr)), live)
                    e_fused = _max_err(((hk, hf), (kk, kf), (vk, vf)), live)
                    finite = all(bool(torch.isfinite(t).all()) for t in (hk, kk, vk))
                    log(f"split batched B {B} row {r} temp {temp}: lt_sampler_batched codes "
                        f"differing from plain {n_plain}, from frame_step_batched {n_fused} of "
                        f"{2 * sk.numel()}; decoder_step_batched max |hidden/cache err| "
                        f"{e_plain:.3g} vs plain, {e_fused:.3g} (split frame) vs "
                        f"frame_step_batched (live slots), finite {finite}")
                    if (n_plain or n_fused or e_plain > SPLIT_TOL or e_fused > SPLIT_TOL
                            or not finite):
                        raise AssertionError(f"split batched path disagrees at B {B}, row {r}, "
                                             f"temp {temp}")
                    err_dec, err_fused = max(err_dec, e_plain), max(err_fused, e_fused)
        for kind, rows in (("continuous", (200, c.max_seq - 24)),
                           ("lockstep", (c.context_frames + 1, 400))):
            for r in rows:
                err_dec = max(err_dec, check_split_engine_arguments(
                    kind, batched_inputs(dev, SERVE_SLOTS, r, rng), k_base[:SERVE_SLOTS],
                    v_base[:SERVE_SLOTS], dev))
        # Times at B=8 (and B=32), write row 300, temp 0.7.
        times = {}
        for B in (8, BATCH_MAX):
            x = batched_inputs(dev, B, rows_of[1], rng)
            kk, vk = k_base[:B].clone(), v_base[:B].clone()
            sample = (x["hidden"], w, c, x["seeds"], 0.7, 80, x["forbid_eos"])
            _, _, step = split_frame(x, 0.7, ((kk, vk), (kk.clone(), vk.clone())))
            times[B] = {
                "lt": time_ms(lambda: ltsb.sample_frame_codes_batched(*sample), reps=30),
                "dec": time_ms(lambda: dsb.decode_step_batched(*step, kk, vk, w, c,
                                                               x["enc_lengths"]), reps=30)}
            if B == 8:
                timed = x
                times[B]["lt_plain"] = time_ms(
                    lambda: ltsb.sample_frame_codes_batched_reference(*sample), reps=3, warmup=1)
                times[B]["dec_plain"] = time_ms(
                    lambda: dsb.decode_step_batched_reference(*step, kk, vk, w, c,
                                                              x["enc_lengths"]), reps=3, warmup=1)
    t8, t32 = times[8], times[BATCH_MAX]
    log(f"split batched times at row {rows_of[1]}, temp 0.7: B=8 lt_sampler_batched "
        f"{t8['lt']:.4f} ms (plain {t8['lt_plain']:.4f}), decoder_step_batched {t8['dec']:.4f} ms "
        f"(plain {t8['dec_plain']:.4f}); B={BATCH_MAX} {t32['lt']:.4f} / {t32['dec']:.4f} ms; "
        f"max |split frame - frame_step_batched| {err_fused:.3g}")
    valid_rows = timed["valid"].sum(-1).tolist()
    dec_b, dec_f = dec_work(c, valid_rows, timed["enc_lengths"].tolist(), input_rows=1)
    return {"lt": {"max_abs_err": 0.0, "ms": t8["lt"], "plain_ms": t8["lt_plain"],
                   "ms_b32": t32["lt"], **bound(*lt_work(c, 8))},
            "dec": {"max_abs_err": err_dec, "ms": t8["dec"], "plain_ms": t8["dec_plain"],
                    "ms_b32": t32["dec"], **bound(dec_b + 8 * c.max_seq, dec_f)},
            "split_vs_fused_err": err_fused}


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


def run_main_path(tmp: Path, mcfg, ccfg, card: str, split: bool = False) -> dict:
    """cli.main at full width on random GGUFs; checks the WAV and launch
    counts: kernel A once per loop step, or with ``split`` (``--no-fused``)
    kernels 4 and 5 once per step and kernel A never."""
    from magpie_tts_tpu_torch import cli
    from magpie_tts_tpu_torch.io.wav import read_wav
    from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
    from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts

    hop = ccfg.hop_length
    out = tmp / ("out_split.wav" if split else "out.wav")
    argv = ["-m", str(tmp / "magpie.gguf"), "-c", str(tmp / "codec.gguf"),
            "-t", "hello world", "-o", str(out), "--device", "cuda",
            "--temp", "0.7", "--seed", "0"] + (["--no-fused"] if split else [])
    err = io.StringIO()
    kernels = (fs, lts, ds, cc)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    frame_launches, lt_launches, dec_launches, conv_launches = (k.launches for k in kernels)
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
    want = (0, want_steps, want_steps) if split else (want_steps, 0, 0)
    if (frame_launches, lt_launches, dec_launches) != want:
        raise AssertionError(f"frame_step / lt_sampler / decoder_step launched {frame_launches} "
                             f"/ {lt_launches} / {dec_launches}x for {want_steps} steps "
                             f"(split {split})")
    if conv_launches != 92:
        raise AssertionError(f"codec conv launched {conv_launches}x, want 92 per decode")
    m = re.search(r"in ([0-9.]+)s \(([0-9.]+) fps", err.getvalue())
    synth_s, fps = (float(m.group(1)), float(m.group(2))) if m else (float("nan"),) * 2
    log(f"main path{' --no-fused' if split else ''}: {n_frames} frames, {len(samples)} samples, "
        f"frame_step / lt_sampler / decoder_step launches {frame_launches} / {lt_launches} / "
        f"{dec_launches}, conv launches {conv_launches}, synth {synth_s} s = {fps} fps "
        f"(cli.main wall {wall:.2f} s incl. load) on {card}")
    return {"frame_launches": frame_launches, "lt_launches": lt_launches,
            "dec_launches": dec_launches, "conv_launches": conv_launches, "n_frames": n_frames,
            "fps": fps}


SERVE_SLOTS, SERVE_SEGMENT = 8, 16  # serve's default slots
SERVE_TEXTS = ["hello world", "hello, world!", "world hello.", "abc def", "hello abc world",
               "def, hello"]


def run_serve(tmp: Path, mcfg, ccfg, card: str, split: bool = False) -> dict:
    """cli.main serve at full width: six JSONL requests and a malformed line on
    a stdin stand-in; checks every result, the error line, the WAVs, and the
    launch counts: kernel C once per segment frame, or with ``split``
    (``MAGPIE_NO_FUSED=1``) kernels 7 and 8 once per segment frame and kernel
    C never; codec conv 92 per ``decode_batch``."""
    from magpie_tts_tpu_torch import cli
    from magpie_tts_tpu_torch.io.wav import read_wav
    from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
    from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
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

    out_dir = tmp / ("serve_split" if split else "serve")
    argv = ["serve", "-m", str(tmp / "magpie.gguf"), "-c", str(tmp / "codec.gguf"),
            "--out-dir", str(out_dir), "--slots", str(SERVE_SLOTS),
            "--segment-frames", str(SERVE_SEGMENT), "--temp", "0.7", "--device", "cuda"]
    out, err = io.StringIO(), io.StringIO()
    seg_fn, dec_fn, stdin = ContinuousBatchingEngine._segment, CodecEngine.decode_batch, sys.stdin
    ContinuousBatchingEngine._segment = counted(seg_fn, "segments")
    CodecEngine.decode_batch = counted(dec_fn, "decode_batch")
    sys.stdin = io.StringIO("\n".join(lines) + "\n")
    kernels = (fsb, ltsb, dsb, cc)
    if split:
        os.environ["MAGPIE_NO_FUSED"] = "1"
    try:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        batched_launches, lt_launches, dec_launches, conv_launches = (k.launches for k in kernels)
    finally:
        ContinuousBatchingEngine._segment, CodecEngine.decode_batch = seg_fn, dec_fn
        sys.stdin = stdin
        os.environ.pop("MAGPIE_NO_FUSED", None)
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
    seg_frames = counts["segments"] * SERVE_SEGMENT
    want = (0, seg_frames, seg_frames) if split else (seg_frames, 0, 0)
    if seg_frames == 0 or (batched_launches, lt_launches, dec_launches) != want:
        raise AssertionError(f"frame_step_batched / lt_sampler_batched / decoder_step_batched "
                             f"launched {batched_launches} / {lt_launches} / {dec_launches}x for "
                             f"{counts['segments']} segments of {SERVE_SEGMENT} (split {split})")
    if conv_launches == 0 or conv_launches != 92 * counts["decode_batch"]:
        raise AssertionError(f"codec conv launched {conv_launches}x for "
                             f"{counts['decode_batch']} decode_batch calls")
    m = re.search(r"in ([0-9.]+)s \(([0-9.]+) aggregate fps", err.getvalue())
    fps = float(m.group(2)) if m else float("nan")
    log(f"serve path{' MAGPIE_NO_FUSED=1' if split else ''}: {len(done)} requests, {frames} "
        f"frames, {counts['segments']} segments, frame_step_batched / lt_sampler_batched / "
        f"decoder_step_batched launches {batched_launches} / {lt_launches} / {dec_launches}, "
        f"conv launches {conv_launches} ({counts['decode_batch']} decode_batch calls), {fps} "
        f"aggregate fps (cli.main serve wall {wall:.2f} s incl. load) on {card}")
    return {"batched_launches": batched_launches, "lt_launches": lt_launches,
            "dec_launches": dec_launches, "conv_launches": conv_launches, "frames": frames,
            "fps": fps}


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
    split_res = check_split_single(dev)
    splitb_res = check_split_batched(dev)
    with tempfile.TemporaryDirectory() as tmp:
        mcfg, ccfg = write_ggufs(Path(tmp))
        main_res = run_main_path(Path(tmp), mcfg, ccfg, card)
        split_main = run_main_path(Path(tmp), mcfg, ccfg, card, split=True)
        serve_res = run_serve(Path(tmp), mcfg, ccfg, card)
        split_serve = run_serve(Path(tmp), mcfg, ccfg, card, split=True)

    log(f"summary: e2e {main_res['fps']} fps over {main_res['n_frames']} frames, --no-fused "
        f"{split_main['fps']} fps over {split_main['n_frames']} frames; serve {serve_res['fps']} "
        f"aggregate fps over {serve_res['frames']} frames, MAGPIE_NO_FUSED=1 {split_serve['fps']} "
        f"over {split_serve['frames']}; batched frame B=32 {fsb_res['ms_b32']} ms; split B=32 "
        f"{splitb_res['lt']['ms_b32']} + {splitb_res['dec']['ms_b32']} ms; split frame vs fused "
        f"max err {split_res['split_vs_fused_err']} / {splitb_res['split_vs_fused_err']} "
        f"(B=8/32); codec_conv also replaces "
        f"magpie_tts_tpu/ops/pallas_kernels/codec_conv.py:373 (snake_causal_conv_packed); "
        f"on {card}")
    pk = "magpie_tts_tpu/ops/pallas_kernels/"
    src = "magpie_tts_tpu_torch/csrc/"

    def entry(name, source, replaces, launches, res):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": pk + replaces,
                "launches": launches, "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": res.get("library_ms")}

    log(json.dumps({"kernels": [
        entry("frame_step", "frame_step.cu", "frame_step.py:352", main_res["frame_launches"],
              fs_res),
        entry("frame_step_batched", "frame_step_batched.cu", "frame_step_batched.py:591",
              serve_res["batched_launches"], fsb_res),
        entry("codec_conv", "codec_conv.cu", "codec_conv.py:157", main_res["conv_launches"],
              cc_res),
        entry("lt_sampler", "frame_step.cu", "lt_sampler.py:174", split_main["lt_launches"],
              split_res["lt"]),
        entry("decoder_step", "frame_step.cu", "decoder_step.py:212",
              split_main["dec_launches"], split_res["dec"]),
        entry("lt_sampler_batched", "frame_step_batched.cu", "lt_sampler_batched.py:259",
              split_serve["lt_launches"], splitb_res["lt"]),
        entry("decoder_step_batched", "frame_step_batched.cu", "decoder_step_batched.py:280",
              split_serve["dec_launches"], splitb_res["dec"]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
