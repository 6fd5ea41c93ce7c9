"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero):
1. the card (nvidia-smi name + power limit), torch / CUDA versions, and the
   build of the hand-written kernels from csrc/ (nvcc, sm_90a), with the
   codec kernels' -Xptxas -v lines (registers, shared memory, spills);
2. each kernel against its plain PyTorch version on the card at full 357M
   width: the frame step at several cache positions and temperatures, the
   batched frame step at B=8 and B=32 with ring-style masks and at serve's B
   with its arguments as the continuous and lockstep engines pass them
   (attention bound, broadcast rows), the codec conv for every (C_in, C_out,
   k, dilation, residual) class a decode runs (each class timed by CUDA-graph
   slope beside one cuDNN conv1d of its shapes, in turns, and summed over
   the 92 convs of a 32-frame decode), and the split path's four
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
   launches checked against the segments run (one a slot group of at most 64
   a frame); then the same under ``MAGPIE_NO_FUSED=1`` (the split batched
   kernels, none of the fused one, no plain version);
5. quantized weight serving: kernels A, 5, C and 8 with the Q8_0 stream bit
   for bit against the same kernel dense on the dequantized weights, and with
   the Q8_0 and int8 streams against their plain versions; kernel 10 (the
   Q8_0 dequant) bit for bit against its plain version and the dense load
   for every block-stored tensor of a production-width Q8_0 GGUF; then
   ``cli.main`` with ``--serve-q8`` on that file, fused and ``--no-fused``
   (the WAV at temp 0 byte-identical to serving the file without the flag),
   and with ``--serve-int8`` on the float32 file, fused and ``--no-fused``;
   and ``synthesize_codes_batched_program`` with each stream, fused and split
   (kernels C and 8 in stream mode; their only caller);
6. bfloat16: kernels A, 4, 5, C, 7 and 8 (dense and both streams), B and 10
   in bf16 against their plain versions at 357M (codes equal or near-ties,
   floats in scaled bf16 ulps, ULP_SHARE / ULP_MAX; the Q8_0 stream bit for
   bit against dense on the weights dequantized in bf16, kernel 10 bit for
   bit); then ``cli.main`` synth with ``--dtype bfloat16`` fused,
   ``--no-fused``, ``--serve-int8`` and ``--serve-q8`` (its WAV at temp 0
   byte-identical to the file dequantized in bf16), ``cli.main serve`` at
   its bfloat16 default fused and under ``MAGPIE_NO_FUSED=1``, and the
   batched program with each stream in bf16, every launch checked to be a
   bfloat16 one (the wrappers' ``dtype_launches``). The float32 paths of
   phases 3-5 run after them, as before;
7. kernel 9 (the fused codec res layer) against its plain version on the
   three layers of <= 128 channels of a 32-frame decode, N = 1 and 3, with
   its time beside kernel B's 54 launches on the same layers (CUDA-graph
   slopes, in turns), in float32 and bf16; the wall time (host clock) and
   device time (profiler) of one 32-frame ``CodecEngine.decode`` in each
   dtype; then, in bf16 and float32, ``cli.main`` synth at temp 0 with and
   without ``MAGPIE_FUSED_CODEC=1`` (3 kernel-9 and 38 conv launches per
   decode, codes identical, the waveform difference), ``cli.main --stream``
   on each (time to first audio, real-time factor, the WAV byte-identical to
   the offline synth's), ``cli.main serve`` at bf16 with the switch
   (``decode_batch`` with N > 1), and ``cli.main warmup --surfaces all``.

8. the H100 probes (kernels 11-18, ``magpie_tts_tpu_torch/scripts/``): the
   int4 / packed-int8 / bf16 GEMV, the five attends and the copy kernels
   against their plain versions at the probe shapes (bit-equal for the
   nibble GEMVs and the copies with their checksums, the 764 of the chained
   bf16 add included; within PROBE_GEMV_REL / PROBE_ATTEND_REL of the
   largest value elsewhere); then the probe path: every probe module's
   functions at the reduced counts PROBE_* (CUDA-graph and eager slopes, the
   L2-resident and HBM figures, the plain versions and the library calls),
   the port's frame kernels A, C, 7 + 8, 8, 7 and the q8 streams among them
   as short graph slopes, each probe wrapper's launches counted over it.

9. the frame families of kernels C and 8 (after phase 6): slots 0..2 of C
   and 8 bit-equal at B = 3, 8 and 32 in both dtypes; the split-row
   attention (self, cross and the LT's) and the tensor-core GEMM (every
   product class over its layers) by CUDA-graph slope at B = 8 / 32, rows
   300 / 630, both dtypes, beside SDPA on the same caches and cuBLAS
   ``torch.matmul`` on the same weights (timed only), with their bounds;
   rows 6 and 8 of the kernels line carry them as ``families``.

10. the persistent frame kernels A and 5 (one cooperative launch a frame,
   after phase 6): each by CUDA-graph slope at B = 1, row 300, dense, in
   both dtypes, in turns with its library composite (cuBLAS ``torch.matmul``
   on the frame's products, SDPA on its attentions; timed only), the barrier
   probe's us a grid barrier at one and two blocks an SM, and their
   -Xptxas -v lines ("ptxas, persistent"); the float32 synth and
   ``--no-fused`` main paths are traced by torch.profiler and their device
   kernels counted: the persistent kernel once a step and nothing of the
   launch sequence A and 5 ran before.

11. admission (after the fused-codec serve): ``prepare_batch`` at M = 1, 2,
   4, 8 and 32 requests and token buckets 32 and 128, in both dtypes, in
   turns against M calls of ``prepare`` (host ms a group and a request),
   every row held against its request alone (ADMIT_REL, ADMIT_ULP_*); the
   serve runs of phases 4 and 6 check one ``PrepareGraphs`` call (the
   engine's ``prepare_batch`` as CUDA graphs) per (bucket, power-of-two
   chunk) group of each admission.

12. the oracle and the acceptance tooling (last, on the same GGUFs): the
   native GGUF reader bit-equal to the numpy reader on the float32 and Q8_0
   files (dense, dequantized at load, block-stored), with each load's
   seconds; ``tools.dump_golden`` on cuda against a CPU dump of the same file
   (max abs by dump prefix; codes equal, floats within verify_golden's
   tolerances or DUMP_REL of each dump's largest value); ``tools.acceptance --device cuda`` PASS on the
   float32 file against that CPU tree's model dumps (kernel A's launches in stage 3 against the frames decoded,
   kernel B's 92 in stage 5) and on the Q8_0 file (stage 3b: kernel 10 and
   A's Q8_0 stream reproduce the dequantize-at-load codes); the standard
   path on cuda at temperature 0 against the cached engine for 8 frames
   (equal, or near-ties only by ``codes_agree``); the phase's wall seconds.

13. whole loops and the device list (last): ``scripts.parity_decode``'s arms
   at 357M over 3 texts x 300 forced frames at temp 0 in float32 and bf16
   (kernel A against kernels 4 + 5 on every text, the plain loop on the CPU
   on text 0; float32 also at temp 0.7, A against 4 + 5), exact in float32
   between the card's arms and near-ties only elsewhere;
   ``scripts.parity_batched``'s at B = 32 x 100 frames (kernel C against
   7 + 8, the plain lockstep loop on the CPU at BATCHED_PLAIN_B slots);
   ``probe_lockstep``'s host slopes of the fused and split lockstep loops
   (bf16, B = 32, 100 / 400 frames) beside kernel C's graph slope (the host
   glue's share of a lockstep frame);
   ``BatchedMagpieEngine`` over a mesh of every card present and over
   ``["cuda:0", "cuda:0"]`` against the unmeshed engine at temp 0 and 0.7.
   Each arm's launch counters are reset before it and checked after it; the
   kernels line's rows of A, 4, 5, C, 7 and 8 carry the phase's launches as
   ``whole_loop_launches``.

14. more than 64 slots (kernels C, 7 and 8 run a frame as slot groups of at
   most 64, one launch each): at 357M in both dtypes, B = 65 against the
   plain versions, B = 96 and 128 bit-equal to the same slots in launches of
   GROUP_SPLIT, kernel C's graph slope a frame at B = 64 / 96 / 128; then
   ``cli.main serve --slots 96`` with 96 requests, fused and under
   ``MAGPIE_NO_FUSED=1``, bf16 and float32 (launches = groups x frames), and
   ``BatchedMagpieEngine(batch_size=128)`` at temp 0 against two batches of
   64, with ``decode_batch`` of its 128 results. The C / 7 / 8 rows of the
   kernels line carry it as ``slot_groups``.

The line before last is a JSON summary of the kernels (float32 rows, then
the ``[bf16]`` rows, then the weight streams, then the probe rows with
``"path": "probe"``; kernel 9's rows also carry ``kernel_b_ms``, kernel B's
time on the same layers); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import os
import json
import re
import shutil
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
# rate, float32 outside the tensor cores (the frame kernels' SIMT float32;
# the bound of a float32 function), dense bf16 and TF32 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12   # dense bf16 on the tensor cores: the rate for bf16 inputs
TF32_FLOPS_PER_S = 495e12   # the codec convs' float32 runs 3 TF32 products per product
CODEC_SLOPE_N = (2, 8, 3)   # codec graph slopes: launches per graph, lo / hi, and replays
F32, BF16 = 4, 2
# bf16 floats vs plain, in bf16 ulps of max(|value|, its row's RMS) (scaled_ulps).
# A frame kernel's outputs pass 12 layers of bf16 roundings: its float32 sums
# run in another order than torch's, which moves a rounded value by one ulp
# now and then, and every later rounding spreads that step (a whole row
# after the next product). Measured at 357M (H100): 96.3-100% within 1 ulp
# per case, at most 5.1. A single rounding (the codec conv) stays within 1.
ULP_SHARE, ULP_MAX = 0.95, 8          # frame kernels: 95% within 1 ulp, none past 8
CONV_ULP_SHARE, CONV_ULP_MAX = 1.0, 1.0   # the codec conv: every value within 1 ulp


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


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S) -> dict:
    """The least time the card could take for a function: the larger of the
    bytes it must move over the memory rate and its operations over the
    peak for its inputs' type (float32 by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def codec_bound(nbytes: float, flops: float, dtype: str) -> dict:
    """The codec kernels' bound: bf16 at the tensor cores' bf16 rate; float32
    as the design runs it, 3 TF32 products per product on the tensor cores,
    with the SIMT float32 bound beside it (``bound_simt_ms``)."""
    if dtype != "float32":
        return bound(nbytes, flops, BF16_FLOPS_PER_S)
    return {**bound(nbytes, 3 * flops, TF32_FLOPS_PER_S),
            "bound_simt_ms": bound(nbytes, flops)["bound_ms"]}


def lt_work(c, B: int, elt: int = F32):
    """(bytes, flops) of B slots' LT sampling: every LT weight and output head
    read once, each slot's hidden row and its 8 sampled embedding rows read,
    its codes written; the matrix products' flops (the 9-row attention and the
    sampling passes are small beside them). ``elt``: bytes per weight / row
    element (4 float32, 2 bfloat16)."""
    D, LT, LF, V, n = c.d_model, c.lt_dim, c.lt_ffn_dim, c.vocab_per_cb, c.num_codebooks
    weights = D * LT + LT + n * LT + 2 * LT + 4 * LT * LT + 2 * LT * LF + n * (LT * V + V)
    nbytes = elt * (weights + B * (D + n * D)) + B * 2 * n * 4
    flops = B * n * 2 * (D * LT + 4 * LT * LT + 2 * LT * LF + LT * V)
    return nbytes, flops


def dec_work(c, kv_rows, enc_rows, input_rows: int = 2, stream: str = "dense",
             elt: int = F32):
    """(bytes, flops) of one decoder step for slots attending kv_rows[b]
    existing cache rows and enc_rows[b] cross-attention rows: every decoder
    weight read once (the four streamed matrices as 1-byte int8 values plus
    their float32 scales with an ``int8`` or ``q8`` stream: one per column,
    or one per 32 rows of a column); per slot its rows of K and V, its
    cross-attention K/V rows and ``input_rows`` rows of input (the embedding
    and its posemb row) read, its new K/V rows and hidden written; ``elt``
    bytes per weight / cache / row element (4 float32, 2 bfloat16)."""
    D, F, X, L = c.d_model, c.d_ffn, c.d_xa, c.dec_layers
    mats = 3 * D * D + D * D + D * X + X * D + 2 * D * F
    streamed = 3 * D * D + D * D + 2 * D * F
    scales = {"dense": 0, "int8": 3 * D + D + F + D,
              "q8": streamed // 32}[stream]
    weight_bytes = elt * mats if stream == "dense" else (
        elt * (mats - streamed) + streamed + F32 * scales)
    nbytes = L * (weight_bytes + elt * 3 * D) + elt * D
    flops = 0
    for r, e in zip(kv_rows, enc_rows):
        nbytes += elt * (2 * L * r * D + 2 * L * e * X + input_rows * D + 2 * L * D + D)
        flops += 2 * L * mats + 4 * L * (r + 1) * D + 4 * L * e * X
    return nbytes, flops


def prod_weights(dev, dtype: str = "float32"):
    """Random 357M weights (seed 0) on the card in ``dtype``, made once for
    every phase."""
    return _prod_weights(dev, dtype)


@functools.lru_cache(maxsize=2)
def _prod_weights(dev, dtype: str):
    import torch

    from magpie_tts_tpu_torch.config import MagpieConfig
    from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights

    if dtype != "float32":
        c, w = prod_weights(dev)
        return c, w.to(dtype=getattr(torch, dtype))
    c = MagpieConfig()
    return c, random_magpie_weights(c, seed=0).to(device=dev)


# --------------------------------------------------------------- GGUF files

# The converter's Q8_0 allowlist (tools/convert_nemo_to_gguf.py
# QUANT_PATTERNS): attention / FFN / projection weight matrices quantize;
# norms, biases and embeddings stay float32.
QUANT_PATTERNS = (
    r"\.layers\.\d+\.self_attention\.(qkv_net|o_net)\.weight$",
    r"\.layers\.\d+\.cross_attention\.(q_net|kv_net|o_net)\.weight$",
    r"\.layers\.\d+\.pos_ff\.(proj|o_net)\.conv\.weight$",
    r"^final_proj\.weight$",
    r"^local_transformer_out_projections\.\d+\.weight$",
    r"^local_transformer_in_projection\.weight$",
)


def write_model_gguf(path: str, config, seed: int, quant=None) -> None:
    """Random-weight Magpie GGUF with the converter's tensor names, hparams
    and a small tokenizer payload; ``quant="q8_0"`` stores the converter's
    allowlisted tensors as Q8_0 (the same float weights for the same seed)."""
    from magpie_tts_tpu_torch.io.gguf import GGML_Q8_0, GGUFWriter

    c = config
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.02):
        return rng.normal(0, scale, size=shape).astype(np.float32)

    def g(*shape):
        return (1.0 + rng.normal(0, 0.05, size=shape)).astype(np.float32)

    wr = GGUFWriter()

    def add(name, arr):
        q8 = quant == "q8_0" and any(re.search(p, name) for p in QUANT_PATTERNS)
        wr.add_tensor(name, arr, GGML_Q8_0 if q8 else None)

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
    add("text_embedding.weight", w(c.text_vocab_size, D))
    add("encoder.position_embeddings.weight", w(c.max_pos, D))
    for i in range(c.enc_layers):
        p = f"encoder.layers.{i}"
        add(f"{p}.norm_self.weight", g(D))
        add(f"{p}.self_attention.qkv_net.weight", w(3 * D, D))
        add(f"{p}.self_attention.o_net.weight", w(D, D))
        add(f"{p}.norm_pos_ff.weight", g(D))
        add(f"{p}.pos_ff.proj.conv.weight", w(F, D, c.enc_kernel))
        add(f"{p}.pos_ff.o_net.conv.weight", w(D, F, c.enc_kernel))
    add("encoder.norm_out.weight", g(D))
    add("decoder.position_embeddings.weight", w(c.max_pos, D))
    for i in range(c.dec_layers):
        p = f"decoder.layers.{i}"
        add(f"{p}.norm_self.weight", g(D))
        add(f"{p}.self_attention.qkv_net.weight", w(3 * D, D))
        add(f"{p}.self_attention.o_net.weight", w(D, D))
        add(f"{p}.norm_xattn_query.weight", g(D))
        add(f"{p}.norm_xattn_memory.weight", g(D))
        add(f"{p}.cross_attention.q_net.weight", w(c.d_xa, D))
        add(f"{p}.cross_attention.kv_net.weight", w(2 * c.d_xa, D))
        add(f"{p}.cross_attention.o_net.weight", w(D, c.d_xa))
        add(f"{p}.norm_pos_ff.weight", g(D))
        add(f"{p}.pos_ff.proj.conv.weight", w(F, D, 1))
        add(f"{p}.pos_ff.o_net.conv.weight", w(D, F, 1))
    add("decoder.norm_out.weight", g(D))
    for i in range(c.num_codebooks):
        add(f"audio_embeddings.{i}.weight", w(c.vocab_per_cb, D))
    add("baked_context_embedding.weight", w(c.num_speakers, c.context_frames * D))
    add("final_proj.weight", w(c.num_codebooks * c.vocab_per_cb, D))
    add("final_proj.bias", w(c.num_codebooks * c.vocab_per_cb))
    add("local_transformer_in_projection.weight", w(c.lt_dim, D))
    add("local_transformer_in_projection.bias", w(c.lt_dim))
    add("local_transformer.position_embeddings.weight", w(c.lt_max_pos, c.lt_dim))
    lp = "local_transformer.layers.0"
    add(f"{lp}.norm_self.weight", g(c.lt_dim))
    add(f"{lp}.self_attention.qkv_net.weight", w(3 * c.lt_dim, c.lt_dim))
    add(f"{lp}.self_attention.o_net.weight", w(c.lt_dim, c.lt_dim))
    add(f"{lp}.norm_pos_ff.weight", g(c.lt_dim))
    add(f"{lp}.pos_ff.proj.conv.weight", w(c.lt_ffn_dim, c.lt_dim, 1))
    add(f"{lp}.pos_ff.o_net.conv.weight", w(c.lt_dim, c.lt_ffn_dim, 1))
    for i in range(c.num_codebooks):
        add(f"local_transformer_out_projections.{i}.weight", w(c.vocab_per_cb, c.lt_dim))
        add(f"local_transformer_out_projections.{i}.bias", w(c.vocab_per_cb))
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


def single_state(dev, dtype: str = "float32"):
    """One stream after prepare() at 357M width in ``dtype``, and K/V caches
    whose rows past the speaker context hold random K/V of the prefill's
    scale."""
    return _single_state(dev, dtype)


@functools.lru_cache(maxsize=2)
def _single_state(dev, dtype: str):
    import torch

    from magpie_tts_tpu_torch.models import magpie as magpie_mod

    c, w = prod_weights(dev, dtype)
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(2, c.text_vocab_size - 2, size=32), device=dev)
    with torch.no_grad():
        xa_k, xa_v, st = magpie_mod.prepare(tokens, SINGLE_ENC, 0, w, c)
    scale = float(st.k_cache[:, :c.context_frames].float().std())
    gen = torch.Generator(device=dev).manual_seed(0)
    filler = lambda: (torch.randn(st.k_cache.shape, generator=gen, device=dev) * scale).to(
        st.k_cache.dtype)
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


def batched_state(dev, dtype: str = "float32"):
    """BATCH_MAX prepared streams at 357M width in ``dtype`` (xa padded to
    BATCH_ENC rows) and K/V caches of random rows at the prefill's scale."""
    return _batched_state(dev, dtype)


@functools.lru_cache(maxsize=2)
def _batched_state(dev, dtype: str):
    import torch

    from magpie_tts_tpu_torch.models import magpie as magpie_mod

    c, w = prod_weights(dev, dtype)
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
    scale = float(k_ctx[:, :, :c.context_frames].float().std())
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (Bmax, c.dec_layers, c.max_seq, c.d_model)
    k_base = (torch.randn(shape, generator=gen, device=dev) * scale).to(k_ctx.dtype)
    v_base = (torch.randn(shape, generator=gen, device=dev) * scale).to(k_ctx.dtype)
    return c, w, hidden, xa_k, xa_v, k_base, v_base, enc


def batched_inputs(dev, B: int, write_row: int, rng, dtype: str = "float32") -> dict:
    """Kernel C's arguments for B slots of batched_state: ring-style masks
    (the last slot empty), random may_continue / posemb rows / seeds /
    forbid_eos."""
    import torch

    c, w, hidden, xa_k, xa_v, _, _, enc = batched_state(dev, dtype)
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


def codec_conv_classes(cw, cfg, frames: int):
    """(name, T, w, b, alpha, dilation, residual?, multiplicity) of every conv
    class of a ``frames``-frame decode: 92 convs."""
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
    return classes


def slope_in_turns(fns: dict, n=CODEC_SLOPE_N) -> dict:
    """Per-call device ms of each zero-argument function by CUDA-graph slope
    (scripts/timing.graph_slope), in turns: a, b, ..., then the reverse
    order; the mean of the two turns."""
    from magpie_tts_tpu_torch.scripts import timing
    import torch

    out = {k: [] for k in fns}
    for key in list(fns) + list(fns)[::-1]:
        fn = fns[key]
        out[key].append(timing.graph_slope(lambda i, h, fn=fn: (fn(), h)[1],
                                           torch.zeros(1, device="cuda"), n[0], n[1],
                                           n[2])["per_launch_ms"])
    return {k: sum(v) / len(v) for k, v in out.items()}


def check_codec_conv(dev, frames: int = 32, dtype: str = "float32") -> dict:
    """Kernel B vs the plain HalfSnake + conv for every conv class of a decode
    of ``frames`` frames, in ``dtype`` (bfloat16: every value within
    CONV_ULP_MAX scaled bf16 ulps); then each class's device time by
    CUDA-graph slope beside one cuDNN ``conv1d`` of the same shapes (TF32
    off), in turns, and their CUDA-event means, summed over the 92 convs of
    that decode."""
    import torch

    from magpie_tts_tpu_torch.config import CodecConfig
    from magpie_tts_tpu_torch.io.codec_weights import random_codec_weights
    from magpie_tts_tpu_torch.models.codec import half_snake
    from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc

    cfg = CodecConfig()
    dt = getattr(torch, dtype)
    elt = F32 if dtype == "float32" else BF16
    cw = random_codec_weights(cfg, seed=0).to(device=dev, dtype=dt)
    gen = torch.Generator(device=dev).manual_seed(1)
    classes = codec_conv_classes(cw, cfg, frames)

    worst, nbytes, flops = 0.0, 0, 0
    f64 = [0.0, 0.0]  # float32: max abs err of the kernel, of plain, against float64
    signed = {"kernel": [], "plain": []}  # bf16: signed ulps against float64
    tot = dict.fromkeys(("graph", "lib_graph", "event", "lib_event", "plain"), 0.0)
    stages, ulps = {}, []
    with torch.no_grad():
        for name, T, wt, b, alpha, d, res, mult in classes:
            k, c_in, c_out = wt.shape
            x = (torch.randn(1, T, c_in, generator=gen, device=dev) * 0.5).to(dt)
            r = (torch.randn(1, T, c_out, generator=gen, device=dev) * 0.5).to(dt) if res else None
            got = cc.snake_causal_conv(x, wt, b, alpha, d, cfg.leaky_slope, residual=r)
            want = cc.snake_causal_conv_reference(x, wt, b, alpha, d, cfg.leaky_slope, r)
            err = float((got.float() - want.float()).abs().max())
            # both against the same conv in float64, of the same activated
            # (and, in bf16, rounded) input: cuDNN's float32 has its own error
            h = (x if alpha is None else half_snake(x, alpha, cfg.leaky_slope)).double()
            conv = torch.nn.functional.conv1d(
                torch.nn.functional.pad(h.transpose(1, 2), ((k - 1) * d, 0)),
                wt.double().permute(2, 1, 0), dilation=d).transpose(1, 2)
            exact = conv + b.double() + (0.0 if r is None else r.double())
            if dtype == "float32":
                ok = torch.allclose(got, want, atol=CONV_ATOL, rtol=CONV_RTOL)
                f64[0] = max(f64[0], float((got.double() - exact).abs().max()))
                f64[1] = max(f64[1], float((want.double() - exact).abs().max()))
            else:
                ulps.append(scaled_ulps(got, want).flatten())
                ok = ulp_ok(ulps[-1], CONV_ULP_SHARE, CONV_ULP_MAX)
                # a bias of the sums shows as a mean error toward zero of the conv's sum
                for who, v in (("kernel", got), ("plain", want)):
                    signed[who].append(signed_ulps(v, exact, conv.sign()).flatten())
            if not ok:
                raise AssertionError(f"codec conv {name} ({c_in}->{c_out}, k{k}, d{d}, T{T}, "
                                     f"{dtype}) disagrees: max abs err {err}")
            kernel = lambda: cc.snake_causal_conv(x, wt, b, alpha, d, 0.01, residual=r)
            # The library yardstick: one cuDNN conv1d (TF32 off) of the same
            # shapes; it leaves out the HalfSnake and the residual add.
            x_nct, w_oik = x.transpose(1, 2).contiguous(), wt.permute(2, 1, 0).contiguous()
            library = lambda: torch.nn.functional.conv1d(x_nct, w_oik, b, dilation=d,
                                                         padding=(k - 1) * d)
            slopes = slope_in_turns({"kernel": kernel, "library": library})
            t_k, t_l = time_ms(kernel, 5), time_ms(library, 5)
            t_p = time_ms(lambda: cc.snake_causal_conv_reference(x, wt, b, alpha, d, 0.01, r), 3)
            plan = cc.plan_conv(1, T, c_in, c_out, k, d, dt, act=alpha is not None)
            f = 2 * T * k * c_in * c_out
            log(f"codec_conv[{dtype}] {name:18s} {c_in:4d}->{c_out:4d} k{k:2d} d{d} T{T:6d} "
                f"res={int(res)} x{mult}: max abs err {err:.3g}; graph slope kernel "
                f"{slopes['kernel']:.5f} ms ({f / slopes['kernel'] / 1e9:.1f} TFLOP/s), conv1d "
                f"{slopes['library']:.5f} ms; events kernel {t_k:.4f} ms, conv1d {t_l:.4f} ms, "
                f"plain {t_p:.4f} ms; plan {plan.tile_m}x{plan.tile_n}, {plan.blocks} blocks, "
                f"{plan.smem} B smem")
            worst = max(worst, err)
            for key, v in (("graph", slopes["kernel"]), ("lib_graph", slopes["library"]),
                           ("event", t_k), ("lib_event", t_l), ("plain", t_p)):
                tot[key] += v * mult
            st = stages.setdefault(name.split(".")[0], [0.0, 0.0, 0.0])
            st[0] += slopes["kernel"] * mult
            st[1] += slopes["library"] * mult
            st[2] += f * mult
            n_alpha = 0 if alpha is None else alpha.numel()
            nbytes += mult * elt * (T * c_in + k * c_in * c_out + c_out + n_alpha
                                    + T * c_out * (2 if res else 1))
            flops += mult * f
    for name, (t_k, t_l, f) in stages.items():
        log(f"codec_conv[{dtype}] {name}: {f / 1e9:.2f} GFLOP, kernel {t_k:.4f} ms "
            f"({f / t_k / 1e9:.1f} TFLOP/s), conv1d {t_l:.4f} ms (graph slopes)")
    log(f"codec_conv[{dtype}]: 92 convs of a {frames}-frame decode ({flops / 1e9:.1f} GFLOP): "
        f"graph slope kernel {tot['graph']:.4f} ms, conv1d {tot['lib_graph']:.4f} ms; CUDA-event "
        f"means kernel {tot['event']:.4f} ms, conv1d {tot['lib_event']:.4f} ms, plain "
        f"{tot['plain']:.4f} ms")
    out = {"max_abs_err": worst, "ms": tot["graph"], "plain_ms": tot["plain"],
           "library_ms": tot["lib_graph"], "event_ms": tot["event"],
           "library_event_ms": tot["lib_event"], "gflop": flops / 1e9,
           **codec_bound(nbytes, flops, dtype)}
    if dtype == "float32":
        out["f64_err"], out["plain_f64_err"] = f64
        log(f"codec_conv[float32]: against a float64 conv, max abs err kernel {f64[0]:.3g}, "
            f"plain (cuDNN float32) {f64[1]:.3g}")
    else:
        out.update(signed_summary(signed, "codec_conv[bfloat16]", "a float64 conv"))
    if ulps:
        out.update(ulp_summary(torch.cat(ulps)))
    return out


def time_codec_decode(dev, dtype: str, frames: int = 32) -> dict:
    """One ``CodecEngine.decode`` of ``frames`` frames at full width: its wall
    time (host clock, the result on the host), and its device time (the
    union of the kernels' intervals in a ``torch.profiler`` trace of one
    more decode), with the kernel-B launches it made."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from magpie_tts_tpu_torch.config import CodecConfig
    from magpie_tts_tpu_torch.io.codec_weights import random_codec_weights
    from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine

    cfg = CodecConfig()
    codec = CodecEngine(random_codec_weights(cfg, seed=1), cfg, device=dev,
                        compute_dtype=getattr(torch, dtype))
    codes = np.random.default_rng(5).integers(0, cfg.codebook_size, size=(frames, 8))
    for _ in range(2):
        codec.decode(codes, bucket=False)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio = codec.decode(codes, bucket=False)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    if audio.shape != (frames * cfg.hop_length,) or not np.all(np.isfinite(audio)):
        raise AssertionError(f"codec decode [{dtype}]: bad audio {audio.shape}")
    cc.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        codec.decode(codes, bucket=False)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy")
                   and not e.name.startswith("Memset")
                   and not getattr(e, "is_user_annotation", False))
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    walls.sort()
    res = {"wall_ms": walls[len(walls) // 2], "device_ms": busy / 1e3, "kernels": len(spans),
           "conv_launches": cc.launches}
    log(f"codec decode [{dtype}] of {frames} frames: wall {res['wall_ms']:.4f} ms (median of 5, "
        f"host clock), device {res['device_ms']:.4f} ms (union of {res['kernels']} kernels, "
        f"{res['conv_launches']} of them kernel B)")
    return res


# Kernel 9 in bf16 against plain, in scaled ulps: a branch chains 6 convs,
# each rounding to bf16, and float32 sums in another order than torch's move a
# rounding by one ulp now and then, which the later convs spread (94.95%
# within 1 ulp at C = 108, T = 1000 on an H100, where the frame kernels' 95%
# failed).
RES_ULP_SHARE, RES_ULP_MAX = 0.90, 8
RES_REL = 1e-5     # kernel 9 in float32: max abs err <= 1e-5 x max |plain|


def res_layer_f64_convs(x, layer, leaky_slope: float = 0.01):
    """res_layer_fused_reference with each conv summed in float64 (then + bias
    and one rounding to x's dtype): the same rounding points, exact sums."""
    import torch.nn.functional as F

    from magpie_tts_tpu_torch.models.codec import half_snake

    def conv(h, w, b, d):
        k = w.shape[0]
        xt = F.pad(h.transpose(1, 2).double(), ((k - 1) * d, 0))
        out = F.conv1d(xt, w.permute(2, 1, 0).double(), dilation=d).transpose(1, 2)
        return (out + b.double()).to(h.dtype)

    per = len(layer.convs) // layer.n_branches
    acc = None
    for s in range(0, len(layer.convs), per):
        h = x
        for (w1, b1, a1, d1), (w2, b2, a2, d2) in zip(layer.convs[s:s + per:2],
                                                      layer.convs[s + 1:s + per:2]):
            r = conv(half_snake(h, a1, leaky_slope), w1, b1, d1)
            r = conv(half_snake(r, a2, leaky_slope), w2, b2, d2)
            h = h + r
        acc = h if acc is None else acc + h
    return (acc.float() / layer.n_branches).to(x.dtype)


def check_res_layer_fused(dev, frames: int = 32, dtype: str = "float32") -> dict:
    """Kernel 9 vs its plain version on the three res layers of <= 128
    channels of a ``frames``-frame decode (C = 108 / 54 / 27 at T = 256 /
    512 / 1024 rows per frame), at N = 1 and N = 3 (decode_batch), plus a T
    that is not a multiple of any tile and one below the halo; then CUDA-event
    ms of the three layers: the kernel, its plain version, kernel B's 54
    per-conv launches (the A/B, in the order fused / B / B / fused) and the
    same 54 convs as bare ``conv1d`` calls (the library yardstick)."""
    import torch
    import torch.nn.functional as F

    from magpie_tts_tpu_torch.config import CodecConfig
    from magpie_tts_tpu_torch.io.codec_weights import random_codec_weights
    from magpie_tts_tpu_torch.models import codec as codec_mod
    from magpie_tts_tpu_torch.ops.kernels import codec_res_fused as crf

    cfg = CodecConfig()
    dt = getattr(torch, dtype)
    elt = F32 if dtype == "float32" else BF16
    cw = random_codec_weights(cfg, seed=0).to(device=dev, dtype=dt)
    gen = torch.Generator(device=dev).manual_seed(2)
    layers, T = [], frames
    for stage, rate in zip(cw.stages, cfg.up_sample_rates):
        T *= rate
        C = stage.convt_b.shape[0]
        if C <= crf.MAX_CHANNELS:
            layers.append((stage, T, crf.stack_res_layer(stage.resblocks,
                                                         cfg.resblock_dilations)))
    if [la.channels for _, _, la in layers] != [108, 54, 27]:
        raise AssertionError("kernel 9 serves the 108-, 54- and 27-channel stages")
    cases = [(stage, la, n, T_) for stage, T_, la in layers for n in (1, 3)]
    cases += [(layers[0][0], layers[0][2], 1, layers[0][1] + 13),
              (layers[2][0], layers[2][2], 3, 100)]
    worst, ulps = 0.0, []
    exact_ulps = {"kernel": [], "plain": []}  # bf16: scaled ulps against float64 convs
    signed = {"kernel": [], "plain": []}
    with torch.no_grad():
        for _, la, n, T_ in cases:
            x = (torch.randn(n, T_, la.channels, generator=gen, device=dev) * 0.5).to(dt)
            got = crf.res_layer_fused(x, la)
            want = crf.res_layer_fused_reference(x, la)
            if dtype != "float32":
                exact = res_layer_f64_convs(x, la, cfg.leaky_slope)
                for who, v in (("kernel", got), ("plain", want)):
                    exact_ulps[who].append(scaled_ulps(v, exact).flatten())
                    signed[who].append(signed_ulps(v, exact, exact.sign()).flatten())
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            if dtype == "float32":
                ok = bool(torch.isfinite(got).all()) and err <= RES_REL * scale
                note = f"max abs err {err:.3g} of max |plain| {scale:.4g} ({err / scale:.2e})"
            else:
                ulps.append(scaled_ulps(got, want).flatten())
                ok = ulp_ok(ulps[-1], RES_ULP_SHARE, RES_ULP_MAX)
                note = (f"max abs err {err:.3g}, {ulp_summary(ulps[-1])} (bar "
                        f"{RES_ULP_SHARE} within 1 ulp, none past {RES_ULP_MAX})")
            log(f"res_layer_fused[{dtype}] C{la.channels} N{n} T{T_}: {note}")
            if not ok:
                raise AssertionError(f"kernel 9 (C={la.channels}, N={n}, T={T_}, {dtype}) "
                                     f"disagrees with its plain version: {note}")
            worst = max(worst, err)
        xs = [(torch.randn(1, T_, la.channels, generator=gen, device=dev) * 0.5).to(dt)
              for _, T_, la in layers]
        dil = cfg.resblock_dilations

        def fused():
            for x, (_, _, la) in zip(xs, layers):
                crf.res_layer_fused(x, la)

        def per_conv():   # kernel B, 18 launches a layer (MAGPIE_FUSED_CODEC unset)
            for x, (stage, _, _) in zip(xs, layers):
                codec_mod.res_layer(x, stage.resblocks, dil, cfg.leaky_slope)

        def plain():
            for x, (_, _, la) in zip(xs, layers):
                crf.res_layer_fused_reference(x, la)

        convs = [(x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous(), b, d)
                 for x, (_, _, la) in zip(xs, layers) for w, b, _, d in la.convs]

        def library():  # the 54 convs alone, cuDNN (TF32 off), no HalfSnake or residual
            for xt, wt, b, d in convs:
                F.conv1d(xt, wt, b, dilation=d, padding=(wt.shape[-1] - 1) * d)

        t_f = [time_ms(fused, 5)]
        t_b = [time_ms(per_conv, 5), time_ms(per_conv, 5)]
        t_f.append(time_ms(fused, 5))
        t_p = time_ms(plain, 3)
        t_l = time_ms(library, 5)
        # device time by CUDA-graph slope, one body = the 3 layers, in turns
        g = slope_in_turns({"fused": fused, "per_conv": per_conv, "library": library},
                           (1, 3, CODEC_SLOPE_N[2]))
    flops = sum(2 * T_ * la.w.numel() for _, T_, la in layers)
    nbytes = sum(elt * (2 * T_ * la.channels + la.w.numel() + la.bias.numel() + la.alpha.numel())
                 for _, T_, la in layers)
    ms, b_ms = sum(t_f) / 2, sum(t_b) / 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = [crf.pick_tile(1, T_, la, sms) for _, T_, la in layers]
    log(f"res_layer_fused[{dtype}]: the 3 layers of a {frames}-frame decode ({flops / 1e9:.1f} "
        f"GFLOP), tiles {tiles}: "
        f"graph slope kernel 9 {g['fused']:.4f} ms, kernel B (54 launches) {g['per_conv']:.4f} "
        f"ms, conv1d x54 {g['library']:.4f} ms; CUDA-event means kernel 9 {t_f[0]:.4f} / "
        f"{t_f[1]:.4f} ms, kernel B {t_b[0]:.4f} / {t_b[1]:.4f} ms (order 9 / B / B / 9), plain "
        f"{t_p:.4f} ms, conv1d x54 {t_l:.4f} ms")
    out = {"max_abs_err": worst, "ms": g["fused"], "plain_ms": t_p, "library_ms": g["library"],
           "kernel_b_ms": g["per_conv"], "event_ms": ms, "kernel_b_event_ms": b_ms,
           "library_event_ms": t_l, "gflop": flops / 1e9, **codec_bound(nbytes, flops, dtype)}
    if dtype != "float32":
        who = "res_layer_fused[bfloat16]"
        k_ulps, p_ulps = torch.cat(exact_ulps["kernel"]), torch.cat(exact_ulps["plain"])
        out["f64_within_1ulp"] = float((k_ulps <= 1).float().mean())
        out["plain_f64_within_1ulp"] = float((p_ulps <= 1).float().mean())
        log(f"{who}: against the same layer with float64 convs (the same bf16 rounding "
            f"points), within 1 ulp: kernel {out['f64_within_1ulp']:.4f}, plain "
            f"{out['plain_f64_within_1ulp']:.4f}")
        out.update(signed_summary(signed, who, "float64 convs"))
    if ulps:
        out.update(ulp_summary(torch.cat(ulps)))
    return out


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


STREAMS = ("q8", "int8")


@functools.lru_cache(maxsize=1)
def prod_streams(dev):
    """The weight streams of prod_weights' decoder: the Q8_0 stream (its
    matrices round-tripped through the Q8_0 codec), the weights whose decoder
    holds that stream's dequantized matrices, and the int8 stream."""
    import torch

    from magpie_tts_tpu_torch.io.magpie_weights import (q8_dequantized_decoder,
                                                         q8_stream_from_arrays,
                                                         quantize_decoder_stream)

    c, w = prod_weights(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        q8 = q8_stream_from_arrays(w.decoder).to(dev)
        deq = dataclasses.replace(w, decoder=q8_dequantized_decoder(w.decoder, q8))
        int8 = quantize_decoder_stream(w.decoder)
    log(f"Q8_0 and int8 streams of the 357M decoder made in {time.perf_counter() - t0:.1f} s")
    return q8, deq, int8


def stream_variants(deq, q8, w, int8):
    """(name, weights, stream, plain?) of a stream comparison: the Q8_0
    stream and dense on the dequantized weights, each stream's kernel and
    plain version."""
    return (("q8", deq, q8, False), ("dense", deq, None, False), ("q8_plain", deq, q8, True),
            ("int8", w, int8, False), ("int8_plain", w, int8, True))


def _compare_stream_runs(out: dict, who: str, n_codes: int, live=slice(None)) -> dict:
    """The Q8_0 kernel against the dense kernel on the dequantized weights (bit
    for bit), and each stream's kernel against its plain version (codes
    exact, floats within FRAME_TOL on the live slots). ``out[name]`` is the
    run's outputs, its ``n_codes`` code tensors first. Returns the largest
    float difference from plain per stream."""
    import torch

    bit_equal = all(torch.equal(a, b) for a, b in zip(out["q8"], out["dense"]))
    errs = {}
    for mode in STREAMS:
        got, want = out[mode], out[mode + "_plain"]
        n_diff = sum(int((a != b).sum()) for a, b in zip(got[:n_codes], want[:n_codes]))
        errs[mode] = _max_err(zip(got[n_codes:], want[n_codes:]), live)
        if n_diff or errs[mode] > FRAME_TOL:
            raise AssertionError(f"{who}: the {mode} stream kernel disagrees with plain: "
                                 f"{n_diff} codes, err {errs[mode]}")
    log(f"{who}: Q8_0 stream equal to dense on the dequantized weights bit for bit: "
        f"{bit_equal}; codes equal to plain (q8, int8); max |float err| vs plain q8 "
        f"{errs['q8']:.3g}, int8 {errs['int8']:.3g}")
    if not bit_equal:
        raise AssertionError(f"{who}: the Q8_0 stream differs from dense on dequantized weights")
    return errs


def check_stream_single(dev) -> dict:
    """Kernels A and 5 with the Q8_0 and int8 streams at full width, positions
    111 / 300 / 610, temperatures 0 / 0.7: the Q8_0 stream bit-equal to the
    same kernel dense on the dequantized weights (codes, hidden, K/V rows),
    each stream against its plain version; CUDA-event times at pos 300."""
    import torch

    from magpie_tts_tpu_torch.models.magpie import audio_frame_embedding
    from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs

    c, w, xa_k, xa_v, hidden, k_base, v_base, positions = single_state(dev)
    q8, deq, int8 = prod_streams(dev)
    enc_len = SINGLE_ENC
    codes = (torch.arange(c.num_codebooks, device=dev, dtype=torch.int32) * 37) % c.codebook_size
    emb = audio_frame_embedding(codes, w, c)
    variants = stream_variants(deq, q8, w, int8)
    worst = {m: {"A": 0.0, "5": 0.0} for m in STREAMS}
    with torch.no_grad():
        for pos in positions:
            for temp in (0.0, 0.7):
                seed = 3000 + pos

                def run(weights, stream, plain):
                    fa = fs.frame_step_reference if plain else fs.frame_step
                    f5 = ds.decode_step_reference if plain else ds.decode_step
                    ka, va, k5, v5 = (k_base.clone(), v_base.clone(), k_base.clone(),
                                      v_base.clone())
                    sa, aa, ha, _, _ = fa(hidden, pos, xa_k, xa_v, ka, va, weights, c, seed, temp,
                                          80, False, enc_length=enc_len, stream=stream)
                    h5 = f5(emb, pos, xa_k, xa_v, k5, v5, weights, c, enc_length=enc_len,
                            stream=stream)
                    return sa, aa, ha, ka, va, h5, k5, v5

                out = {name: run(wt, st, plain) for name, wt, st, plain in variants}
                torch.cuda.synchronize()
                errs_a = _compare_stream_runs({k: v[:5] for k, v in out.items()},
                                              f"frame_step streams pos {pos} temp {temp}", 2)
                errs_5 = _compare_stream_runs({k: v[5:] for k, v in out.items()},
                                              f"decoder_step streams pos {pos} temp {temp}", 0)
                for m in STREAMS:
                    worst[m]["A"] = max(worst[m]["A"], errs_a[m])
                    worst[m]["5"] = max(worst[m]["5"], errs_5[m])
        pos = positions[1]
        times = {}
        for m, weights, stream in (("q8", deq, q8), ("int8", w, int8), ("dense", w, None)):
            ka, va = k_base.clone(), v_base.clone()
            frame = (hidden, pos, xa_k, xa_v, ka, va, weights, c, 7, 0.7, 80, False)
            step = (emb, pos, xa_k, xa_v, ka, va, weights, c)
            times[m] = {
                "A": time_ms(lambda: fs.frame_step(*frame, enc_length=enc_len, stream=stream), 50),
                "5": time_ms(lambda: ds.decode_step(*step, enc_length=enc_len, stream=stream), 50)}
            if m != "dense":
                times[m]["A_plain"] = time_ms(lambda: fs.frame_step_reference(
                    *frame, enc_length=enc_len, stream=stream), reps=5)
                times[m]["5_plain"] = time_ms(lambda: ds.decode_step_reference(
                    *step, enc_length=enc_len, stream=stream), reps=5)
    log("stream times at pos {} (temp 0.7), CUDA-event ms: ".format(pos) + "; ".join(
        f"{m}: frame_step {t['A']:.4f}, decoder_step {t['5']:.4f}" for m, t in times.items()))
    lt_b, lt_f = lt_work(c, 1)
    res = {}
    for m in STREAMS:
        a_b, a_f = dec_work(c, [pos], [enc_len], input_rows=1, stream=m)
        d_b, d_f = dec_work(c, [pos], [enc_len], stream=m)
        res[m] = {"A": {"max_abs_err": worst[m]["A"], "ms": times[m]["A"],
                        "plain_ms": times[m]["A_plain"], "dense_ms": times["dense"]["A"],
                        **bound(lt_b + a_b, lt_f + a_f)},
                  "5": {"max_abs_err": worst[m]["5"], "ms": times[m]["5"],
                        "plain_ms": times[m]["5_plain"], "dense_ms": times["dense"]["5"],
                        **bound(d_b, d_f)}}
    return res


def check_stream_batched(dev) -> dict:
    """Kernels C and 8 with the Q8_0 and int8 streams at full width, B = 8 and
    32 with ring masks (the last slot empty), temperatures 0 / 0.7: the Q8_0
    stream bit-equal to the dense kernel on the dequantized weights, each
    stream against its plain version on the live slots; times at B = 8, row
    300."""
    import torch

    from magpie_tts_tpu_torch.models.magpie import audio_frame_embedding
    from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb

    c, w, _, _, _, k_base, v_base, _ = batched_state(dev)
    q8, deq, int8 = prod_streams(dev)
    rng = np.random.default_rng(4)
    variants = stream_variants(deq, q8, w, int8)
    worst = {m: {"C": 0.0, "8": 0.0} for m in STREAMS}

    def step8(x):
        """Kernel 8's inputs from kernel C's: the embedding of fixed codes +
        posemb, the write row valid where the slot may continue."""
        B, r = x["hidden"].shape[0], x["write_row"]
        codes = (torch.arange(B * c.num_codebooks, device=dev, dtype=torch.int32)
                 .reshape(B, -1) * 37) % c.codebook_size
        valid = x["valid"].clone()
        valid[:, r] = x["may_continue"]
        return (audio_frame_embedding(codes, w, c) + x["posemb"], r, valid, x["xa_k"], x["xa_v"])

    with torch.no_grad():
        for B, r in ((8, c.max_seq // 2 - 20), (BATCH_MAX, c.max_seq - 30)):
            for temp in (0.0, 0.7):
                x = batched_inputs(dev, B, r, rng)
                step = step8(x)

                def run(weights, stream, plain):
                    fc = fsb.frame_step_batched_reference if plain else fsb.frame_step_batched
                    f8 = (dsb.decode_step_batched_reference if plain
                          else dsb.decode_step_batched)
                    kc, vc = k_base[:B].clone(), v_base[:B].clone()
                    k8, v8 = k_base[:B].clone(), v_base[:B].clone()
                    args = dict(x, weights=weights)
                    sc, ac, hc, _, _ = fc(k_cache=kc, v_cache=vc, temperature=temp,
                                          stream=stream, **args)
                    h8 = f8(*step, k8, v8, weights, c, x["enc_lengths"], stream=stream)
                    return sc, ac, hc, kc, vc, h8, k8, v8

                out = {name: run(wt, st, plain) for name, wt, st, plain in variants}
                torch.cuda.synchronize()
                live = slice(0, B - 1)   # the last slot has no valid row
                errs_c = _compare_stream_runs(
                    {k: v[:5] for k, v in out.items()},
                    f"frame_step_batched streams B {B} row {r} temp {temp}", 2, live)
                errs_8 = _compare_stream_runs(
                    {k: v[5:] for k, v in out.items()},
                    f"decoder_step_batched streams B {B} row {r} temp {temp}", 0, live)
                for m in STREAMS:
                    worst[m]["C"] = max(worst[m]["C"], errs_c[m])
                    worst[m]["8"] = max(worst[m]["8"], errs_8[m])
        x = batched_inputs(dev, 8, c.max_seq // 2 - 20, rng)
        step = step8(x)
        times = {}
        for m, weights, stream in (("q8", deq, q8), ("int8", w, int8), ("dense", w, None)):
            kc, vc = k_base[:8].clone(), v_base[:8].clone()
            args = dict(x, weights=weights, k_cache=kc, v_cache=vc, temperature=0.7)
            times[m] = {
                "C": time_ms(lambda: fsb.frame_step_batched(**args, stream=stream), reps=30),
                "8": time_ms(lambda: dsb.decode_step_batched(*step, kc, vc, weights, c,
                                                             x["enc_lengths"], stream=stream),
                             reps=30)}
            if m != "dense":
                times[m]["C_plain"] = time_ms(lambda: fsb.frame_step_batched_reference(
                    **args, stream=stream), reps=3, warmup=1)
                times[m]["8_plain"] = time_ms(lambda: dsb.decode_step_batched_reference(
                    *step, kc, vc, weights, c, x["enc_lengths"], stream=stream),
                    reps=3, warmup=1)
    log(f"batched stream times at B=8 row {x['write_row']} (temp 0.7), CUDA-event ms: " +
        "; ".join(f"{m}: frame_step_batched {t['C']:.4f}, decoder_step_batched {t['8']:.4f}"
                  for m, t in times.items()))
    lt_b, lt_f = lt_work(c, 8)
    valid_rows = x["valid"].sum(-1).tolist()
    res = {}
    for m in STREAMS:
        c_b, c_f = dec_work(c, valid_rows, x["enc_lengths"].tolist(), input_rows=1, stream=m)
        d_b, d_f = dec_work(c, step[2].sum(-1).tolist(), x["enc_lengths"].tolist(),
                            input_rows=1, stream=m)
        res[m] = {"C": {"max_abs_err": worst[m]["C"], "ms": times[m]["C"],
                        "plain_ms": times[m]["C_plain"], "dense_ms": times["dense"]["C"],
                        **bound(lt_b + c_b, lt_f + c_f)},
                  "8": {"max_abs_err": worst[m]["8"], "ms": times[m]["8"],
                        "plain_ms": times[m]["8_plain"], "dense_ms": times["dense"]["8"],
                        **bound(d_b + 8 * c.max_seq, d_f)}}
    return res


# ------------------------------------------------------------------ bfloat16

BF = "bfloat16"  # the compute dtype of the bf16 phases


def scaled_ulps(got, want):
    """|got - want| in bf16 ulps of max(|want|, the RMS of want's row): an
    element's own ulp, or the ulp at its row's scale when it is smaller (a
    near-zero result of cancellation carries the float32 noise of its terms,
    many of its own ulps). Rows are the last axis (the whole tensor when that
    axis has one element)."""
    import torch

    g, w = got.float(), want.float()
    rows = w.pow(2).mean(-1, keepdim=True) if w.shape[-1] > 1 else w.pow(2).mean()
    ref = torch.maximum(w.abs(), rows.sqrt()).clamp_min(1e-30)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(ref)) - 7)


def signed_ulps(got, exact, sign):
    """(got - exact) * sign in the scaled bf16 ulps of ``scaled_ulps``:
    negative when got lies nearer zero than exact on the side ``sign`` gives."""
    import torch

    g, w = got.double(), exact.double()
    rows = w.pow(2).mean(-1, keepdim=True) if w.shape[-1] > 1 else w.pow(2).mean()
    ref = torch.maximum(w.abs(), rows.sqrt()).clamp_min(1e-30)
    return (g - w) * sign / torch.exp2(torch.floor(torch.log2(ref)) - 7)


def signed_summary(signed: dict, who: str, against: str) -> dict:
    """Mean signed ulps of the kernel and of plain (``signed_ulps`` lists),
    each with its standard error, logged."""
    import torch

    out = {}
    for k, parts in signed.items():
        v = torch.cat(parts)
        out[f"{k}_signed_ulps"] = float(v.mean())
        out[f"{k}_signed_ulps_se"] = float(v.std() / v.numel() ** 0.5)
    log(f"{who}: mean signed error against {against} (toward zero < 0), scaled bf16 ulps: "
        f"kernel {out['kernel_signed_ulps']:+.5f} (s.e. {out['kernel_signed_ulps_se']:.5f}), "
        f"plain {out['plain_signed_ulps']:+.5f} (s.e. {out['plain_signed_ulps_se']:.5f})")
    return out


def ulp_ok(d, share: float = None, most: float = None) -> bool:
    share = ULP_SHARE if share is None else share
    most = ULP_MAX if most is None else most
    return d.numel() == 0 or (float((d <= 1).float().mean()) >= share
                              and float(d.max()) <= most)


def ulp_summary(d) -> dict:
    return {"within_1ulp": float((d <= 1).float().mean()), "max_ulps": float(d.max())}


def ulp_pairs(pairs) -> "torch.Tensor":
    import torch

    return torch.cat([scaled_ulps(a, b).flatten() for a, b in pairs])


def lt_flips(hidden, sampled, argmax, w, c, seed, temp, top_k, forbid):
    """The codes of one slot's frame (a kernel's ``sampled`` / ``argmax``) that
    differ from the plain LT sampler fed the kernel's earlier codes, as
    (phase, gap, ulp): the plain winner's score minus the kernel's code's
    (in logits; at temp >= 0.01 the Gumbel score times temp) and one bf16
    ulp of the winner's logit. A flip is a near-tie when gap < ulp."""
    import math

    import torch

    from magpie_tts_tpu_torch.models import local_transformer as lt_mod
    from magpie_tts_tpu_torch.ops import sampling
    from magpie_tts_tpu_torch.ops.precision import matmul_f32

    lt, dev = w.lt, hidden.device
    mask = sampling.forbidden_token_mask(c.vocab_per_cb, c.audio_bos_id, device=dev)
    seq = torch.zeros(9, c.lt_dim, dtype=hidden.dtype, device=dev)
    seq[0] = lt_mod._in_proj(hidden, lt)
    cols = torch.arange(c.vocab_per_cb, device=dev)
    flips = []
    for cb in range(c.num_codebooks):
        hid = lt_mod._lt_layer_f32(seq, lt, c)[cb]
        logits = matmul_f32(hid.to(hidden.dtype), lt.out_proj_w[cb]) + lt.out_proj_b[cb].float()
        logits = sampling.mask_logits(logits, mask, bool(forbid), c.audio_eos_id)
        scored = [(logits, int(argmax[cb]), 1.0)]
        if temp >= 0.01:
            in_topk = sampling.exact_topk_mask(logits, min(top_k, c.vocab_per_cb))
            g = sampling.gumbel_from_seed(sampling.phase_seed(int(seed), cb).to(dev), cols)
            z = torch.where(in_topk, logits / temp + g, torch.full_like(logits, sampling.NEG_INF))
            scored.append((z, int(sampled[cb]), temp))
        for z, got, scale in scored:
            want = int(torch.argmax(z))
            if got != want:
                lw = abs(float(logits[want]))
                ulp = 2.0 ** (math.floor(math.log2(lw)) - 7) if lw > 0 else 0.0
                flips.append((cb, float(z[want] - z[got]) * scale, ulp))
        if cb < c.num_codebooks - 1:
            seq[cb + 1] = lt_mod._in_proj(w.audio_emb[cb, int(sampled[cb])], lt)
    return flips


def codes_agree(who, got, want, hidden, w, c, seeds, temp, forbid) -> list:
    """A bf16 kernel's codes (sampled, argmax) [B, 8] against plain: equal, or
    every differing code a near-tie of the plain scores (lt_flips). Returns
    the slots whose codes differ (their later floats follow other codes)."""
    import torch

    slots = [b for b in range(got[0].shape[0])
             if not (torch.equal(got[0][b], want[0][b]) and torch.equal(got[1][b], want[1][b]))]
    for b in slots:
        flips = lt_flips(hidden[b], got[0][b].tolist(), got[1][b].tolist(), w, c,
                         int(seeds[b]), temp, 80, bool(forbid[b]))
        log(f"{who}: slot {b} codes differ from plain; flips (phase, gap, ulp) {flips}")
        if not flips or any(gap >= ulp for _, gap, ulp in flips):
            raise AssertionError(f"{who}: slot {b} codes differ from plain past a near-tie "
                                 f"({flips})")
    return slots


def bf16_streams(dev):
    """The Q8_0 and int8 streams of prod_streams, and the bf16 weights whose
    decoder holds the Q8_0 stream dequantized at load in bf16 (the exact f32
    product rounded once)."""
    import torch

    from magpie_tts_tpu_torch.io.magpie_weights import STREAMED, q8_dequantized_decoder

    q8, _, int8 = prod_streams(dev)
    _, w = prod_weights(dev, BF)
    deq = q8_dequantized_decoder(w.decoder, q8)
    deq = dataclasses.replace(deq, **{n: getattr(deq, n).to(torch.bfloat16) for n in STREAMED})
    return q8, dataclasses.replace(w, decoder=deq), int8


def check_bf16_single(dev) -> dict:
    """Kernels A, 4 and 5 in bfloat16 against their plain versions at full
    width, positions 111 / 300 / 610, temperatures 0 / 0.7 (codes equal or
    near-ties; hidden and the new K/V rows within ULP_SHARE / ULP_MAX bf16
    ulps), and with the weight streams at pos 300: the Q8_0 stream bit-equal
    to the same kernel dense on the weights dequantized in bf16, the Q8_0 and
    int8 streams against plain. CUDA-event times at pos 300."""
    import torch

    from magpie_tts_tpu_torch.models.magpie import audio_frame_embedding
    from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts

    c, w, xa_k, xa_v, hidden, k_base, v_base, positions = single_state(dev, BF)
    q8, deq, int8 = bf16_streams(dev)
    enc = SINGLE_ENC
    d = {k: [] for k in ("A", "5", "A_q8", "5_q8", "A_int8", "5_int8")}
    err = dict.fromkeys(d, 0.0)
    flipped = 0

    def rows(kc, vc, pos):
        return kc[:, pos], vc[:, pos]

    def add(key, pairs):
        d[key].append(ulp_pairs(pairs))
        err[key] = max(err[key], max(float((a.float() - b.float()).abs().max()) for a, b in pairs))

    with torch.no_grad():
        for pos in positions:
            for temp in (0.0, 0.7):
                seed, forbid = 4000 + pos, pos == positions[0]
                (kk, vk), (kr, vr), (k5, v5), (k5r, v5r) = [(k_base.clone(), v_base.clone())
                                                            for _ in range(4)]
                frame = (xa_k, xa_v)
                sk, ak, hk, _, _ = fs.frame_step(hidden, pos, *frame, kk, vk, w, c, seed, temp, 80,
                                                 forbid, enc_length=enc)
                sr, ar, hr, _, _ = fs.frame_step_reference(hidden, pos, *frame, kr, vr, w, c, seed,
                                                           temp, 80, forbid, enc_length=enc)
                s4, a4 = lts.sample_frame_codes(hidden, w, c, seed, temp, 80, forbid)
                emb = audio_frame_embedding(sr, w, c)
                h5 = ds.decode_step(emb, pos, *frame, k5, v5, w, c, enc_length=enc)
                h5r = ds.decode_step_reference(emb, pos, *frame, k5r, v5r, w, c, enc_length=enc)
                torch.cuda.synchronize()
                who = f"bf16 pos {pos} temp {temp}"
                one = lambda t: t[None]
                bad = codes_agree(f"frame_step {who}", (one(sk), one(ak)), (one(sr), one(ar)),
                                  one(hidden), w, c, [seed], temp, [forbid])
                codes_agree(f"lt_sampler {who}", (one(s4), one(a4)), (one(sr), one(ar)),
                            one(hidden), w, c, [seed], temp, [forbid])
                flipped += len(bad)
                if not bad:
                    add("A", ((hk, hr), *zip(rows(kk, vk, pos), rows(kr, vr, pos))))
                add("5", ((h5, h5r), *zip(rows(k5, v5, pos), rows(k5r, v5r, pos))))
                log(f"{who}: frame_step codes {'differ (near-ties)' if bad else 'equal'}, "
                    f"lt_sampler codes checked; decoder_step max ulps "
                    f"{float(d['5'][-1].max()):.3f}, within 1 ulp "
                    f"{float((d['5'][-1] <= 1).float().mean()):.6f}")
        pos, temp, seed = positions[1], 0.7, 7
        codes = (torch.arange(c.num_codebooks, device=dev, dtype=torch.int32) * 37
                 ) % c.codebook_size
        emb = audio_frame_embedding(codes, w, c)
        for t in (0.0, 0.7):
            out = {}
            for name, weights, stream, plain in stream_variants(deq, q8, w, int8):
                fa = fs.frame_step_reference if plain else fs.frame_step
                f5 = ds.decode_step_reference if plain else ds.decode_step
                ka, va, k5, v5 = (k_base.clone(), v_base.clone(), k_base.clone(), v_base.clone())
                sa, aa, ha, _, _ = fa(hidden, pos, xa_k, xa_v, ka, va, weights, c, seed, t, 80,
                                      False, enc_length=enc, stream=stream)
                h5 = f5(emb, pos, xa_k, xa_v, k5, v5, weights, c, enc_length=enc, stream=stream)
                out[name] = (sa, aa, ha, ka, va, h5, k5, v5)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out["q8"], out["dense"])):
                raise AssertionError(f"bf16 frame_step / decoder_step: the Q8_0 stream differs "
                                     f"from dense on the bf16-dequantized weights (temp {t})")
            for m in ("q8", "int8"):
                got, want = out[m], out[m + "_plain"]
                bad = codes_agree(f"bf16 frame_step[{m}] temp {t}", (got[0][None], got[1][None]),
                                  (want[0][None], want[1][None]), hidden[None], w if m == "int8"
                                  else deq, c, [seed], t, [False])
                if not bad:
                    add(f"A_{m}", ((got[2], want[2]), (got[3][:, pos], want[3][:, pos]),
                                   (got[4][:, pos], want[4][:, pos])))
                add(f"5_{m}", ((got[5], want[5]), (got[6][:, pos], want[6][:, pos]),
                               (got[7][:, pos], want[7][:, pos])))
        log(f"bf16 streams at pos {pos}: Q8_0 bit-equal to dense on the bf16-dequantized "
            f"weights (frame_step, decoder_step, temp 0 / 0.7)")
        res = {}
        for key, pairs in d.items():
            if not pairs:
                raise AssertionError(f"bf16 {key}: no case compared")
            u = torch.cat(pairs)
            log(f"bf16 {key}: {u.numel()} floats vs plain, within 1 ulp "
                f"{float((u <= 1).float().mean()):.6f}, max {float(u.max()):.3f} ulps, max abs err "
                f"{err[key]:.3g}")
            if not ulp_ok(u):
                raise AssertionError(f"bf16 {key} disagrees with plain: {ulp_summary(u)}")
            res[key] = {"max_abs_err": err[key], **ulp_summary(u)}
        # Times at pos 300, temp 0.7 (the cache row is rewritten per call).
        kt, vt = k_base.clone(), v_base.clone()
        frame = (hidden, pos, xa_k, xa_v, kt, vt)
        step = (emb, pos, xa_k, xa_v, kt, vt)
        lt_args = (hidden, w, c, seed, temp, 80, False)
        runs = {"A": (lambda: fs.frame_step(*frame, w, c, seed, temp, 80, False, enc_length=enc),
                      lambda: fs.frame_step_reference(*frame, w, c, seed, temp, 80, False,
                                                      enc_length=enc)),
                "4": (lambda: lts.sample_frame_codes(*lt_args),
                      lambda: lts.sample_frame_codes_reference(*lt_args)),
                "5": (lambda: ds.decode_step(*step, w, c, enc_length=enc),
                      lambda: ds.decode_step_reference(*step, w, c, enc_length=enc))}
        for m, weights, stream in (("q8", deq, q8), ("int8", w, int8)):
            runs[f"A_{m}"] = (
                functools.partial(fs.frame_step, *frame, weights, c, seed, temp, 80, False,
                                  enc_length=enc, stream=stream),
                functools.partial(fs.frame_step_reference, *frame, weights, c, seed, temp, 80,
                                  False, enc_length=enc, stream=stream))
            runs[f"5_{m}"] = (
                functools.partial(ds.decode_step, *step, weights, c, enc_length=enc,
                                  stream=stream),
                functools.partial(ds.decode_step_reference, *step, weights, c, enc_length=enc,
                                  stream=stream))
        times = {k: (time_ms(f, reps=50), time_ms(p, reps=5)) for k, (f, p) in runs.items()}
    log("bf16 single-stream times at pos {} (temp 0.7), CUDA-event ms kernel / plain: ".format(pos)
        + "; ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in times.items()))
    lt_b, lt_f = lt_work(c, 1, elt=2)
    res["4"] = {"max_abs_err": 0.0}
    for key in res:
        ms, plain_ms = times[key]
        m = key.split("_")[1] if "_" in key else "dense"
        if key.startswith("A"):
            b, f = dec_work(c, [pos], [enc], input_rows=1, stream=m, elt=2)
            b, f = b + lt_b, f + lt_f
        elif key.startswith("5"):
            b, f = dec_work(c, [pos], [enc], stream=m, elt=2)
        else:
            b, f = lt_b, lt_f
        res[key].update(ms=ms, plain_ms=plain_ms, **bound(b, f, BF16_FLOPS_PER_S))
    res["temp07_code_flips"] = flipped
    return res


def check_bf16_batched(dev) -> dict:
    """Kernels C, 7 and 8 in bfloat16 against their plain versions at full
    width, B = 8 and 32 with ring masks (the last slot empty), write rows
    111 / 300 / 610, temperatures 0 / 0.7 (codes equal or near-ties; hidden
    and the new K/V rows of the live slots within ULP_SHARE / ULP_MAX bf16
    ulps); C and 8 with the weight streams at B = 8, row 300 (the Q8_0 stream
    bit-equal to dense on the bf16-dequantized weights, both streams against
    plain). CUDA-event times at B = 8, row 300 (C also at B = 32)."""
    import torch

    from magpie_tts_tpu_torch.models.magpie import audio_frame_embedding
    from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb

    c, w, _, _, _, k_base, v_base, _ = batched_state(dev, BF)
    q8, deq, int8 = bf16_streams(dev)
    rng = np.random.default_rng(5)
    rows_of = (c.context_frames + 1, c.max_seq // 2 - 20, c.max_seq - 30)
    d = {k: [] for k in ("C", "8", "C_q8", "8_q8", "C_int8", "8_int8")}
    err = dict.fromkeys(d, 0.0)
    flipped = 0

    def add(key, got, want, r, live):
        hk, kk, vk = got
        hr, kr, vr = want
        pairs = ((hk[live], hr[live]), (kk[live][:, :, r], kr[live][:, :, r]),
                 (vk[live][:, :, r], vr[live][:, :, r]))
        d[key].append(ulp_pairs(pairs))
        err[key] = max(err[key], max(float((a.float() - b.float()).abs().max()) for a, b in pairs))

    def step8(x, sampled, argmax, weights):
        """Kernel 8's inputs after a frame's codes: embedding + posemb, the
        write row valid as kernel C decides it."""
        r = x["write_row"]
        valid = x["valid"].clone()
        valid[:, r] = x["may_continue"] & ~_eos(sampled, argmax, c)
        return (audio_frame_embedding(sampled, weights, c) + x["posemb"], r, valid, x["xa_k"],
                x["xa_v"])

    def codes(who, got, want, x, temp, weights):
        return codes_agree(who, got, want, x["hidden"], weights, c, x["seeds"].tolist(), temp,
                           x["forbid_eos"].tolist())

    with torch.no_grad():
        for B in (8, BATCH_MAX):
            for r in rows_of:
                for temp in (0.0, 0.7):
                    x = batched_inputs(dev, B, r, rng, BF)
                    (kk, vk), (kr, vr), (k8, v8), (k8r, v8r) = [
                        (k_base[:B].clone(), v_base[:B].clone()) for _ in range(4)]
                    sk, ak, hk, _, _ = fsb.frame_step_batched(k_cache=kk, v_cache=vk,
                                                              temperature=temp, **x)
                    sr, ar, hr, _, _ = fsb.frame_step_batched_reference(
                        k_cache=kr, v_cache=vr, temperature=temp, **x)
                    s7, a7 = ltsb.sample_frame_codes_batched(x["hidden"], w, c, x["seeds"], temp,
                                                            80, x["forbid_eos"])
                    step = step8(x, sr, ar, w)
                    h8 = dsb.decode_step_batched(*step, k8, v8, w, c, x["enc_lengths"])
                    h8r = dsb.decode_step_batched_reference(*step, k8r, v8r, w, c,
                                                            x["enc_lengths"])
                    torch.cuda.synchronize()
                    who = f"bf16 B {B} row {r} temp {temp}"
                    bad = codes(f"frame_step_batched {who}", (sk, ak), (sr, ar), x, temp, w)
                    codes(f"lt_sampler_batched {who}", (s7, a7), (sr, ar), x, temp, w)
                    flipped += len(bad)
                    live = [b for b in range(B - 1) if b not in bad]
                    add("C", (hk, kk, vk), (hr, kr, vr), r, live)
                    add("8", (h8, k8, v8), (h8r, k8r, v8r), r, list(range(B - 1)))
                    log(f"{who}: frame_step_batched codes differing in slots {bad}; "
                        f"decoder_step_batched max ulps {float(d['8'][-1].max()):.3f}, "
                        f"within 1 ulp {float((d['8'][-1] <= 1).float().mean()):.6f}")
        r = rows_of[1]
        x = batched_inputs(dev, 8, r, rng, BF)
        fixed = (torch.arange(8 * c.num_codebooks, device=dev, dtype=torch.int32)
                 .reshape(8, -1) * 37) % c.codebook_size
        for temp in (0.0, 0.7):
            out = {}
            for name, weights, stream, plain in stream_variants(deq, q8, w, int8):
                fc = fsb.frame_step_batched_reference if plain else fsb.frame_step_batched
                f8 = dsb.decode_step_batched_reference if plain else dsb.decode_step_batched
                kc, vc, k8, v8 = k_base[:8].clone(), v_base[:8].clone(), k_base[:8].clone(), \
                    v_base[:8].clone()
                sc, ac, hc, _, _ = fc(k_cache=kc, v_cache=vc, temperature=temp, stream=stream,
                                      **dict(x, weights=weights))
                step = step8(x, fixed, fixed, weights)
                h8 = f8(*step, k8, v8, weights, c, x["enc_lengths"], stream=stream)
                out[name] = (sc, ac, hc, kc, vc, h8, k8, v8)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out["q8"], out["dense"])):
                raise AssertionError(f"bf16 frame_step_batched / decoder_step_batched: the Q8_0 "
                                     f"stream differs from dense on the bf16-dequantized weights")
            for m in ("q8", "int8"):
                got, want = out[m], out[m + "_plain"]
                bad = codes(f"bf16 frame_step_batched[{m}] temp {temp}", got[:2], want[:2], x,
                            temp, w if m == "int8" else deq)
                add(f"C_{m}", got[2:5], want[2:5], r, [b for b in range(7) if b not in bad])
                add(f"8_{m}", got[5:8], want[5:8], r, list(range(7)))
        log(f"bf16 batched streams at B 8 row {r}: Q8_0 bit-equal to dense on the "
            f"bf16-dequantized weights (frame_step_batched, decoder_step_batched)")
        res = {}
        for key, pairs in d.items():
            u = torch.cat(pairs)
            log(f"bf16 {key}: {u.numel()} floats vs plain (live slots), within 1 ulp "
                f"{float((u <= 1).float().mean()):.6f}, max {float(u.max()):.3f} ulps, max abs err "
                f"{err[key]:.3g}")
            if not ulp_ok(u):
                raise AssertionError(f"bf16 {key} disagrees with plain: {ulp_summary(u)}")
            res[key] = {"max_abs_err": err[key], **ulp_summary(u)}
        kt, vt = k_base[:8].clone(), v_base[:8].clone()
        sample = (x["hidden"], w, c, x["seeds"], 0.7, 80, x["forbid_eos"])
        runs = {"7": (lambda: ltsb.sample_frame_codes_batched(*sample),
                      lambda: ltsb.sample_frame_codes_batched_reference(*sample))}
        for m, weights, stream in (("", w, None), ("_q8", deq, q8), ("_int8", w, int8)):
            args = dict(x, weights=weights, k_cache=kt, v_cache=vt, temperature=0.7,
                        stream=stream)
            step = step8(x, fixed, fixed, weights)
            runs["C" + m] = (functools.partial(fsb.frame_step_batched, **args),
                             functools.partial(fsb.frame_step_batched_reference, **args))
            runs["8" + m] = (
                functools.partial(dsb.decode_step_batched, *step, kt, vt, weights, c,
                                  x["enc_lengths"], stream=stream),
                functools.partial(dsb.decode_step_batched_reference, *step, kt, vt, weights, c,
                                  x["enc_lengths"], stream=stream))
        times = {k: (time_ms(f, reps=30), time_ms(p, reps=3, warmup=1))
                 for k, (f, p) in runs.items()}
        x32 = batched_inputs(dev, BATCH_MAX, r, rng, BF)
        k32, v32 = k_base.clone(), v_base.clone()
        ms_b32 = time_ms(lambda: fsb.frame_step_batched(k_cache=k32, v_cache=v32,
                                                        temperature=0.7, **x32), reps=30)
    log(f"bf16 batched times at B 8 row {r} (temp 0.7), CUDA-event ms kernel / plain: " +
        "; ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in times.items()) +
        f"; frame_step_batched B={BATCH_MAX} {ms_b32:.4f}")
    lt_b, lt_f = lt_work(c, 8, elt=2)
    res["7"] = {"max_abs_err": 0.0}
    valid_c = x["valid"].sum(-1).tolist()
    valid_8 = step8(x, fixed, fixed, w)[2].sum(-1).tolist()
    for key in res:
        ms, plain_ms = times[key]
        m = key.split("_")[1] if "_" in key else "dense"
        if key.startswith("C"):
            b, f = dec_work(c, valid_c, x["enc_lengths"].tolist(), input_rows=1, stream=m, elt=2)
            b, f = b + lt_b, f + lt_f
        elif key.startswith("8"):
            b, f = dec_work(c, valid_8, x["enc_lengths"].tolist(), input_rows=1, stream=m, elt=2)
            b += 8 * c.max_seq
        else:
            b, f = lt_b, lt_f
        res[key].update(ms=ms, plain_ms=plain_ms, **bound(b, f, BF16_FLOPS_PER_S))
    res["C"]["ms_b32"] = ms_b32
    res["temp07_code_flips"] = flipped
    return res


PERSIST_N = (2, 8, 3)        # graph slopes of A and 5: frames a graph, lo / hi, replays
BARRIER_COUNTS = (16, 272)   # the barrier probe: barriers a launch, lo / hi


def barrier_cost(dev, n=PERSIST_N) -> dict:
    """us a grid barrier of the persistent kernels: graph slopes of the
    barrier probe (frame_step.barrier_probe) at BARRIER_COUNTS barriers a
    launch, at one block an SM (the frame kernels' grid) and at two."""
    import torch

    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.scripts import timing

    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lo, hi = BARRIER_COUNTS
    out = {}
    for grid in (sms, 2 * sms):
        ms = {}
        for count in (lo, hi):
            def body(i, h, count=count, grid=grid):
                fs.barrier_probe(bar, count, grid)
                return h
            ms[count] = timing.graph_slope(body, bar, *n)["per_launch_ms"]
        out[f"us_per_barrier_grid{grid}"] = (ms[hi] - ms[lo]) * 1e3 / (hi - lo)
    return out


def persistent_bodies(dev, dtype: str, row: int = 300, enc: int = SINGLE_ENC) -> dict:
    """One frame of kernels A and 5 at B = 1 and row ``row`` as graph-slope
    bodies (the hidden row carried), and their library composites, timed
    only: cuBLAS ``torch.matmul`` on the frame's products in order (5: the
    decoder's 72; A adds the LT's 48) and SDPA on its attentions (12
    self-attentions over row + 1 cache rows, 12 cross-attentions over enc
    rows; A adds the LT's 8)."""
    import torch
    import torch.nn.functional as F

    from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs

    c, w, xa_k, xa_v, hidden, k_base, v_base, _ = single_state(dev, dtype)
    T = k_base.dtype
    kc, vc = k_base.clone(), v_base.clone()
    L, D, X, LT, H, V = c.dec_layers, c.d_model, c.d_xa, c.lt_dim, c.dec_sa_heads, c.vocab_per_cb
    dh, rows = D // H, row + 1
    dec, lt = w.decoder, w.lt
    gen = torch.Generator(device=dev).manual_seed(row)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(T)
    dec_seq = [getattr(dec, n)[l] for l in range(L)
               for n in ("qkv", "sa_out", "xa_q", "xa_out", "ff_proj", "ff_out")]
    lt_seq = [m for cb in range(c.num_codebooks)
              for m in (lt.in_proj_w, lt.qkv, lt.sa_out, lt.ff_proj, lt.ff_out,
                        lt.out_proj_w[cb])]
    xs = {id(m): randn(1, m.shape[0]) for m in dec_seq + lt_seq}
    heads = lambda t, n, h: t.reshape(1, n, h, -1).transpose(1, 2)
    q_sa, q_xa = randn(1, H, 1, dh), randn(1, 1, 1, X)
    k_lt, v_lt, q_lt = randn(c.num_codebooks, LT), randn(c.num_codebooks, LT), randn(1, 1, 1, LT)

    def library(fused: bool):
        def body(i, h):
            for m in (lt_seq if fused else []) + dec_seq:
                torch.matmul(xs[id(m)], m)
            for l in range(L):
                F.scaled_dot_product_attention(q_sa, heads(kc[l, :rows], rows, H),
                                               heads(vc[l, :rows], rows, H))
                F.scaled_dot_product_attention(q_xa, heads(xa_k[l, :enc], enc, 1),
                                               heads(xa_v[l, :enc], enc, 1))
            if fused:
                for cb in range(c.num_codebooks):
                    F.scaled_dot_product_attention(q_lt, heads(k_lt[:cb + 1], cb + 1, 1),
                                                   heads(v_lt[:cb + 1], cb + 1, 1))
            return h
        return body

    def a_body(i, h):
        return fs.frame_step(h, row, xa_k, xa_v, kc, vc, w, c, i, 0.7, 80, False,
                             enc_length=enc)[2]

    def five_body(i, h):
        return ds.decode_step(h, row, xa_k, xa_v, kc, vc, w, c, enc_length=enc)

    return {"A": a_body, "5": five_body, "A.library": library(True),
            "5.library": library(False)}, hidden


def time_persistent(dev) -> dict:
    """Kernels A and 5 by CUDA-graph slope at B = 1, row 300, dense, in both
    dtypes, in turns with their library composites (persistent_bodies); the
    barrier probe's us a barrier. Returns {dtype: {"A" / "5": {graph_ms,
    library_ms}}, "barrier": {...}} and logs each."""
    import torch

    from magpie_tts_tpu_torch.scripts import timing

    out = {}
    with torch.no_grad():
        for dtype in ("float32", BF):
            bodies, hidden = persistent_bodies(dev, dtype)
            t = {}
            for _ in range(2):   # in turns: kernel, library, library, kernel
                for k in ("A", "A.library", "5", "5.library"):
                    t.setdefault(k, []).append(
                        timing.graph_slope(bodies[k], hidden, *PERSIST_N)["per_launch_ms"])
            out[dtype] = {k: {"graph_ms": min(t[k]), "library_ms": min(t[f"{k}.library"])}
                          for k in ("A", "5")}
            log(f"persistent [{dtype}] (graph slopes a frame, B 1, row 300): kernel A "
                f"{out[dtype]['A']['graph_ms']:.4f} ms (library composite "
                f"{out[dtype]['A']['library_ms']:.4f}), kernel 5 "
                f"{out[dtype]['5']['graph_ms']:.4f} ms (library composite "
                f"{out[dtype]['5']['library_ms']:.4f})")
            del bodies
            torch.cuda.empty_cache()
        out["barrier"] = barrier_cost(dev)
    log(f"barrier probe: " + ", ".join(f"{k} {v:.4f}" for k, v in out["barrier"].items()))
    return out


LT_B = (8, 32, 64)            # kernel 7's graph slopes: slots


def time_lt_launch(dev) -> dict:
    """The LT samplers by CUDA-graph slope at 357M, dense, both dtypes, temp
    0.7: kernel 4 at B = 1 (and at temp 0: the difference over the 8
    codebooks is the draw's top-k and Gumbel passes, ``draw_us``), kernel 7
    at LT_B slots. Returns {dtype: {"4": ..., "7": {B: ...}}} and logs each."""
    import torch

    from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
    from magpie_tts_tpu_torch.scripts import timing

    out = {}
    with torch.no_grad():
        for dtype in ("float32", BF):
            c, w = prod_weights(dev, dtype)
            gen = torch.Generator(device=dev).manual_seed(12)
            hidden = torch.randn(max(LT_B), c.d_model, generator=gen, device=dev).to(
                w.decoder.qkv.dtype)
            seeds = torch.arange(max(LT_B), dtype=torch.int32, device=dev)
            forbid = torch.zeros(max(LT_B), dtype=torch.bool, device=dev)

            def four(temp):
                def body(i, h):
                    lts.sample_frame_codes(h, w, c, i, temp, 80, False)
                    return h
                return body

            def seven(B):
                def body(i, h):
                    ltsb.sample_frame_codes_batched(h, w, c, seeds[:B], 0.7, 80, forbid[:B])
                    return h
                return body

            t07 = timing.graph_slope(four(0.7), hidden[0], *PERSIST_N)["per_launch_ms"]
            t0 = timing.graph_slope(four(0.0), hidden[0], *PERSIST_N)["per_launch_ms"]
            res = {"4": {"graph_ms": t07, "graph_ms_temp0": t0,
                         "draw_us": (t07 - t0) * 1e3 / c.num_codebooks}, "7": {}}
            for B in LT_B:
                ms = timing.graph_slope(seven(B), hidden[:B].contiguous(), *PERSIST_N)
                res["7"][B] = {"graph_ms": ms["per_launch_ms"]}
            out[dtype] = res
            log(f"LT samplers [{dtype}] (graph slopes a frame, temp 0.7): kernel 4 B 1 "
                f"{t07:.4f} ms (temp 0 {t0:.4f}; the draw {res['4']['draw_us']:.2f} us a "
                f"codebook); kernel 7 " + ", ".join(
                    f"B {B} {res['7'][B]['graph_ms']:.4f} ms" for B in LT_B))
    return out


def count_lt_device_kernels(dev) -> dict:
    """One frame of kernel 4 (B = 1), kernel 7 (B = 8) and kernel C (B = 8)
    at 357M, each traced alone by torch.profiler: kernel 4 is one device
    kernel (the persistent LT launch) beside the fill that zeroes its
    barrier count, and none of the LT launch sequence's kernels; 7 and C
    run that sequence (frame_sequence.cuh lt_phases), and their device
    kernels a frame are counted."""
    import torch

    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb

    x = batched_inputs(dev, 8, 300, np.random.default_rng(8))
    c, w = x["config"], x["weights"]
    _, _, _, _, _, k_base, v_base, _ = batched_state(dev)
    kc, vc = k_base[:8].clone(), v_base[:8].clone()
    runs = {"4": lambda: lts.sample_frame_codes(x["hidden"][0], w, c, 3, 0.7, 80, False),
            "7": lambda: ltsb.sample_frame_codes_batched(x["hidden"], w, c, x["seeds"], 0.7, 80,
                                                         x["forbid_eos"]),
            "C": lambda: fsb.frame_step_batched(k_cache=kc, v_cache=vc, temperature=0.7, **x)}
    out = {}
    with torch.no_grad():
        for name, run in runs.items():
            run()
            torch.cuda.synchronize()
            with device_trace() as prof:
                run()
                torch.cuda.synchronize()
            kernels = count_device_kernels(prof)
            lt = sum(n for k, n in kernels.items() if "lt_persistent_kernel" in k)
            seq = sum(n for k, n in kernels.items() if any(o in k for o in OLD_SEQUENCE))
            fills = sum(n for k, n in kernels.items() if "ill" in k or "emset" in k)
            out[name] = {"device_kernels": sum(kernels.values()) - fills, "fills": fills,
                         "lt_launches": lt, "sequence_kernels": seq}
    log("device kernels a frame (profiler): " + "; ".join(
        f"{k}: {v['device_kernels']} in all (and {v['fills']} fill / memset), persistent LT "
        f"launch {v['lt_launches']}, LT sequence kernels {v['sequence_kernels']}"
        for k, v in out.items()))
    four = out["4"]
    if four["lt_launches"] != 1 or four["device_kernels"] != 1 or four["sequence_kernels"]:
        raise AssertionError(f"kernel 4: {four} (want one persistent launch a frame)")
    return out


FAMILY_B = (8, 32)           # the family slopes: slots, and the rows attended
FAMILY_ROWS = (300, 630)


def family_bodies(dev, dtype: str, B: int, rows: int) -> dict:
    """Zero-argument functions, each one family's work in one frame of
    kernels C / 8 at B slots and ``rows`` attended rows: the 12 layers'
    self-attention (``sa``) and cross-attention (``xa``, each slot's
    enc_lengths rows of BATCH_ENC) and the 8 LT phases' attention (``lt``),
    through the frame kernels' attention alone; the decoder's matrix
    products in the frame's order (``gemm.dec``: per layer qkv, sa_out, xa_q,
    xa_out, ff_proj, ff_out, 12 layers, every weight read from device memory
    as in a frame: 349 MB in float32 do not fit the 50 MB L2) and the LT's 8
    phases (``gemm.lt``) through the batched GEMM alone; and the yardsticks,
    timed only: SDPA on the same caches with boolean masks (``sdpa.sa``,
    ``sdpa.xa``) and cuBLAS ``torch.matmul`` on the same weights in the same
    order (``matmul.dec``). Returns (bodies, {body: (bytes, flops)} for the
    bounds)."""
    import torch
    import torch.nn.functional as F

    from magpie_tts_tpu_torch.ops.attention import attn_scale
    from magpie_tts_tpu_torch.ops.kernels import batched_gemm as bg
    from magpie_tts_tpu_torch.ops.kernels import decode_attention as da

    c, w, hidden, xa_k, xa_v, k_base, v_base, enc = batched_state(dev, dtype)
    T = k_base.dtype
    elt = F32 if dtype == "float32" else BF16
    L, S, D, X, LT, H = c.dec_layers, c.max_seq, c.d_model, c.d_xa, c.lt_dim, c.dec_sa_heads
    dh, E = D // H, xa_k.shape[2]
    gen = torch.Generator(device=dev).manual_seed(B + rows)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    rng = np.random.default_rng(rows)
    valid = torch.tensor(_ring_valid(B, S, rows - 1, rng), device=dev)
    valid[:, rows:] = False
    new_valid = torch.ones(B, dtype=torch.int32, device=dev)
    enc_b = torch.tensor(enc[:B], dtype=torch.int32, device=dev)
    q, q_lt = randn(B, D), randn(B, LT)
    q_xa = randn(bg.plan_gemm(D, X).splits, B, X) * 0.2
    k_lt, v_lt = randn(B, c.num_codebooks, LT).to(T), randn(B, c.num_codebooks, LT).to(T)
    bodies = {
        "sa": lambda: [da.decode_attention(q, k_base[:B, l], v_base[:B, l], H, attn_scale(dh),
                                           rows=rows, valid=valid, write_row=rows - 1,
                                           new_valid=new_valid) for l in range(L)],
        "xa": lambda: [da.decode_attention(q_xa, xa_k[:B, l], xa_v[:B, l], c.dec_xa_heads,
                                           attn_scale(X), rows=E, rows_dev=enc_b)
                       for l in range(L)],
        "lt": lambda: [da.decode_attention(q_lt, k_lt, v_lt, 1, attn_scale(LT), rows=cb + 1)
                       for cb in range(c.num_codebooks)]}
    mask_sa = valid[:, None, None, :rows]
    mask_xa = (torch.arange(E, device=dev)[None, :] < enc_b[:, None])[:, None, None, :]
    qh, qx = q.to(T).view(B, H, 1, dh), q_xa.sum(0).to(T).view(B, 1, 1, X)
    heads = lambda t, n, h: t.reshape(B, n, h, -1).transpose(1, 2)
    bodies["sdpa.sa"] = lambda: [F.scaled_dot_product_attention(
        qh, heads(k_base[:B, l, :rows], rows, H), heads(v_base[:B, l, :rows], rows, H),
        attn_mask=mask_sa) for l in range(L)]
    bodies["sdpa.xa"] = lambda: [F.scaled_dot_product_attention(
        qx, heads(xa_k[:B, l], E, 1), heads(xa_v[:B, l], E, 1), attn_mask=mask_xa)
        for l in range(L)]
    dec, lt = w.decoder, w.lt
    shapes = bg.frame_products(c)
    dec_names = ("qkv", "sa_out", "xa_q", "xa_out", "ff_proj", "ff_out")
    lt_names = ("lt_in", "lt_qkv", "lt_sa_out", "lt_ff_proj", "lt_ff_out", "lt_out")
    xs = {name: randn(B, K) for name, (K, _) in shapes.items()}
    dec_seq = [(name, getattr(dec, name)[l]) for l in range(L) for name in dec_names]
    lt_w = {"lt_in": lt.in_proj_w, "lt_qkv": lt.qkv, "lt_sa_out": lt.sa_out,
            "lt_ff_proj": lt.ff_proj, "lt_ff_out": lt.ff_out}
    lt_seq = [(name, lt_w[name] if name != "lt_out" else lt.out_proj_w[cb])
              for cb in range(c.num_codebooks) for name in lt_names]
    run = lambda seq: [bg.batched_gemm(xs[n], *shapes[n], w=wt) for n, wt in seq]
    bodies["gemm.dec"] = lambda: run(dec_seq)
    bodies["gemm.lt"] = lambda: run(lt_seq)
    xs_t = {name: x.to(T) for name, x in xs.items()}
    bodies["matmul.dec"] = lambda: [torch.matmul(xs_t[n], wt) for n, wt in dec_seq]
    enc_rows = sum(enc[:B])
    work = {"sa": (L * 2 * B * rows * D * elt, L * 4 * B * rows * D),
            "xa": (L * 2 * enc_rows * X * elt, L * 4 * enc_rows * X),
            "lt": (sum(2 * B * (cb + 1) * LT * elt for cb in range(8)),
                   sum(4 * B * (cb + 1) * LT for cb in range(8)))}
    io = lambda seq: sum(B * sum(shapes[n]) * F32 for n, _ in seq)
    flops = lambda seq: sum(2 * B * shapes[n][0] * shapes[n][1] for n, _ in seq)
    lt_weights = sum(shapes[n][0] * shapes[n][1] for n in lt_names[:-1]) + \
        c.num_codebooks * shapes["lt_out"][0] * shapes["lt_out"][1]
    work["gemm.dec"] = (sum(wt.numel() for _, wt in dec_seq) * elt + io(dec_seq),
                        flops(dec_seq))
    work["gemm.lt"] = (lt_weights * elt + io(lt_seq), flops(lt_seq))
    return bodies, work


def time_families(dev) -> dict:
    """The attention and GEMM families of kernels C and 8, by CUDA-graph
    slope (CODEC_SLOPE_N, in turns) at FAMILY_B slots x FAMILY_ROWS rows in
    both dtypes, beside their yardsticks (SDPA, cuBLAS) and bounds. Kernel 8's
    attention family is the 12 layers' self- and cross-attention, kernel C's
    adds the LT's 8; its GEMM family the decoder's 6 classes x 12 layers, C's
    adds the LT's 6 x 8. Returns {dtype: {(B, rows): {kernel: {family:
    {ms, bound_ms, bound_by, library_ms}}}}} and logs each."""
    import torch

    out = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        for dtype in ("float32", BF):
            out[dtype] = {}
            gemm_ms = {}
            for B in FAMILY_B:
                for rows in FAMILY_ROWS:
                    bodies, work = family_bodies(dev, dtype, B, rows)
                    keys = [k for k in bodies if rows == FAMILY_ROWS[0]
                            or not k.startswith(("gemm.", "matmul."))]
                    t = slope_in_turns({k: bodies[k] for k in keys})
                    if rows == FAMILY_ROWS[0]:
                        gemm_ms[B] = {k: v for k, v in t.items()
                                      if k.startswith(("gemm.", "matmul."))}
                    t.update(gemm_ms[B])
                    rate = FP32_FLOPS_PER_S if dtype == "float32" else BF16_FLOPS_PER_S
                    fam = {}
                    for kernel, lt in (("8", False), ("C", True)):
                        att = ["sa", "xa"] + (["lt"] if lt else [])
                        gem = ["gemm.dec"] + (["gemm.lt"] if lt else [])
                        nb = sum(work[k][0] for k in att)
                        nf = sum(work[k][1] for k in att)
                        gb = sum(work[k][0] for k in gem)
                        gf = sum(work[k][1] for k in gem)
                        fam[kernel] = {
                            "attention": {"ms": sum(t[k] for k in att), **bound(nb, nf, rate),
                                          "library_ms": t["sdpa.sa"] + t["sdpa.xa"],
                                          "parts_ms": {k: t[k] for k in att}},
                            "gemm": {"ms": sum(t[k] for k in gem), **codec_bound(gb, gf, dtype),
                                     "library_ms": t["matmul.dec"],
                                     "library_covers": "the decoder's 72 products",
                                     "parts_ms": {k: t[k] for k in gem}}}
                    out[dtype][B, rows] = fam
                    for kernel in ("C", "8"):
                        a, g = fam[kernel]["attention"], fam[kernel]["gemm"]
                        log(f"families [{dtype}] kernel {kernel}, B {B}, rows {rows} (graph "
                            f"slopes a frame): attention {a['ms']:.4f} ms (bound "
                            f"{a['bound_ms']:.4f}, SDPA {a['library_ms']:.4f}; parts "
                            f"{ {k: round(v, 4) for k, v in a['parts_ms'].items()} }), GEMM "
                            f"{g['ms']:.4f} ms (bound {g['bound_ms']:.4f}, cuBLAS decoder "
                            f"products {g['library_ms']:.4f}; parts "
                            f"{ {k: round(v, 4) for k, v in g['parts_ms'].items()} })")
                    del bodies
            torch.cuda.empty_cache()
    log(f"family slopes: {time.perf_counter() - t0:.1f} s")
    return out


def family_summary(fam: dict, kernel: str) -> dict:
    """A kernel row's ``families`` entry: per (B, rows) and family, its ms,
    bound and library ms."""
    return {f"B{B}_rows{rows}": {name: {k: v for k, v in f.items() if k != "parts_ms"}
                                  for name, f in per[kernel].items()}
            for (B, rows), per in fam.items()}


def check_batch_invariance(dev, dtype: str) -> dict:
    """Kernels C and 8 at 357M: slots 0..2's codes, hidden rows and new
    cache rows are bit-equal whether they run at B = 3, 8 or 32."""
    import torch

    from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb

    c, w, _, _, _, k_base, v_base, _ = batched_state(dev, dtype)
    write_row = c.max_seq // 2 - 20
    full = batched_inputs(dev, BATCH_MAX, write_row, np.random.default_rng(9), dtype)
    runs = []
    with torch.no_grad():
        for B in (3, 8, BATCH_MAX):
            x = {k: (v[:B].contiguous() if isinstance(v, torch.Tensor) else v)
                 for k, v in full.items()}
            kc, vc, k8, v8 = (t[:B].clone() for t in (k_base, v_base, k_base, v_base))
            s, a, h, _, _ = fsb.frame_step_batched(k_cache=kc, v_cache=vc, temperature=0.7, **x)
            valid8 = x["valid"].clone()
            valid8[:, write_row] = True
            h8 = dsb.decode_step_batched(x["hidden"], write_row, valid8, x["xa_k"], x["xa_v"],
                                         k8, v8, w, c, x["enc_lengths"])
            runs.append((s[:3], a[:3], h[:3], kc[:3, :, write_row], vc[:3, :, write_row],
                         h8[:3], k8[:3, :, write_row], v8[:3, :, write_row]))
    torch.cuda.synchronize()
    same = all(torch.equal(p, q) for other in runs[1:] for p, q in zip(runs[0], other))
    log(f"batch invariance [{dtype}]: slots 0..2 of kernels C and 8 bit-equal at B = 3, 8, "
        f"{BATCH_MAX}: {same}")
    if not same:
        raise AssertionError(f"kernel C / 8 [{dtype}]: a slot's result depends on the batch")
    return {"bit_equal": same}


def write_ggufs(tmp: Path):
    """Production-width random GGUFs (max_dec_steps cut to 128 frames)."""
    from magpie_tts_tpu_torch.config import CodecConfig, MagpieConfig

    mcfg = dataclasses.replace(MagpieConfig(), max_dec_steps=128)
    ccfg = CodecConfig()
    t0 = time.perf_counter()
    write_model_gguf(str(tmp / "magpie.gguf"), mcfg, seed=0)
    write_codec_gguf(str(tmp / "codec.gguf"), ccfg, seed=1)
    t1 = time.perf_counter()
    write_model_gguf(str(tmp / "magpie_q8.gguf"), mcfg, seed=0, quant="q8_0")
    log(f"wrote production-width GGUFs in {t1 - t0:.1f} s, the Q8_0 model GGUF (the "
        f"converter's allowlist quantized in numpy) in {time.perf_counter() - t1:.1f} s")
    return mcfg, ccfg


Q8_SLOPE_N = (2, 8)  # kernel 10's graph slopes: dequants a graph, lo / hi


def check_q8_dequant(tmp: Path, dev, dtype: str = "float32") -> dict:
    """Kernel 10 for every block-stored tensor of the production-width Q8_0
    GGUF (``load_magpie_weights(q8_native=True)``), writing ``dtype``: bit
    for bit against its plain version on the card and against the dense load
    of the same file cast to ``dtype``; times summed over the tensors (one
    program entry's materialize): ``ms`` by CUDA-graph slope (the device
    time), ``event_ms`` the CUDA-event mean of eager calls (with the host's
    enqueue)."""
    import torch

    from magpie_tts_tpu_torch.io.magpie_weights import load_magpie_weights, q8_blocks
    from magpie_tts_tpu_torch.ops.kernels import q8_dequant
    from magpie_tts_tpu_torch.scripts import timing

    path = str(tmp / "magpie_q8.gguf")
    _, native = load_magpie_weights(path, q8_native=True)
    _, dense = load_magpie_weights(path)
    found = q8_blocks(native)
    dt = getattr(torch, dtype)
    total = {"ms": 0.0, "event_ms": 0.0, "plain_ms": 0.0}
    nbytes = 0
    with torch.no_grad():
        for name, blk in found.items():
            blk = blk.to(dev)
            want = dense
            for part in name.split("."):
                want = getattr(want, part)
            want = want.to(device=dev, dtype=dt)
            args = (blk.q, blk.s, blk.torch_shape, blk.transform, dt)
            got = q8_dequant.dequantize(*args)
            plain = q8_dequant.dequantize_reference(*args)
            torch.cuda.synchronize()
            if not (torch.equal(got, plain) and torch.equal(got, want)):
                raise AssertionError(f"q8 dequant of {name} {blk.torch_shape} ({blk.transform}) "
                                     f"differs from plain or from the dense load")
            body = lambda i, h, args=args: (q8_dequant.dequantize(*args), h)[1]
            total["ms"] += timing.graph_slope(body, blk.q, *Q8_SLOPE_N)["per_launch_ms"]
            total["event_ms"] += time_ms(lambda: q8_dequant.dequantize(*args), reps=10)
            total["plain_ms"] += time_ms(lambda: q8_dequant.dequantize_reference(*args), reps=5)
            nbytes += blk.q.numel() + F32 * blk.s.numel() + got.element_size() * got.numel()
            log(f"q8_dequant[{dtype}] {name} {tuple(blk.q.shape)} -> {tuple(got.shape)} "
                f"({blk.transform}): equal to plain and to the dense load bit for bit")
    log(f"q8_dequant[{dtype}]: {len(found)} block-stored tensors, {nbytes / 1e6:.1f} MB moved: "
        f"kernel {total['ms']:.4f} ms by graph slope (event mean {total['event_ms']:.4f}), "
        f"plain {total['plain_ms']:.4f} ms per materialize")
    return {"max_abs_err": 0.0, **total, "nodes": len(found), **bound(nbytes, 0)}


def check_dtype_launches(kernels, dtype: str, who: str) -> None:
    """Every launch of each kernel module was in ``dtype``: no float32 kernel
    ran on a bfloat16 path, nor the other way round."""
    for k in kernels:
        if k.dtype_launches[dtype] != k.launches or sum(k.dtype_launches.values()) != k.launches:
            raise AssertionError(f"{who}: {k.__name__} launches {k.launches}, by dtype "
                                 f"{k.dtype_launches}, want all {dtype}")


@contextlib.contextmanager
def fused_codec_env(on: bool):
    """MAGPIE_FUSED_CODEC=1 inside the block when ``on`` (kernel 9 for the res
    layers of <= 128 channels); unset otherwise and afterwards."""
    if os.environ.get("MAGPIE_FUSED_CODEC"):
        raise AssertionError("MAGPIE_FUSED_CODEC is set outside a fused-codec phase")
    if on:
        os.environ["MAGPIE_FUSED_CODEC"] = "1"
    try:
        yield
    finally:
        os.environ.pop("MAGPIE_FUSED_CODEC", None)


@contextlib.contextmanager
def recording_decodes(record: list):
    """Append the codes of every ``CodecEngine.decode`` call to ``record``."""
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine

    real = CodecEngine.decode

    def decode(self, codes, *a, **k):
        record.append(np.array(codes))
        return real(self, codes, *a, **k)

    CodecEngine.decode = decode
    try:
        yield
    finally:
        CodecEngine.decode = real


# The launch sequence's kernels that kernels A and 5 ran before their
# persistent redesign (kernels 4, C, 7 and 8 still run them).
OLD_SEQUENCE = ("gemv_splitk_kernel", "combine_ln_kernel", "reduce_act_kernel",
                "qkv_scatter_kernel", "lt_sample_kernel", "decoder_input_kernel",
                "attention_scores_kernel", "attention_pv_kernel")


@contextlib.contextmanager
def device_trace():
    """torch.profiler over the block, CPU and CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def count_device_kernels(prof) -> dict:
    """{device kernel name: launches} of a finished trace (user annotations,
    the device copies of ``record_function`` spans, left out)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def reset_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0
        k.dtype_launches = dict.fromkeys(k.dtype_launches, 0)
        if hasattr(k, "mode_launches"):
            k.mode_launches = dict.fromkeys(k.mode_launches, 0)


def run_main_path(tmp: Path, mcfg, ccfg, card: str, split: bool = False,
                  model: str = "magpie.gguf", flags=(), temp: float = 0.7,
                  q8_nodes: int = 0, dtype: str = "float32",
                  fused_codec: bool = False, count_kernels: bool = False) -> dict:
    """cli.main at full width on random GGUFs with ``--dtype dtype``; checks
    the WAV and launch counts: kernel A once per loop step, or with ``split``
    (``--no-fused``) kernels 4 and 5 once per step and kernel A never; every
    launch in the weight stream that ``flags`` ask for (``--serve-q8`` /
    ``--serve-int8``, else dense) and in ``dtype``, and with ``--serve-q8``
    kernel 10 once for each of the ``q8_nodes`` block-stored tensors; codec
    conv 92 per decode, or with ``fused_codec`` (MAGPIE_FUSED_CODEC=1) 38 and
    kernel 9 three times. With ``count_kernels`` the run is traced by
    torch.profiler and its device kernels counted by name: the persistent
    kernel (A, or 5 with ``split``) once a step, kernel 4's persistent LT
    launch once a step with ``split`` and never without, none of the launch
    sequence's kernels that A, 4 and 5 ran before their redesigns. Returns
    the counts, frames/s, the WAV's bytes and the codes the codec decoded."""
    from magpie_tts_tpu_torch import cli
    from magpie_tts_tpu_torch.io.wav import read_wav
    from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
    from magpie_tts_tpu_torch.ops.kernels import codec_res_fused as crf
    from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts
    from magpie_tts_tpu_torch.ops.kernels import q8_dequant

    hop = ccfg.hop_length
    mode = "q8" if "--serve-q8" in flags else "int8" if "--serve-int8" in flags else "dense"
    tag = " ".join([model, *flags, *(["--no-fused"] if split else []), f"--temp {temp}",
                    f"--dtype {dtype}", *(["MAGPIE_FUSED_CODEC=1"] if fused_codec else [])])
    out = tmp / (tag.replace(" ", "_").replace("-", "").replace("=", "") + ".wav")
    argv = ["-m", str(tmp / model), "-c", str(tmp / "codec.gguf"),
            "-t", "hello world", "-o", str(out), "--device", "cuda", "--dtype", dtype,
            "--temp", str(temp), "--seed", "0", *flags] + (["--no-fused"] if split else [])
    err = io.StringIO()
    kernels = (fs, lts, ds, cc, q8_dequant, crf)
    reset_counts(kernels)
    decoded = []
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stderr(err))
        stack.enter_context(fused_codec_env(fused_codec))
        stack.enter_context(recording_decodes(decoded))
        prof = stack.enter_context(device_trace()) if count_kernels else None
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    frame_launches, lt_launches, dec_launches, conv_launches, deq_launches, res_launches = (
        k.launches for k in kernels)
    by_mode = {"frame_step": dict(fs.mode_launches), "decoder_step": dict(ds.mode_launches)}
    log(err.getvalue().rstrip())
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc} ({tag})")
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
                             f"({tag})")
    stream_kernel = "decoder_step" if split else "frame_step"
    if by_mode[stream_kernel][mode] != want_steps:
        raise AssertionError(f"{stream_kernel} launched {by_mode[stream_kernel]} by weight "
                             f"stream, want {want_steps} {mode} ({tag})")
    device_kernels = {}
    if prof is not None:
        device_kernels = count_device_kernels(prof)
        persistent = sum(n for k, n in device_kernels.items() if "frame_persistent_kernel" in k)
        old_seq = sum(n for k, n in device_kernels.items() if any(o in k for o in OLD_SEQUENCE))
        lt = sum(n for k, n in device_kernels.items() if "lt_persistent_kernel" in k)
        log(f"device kernels of {tag} (profiler): persistent {persistent} for {want_steps} "
            f"steps, LT launches {lt}, launch-sequence kernels {old_seq}; fill / memset "
            f"{sum(n for k, n in device_kernels.items() if 'ill' in k or 'emset' in k)}")
        if persistent != want_steps or old_seq or lt != (want_steps if split else 0):
            raise AssertionError(f"{tag}: the persistent kernel ran {persistent}x and the LT "
                                 f"launch {lt}x for {want_steps} steps (launch-sequence "
                                 f"kernels {old_seq})")
    want_codec = (38, 3) if fused_codec else (92, 0)
    if len(decoded) != 1 or (conv_launches, res_launches) != want_codec:
        raise AssertionError(f"codec conv / kernel 9 launched {conv_launches} / {res_launches}x "
                             f"for {len(decoded)} decodes, want {want_codec} per decode ({tag})")
    if deq_launches != (q8_nodes if mode == "q8" else 0):
        raise AssertionError(f"q8 dequant launched {deq_launches}x, want "
                             f"{q8_nodes if mode == 'q8' else 0} ({tag})")
    check_dtype_launches(kernels, dtype, tag)
    m = re.search(r"in ([0-9.]+)s \(([0-9.]+) fps", err.getvalue())
    synth_s, fps = (float(m.group(1)), float(m.group(2))) if m else (float("nan"),) * 2
    log(f"main path {tag}: {n_frames} frames, {len(samples)} samples, frame_step / lt_sampler / "
        f"decoder_step launches {frame_launches} / {lt_launches} / {dec_launches} (all "
        f"{mode}, all {dtype}), conv launches {conv_launches}, res_layer_fused launches "
        f"{res_launches}, q8_dequant launches {deq_launches}, synth {synth_s} s = {fps} fps "
        f"(cli.main wall {wall:.2f} s incl. load) on {card}")
    return {"frame_launches": frame_launches, "lt_launches": lt_launches,
            "dec_launches": dec_launches, "conv_launches": conv_launches,
            "deq_launches": deq_launches, "res_launches": res_launches, "n_frames": n_frames,
            "fps": fps, "wav": out.read_bytes(), "codes": decoded[0]}


def compare_fused_codec(tmp: Path, ccfg, card: str, plain: dict, fused: dict,
                        dtype: str = "float32") -> dict:
    """The synth run under MAGPIE_FUSED_CODEC=1 against the same run without
    it: codes identical, the WAVs' largest sample difference, and (the
    float32 bar, <= 1e-4) the largest difference of ``CodecEngine.decode``'s
    floats for those codes, kernel 9 against kernel B."""
    import torch

    from magpie_tts_tpu_torch.io.codec_weights import load_codec_weights
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine

    if not np.array_equal(plain["codes"], fused["codes"]):
        raise AssertionError(f"MAGPIE_FUSED_CODEC=1 changed the codes ({dtype})")
    pcm = [np.frombuffer(r["wav"][44:], "<i2").astype(np.float32) / 32767.0  # 44-byte header
           for r in (plain, fused)]
    wav_diff = float(np.abs(pcm[0] - pcm[1]).max())
    _, cw = load_codec_weights(str(tmp / "codec.gguf"))
    codec = CodecEngine(cw, ccfg, device="cuda", compute_dtype=getattr(torch, dtype))
    with fused_codec_env(False):
        per_conv = codec.decode(plain["codes"])
    with fused_codec_env(True):
        fused_f = codec.decode(plain["codes"])
    float_diff = float(np.abs(per_conv - fused_f).max())
    log(f"synth --dtype {dtype} MAGPIE_FUSED_CODEC=1 against without: codes identical "
        f"({plain['codes'].shape[0]} frames), WAV max sample difference {wav_diff:.3g}, "
        f"CodecEngine.decode floats max difference {float_diff:.3g} on {card}")
    if dtype == "float32" and float_diff > 1e-4:
        raise AssertionError(f"kernel 9 moved the float32 waveform by {float_diff} (> 1e-4)")
    return {"wav_max_diff": wav_diff, "float_max_diff": float_diff}


def run_stream(tmp: Path, mcfg, ccfg, card: str, offline: dict, dtype: str = "float32",
               fused_codec: bool = False) -> dict:
    """cli.main --stream at temp 0 on the one-sentence text of ``offline``
    (the synth run at temp 0 with the same dtype and codec path): its WAV
    byte-identical to that run's; the time to first audio and the real-time
    factor from its log; kernel A once per frame step, and per chunk one
    vocode of its 36-frame window: 92 conv launches, or with ``fused_codec``
    38 and kernel 9 three times, every launch in ``dtype``."""
    from magpie_tts_tpu_torch import cli
    from magpie_tts_tpu_torch.io.wav import read_wav
    from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
    from magpie_tts_tpu_torch.ops.kernels import codec_res_fused as crf
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.runtime.streaming import StreamParams

    tag = f"--stream --temp 0 --dtype {dtype}{' MAGPIE_FUSED_CODEC=1' if fused_codec else ''}"
    out = tmp / f"stream_{dtype}{'_fc' if fused_codec else ''}.wav"
    argv = ["-m", str(tmp / "magpie.gguf"), "-c", str(tmp / "codec.gguf"), "-t", "hello world",
            "-o", str(out), "--device", "cuda", "--dtype", dtype, "--temp", "0", "--seed", "0",
            "--stream"]
    kernels = (fs, cc, crf)
    reset_counts(kernels)
    err, decoded = io.StringIO(), []
    with contextlib.redirect_stderr(err), fused_codec_env(fused_codec), recording_decodes(decoded):
        rc = cli.main(argv)
    log(err.getvalue().rstrip())
    if rc != 0:
        raise AssertionError(f"cli.main {tag} returned {rc}")
    same = out.read_bytes() == offline["wav"]
    samples, _ = read_wav(str(out))
    n_frames = len(samples) // ccfg.hop_length
    params = StreamParams()
    win = min(params.codec_context_frames + params.frames_per_chunk, mcfg.max_dec_steps)
    chunks = -(-n_frames // params.frames_per_chunk)
    want_steps = n_frames + (1 if n_frames < mcfg.max_dec_steps else 0)
    per_chunk = (38, 3) if fused_codec else (92, 0)
    counts = (fs.launches, cc.launches, crf.launches)
    want = (want_steps, per_chunk[0] * chunks, per_chunk[1] * chunks)
    if not same or n_frames != offline["n_frames"]:
        raise AssertionError(f"{tag}: WAV ({n_frames} frames) is not byte-identical to the "
                             f"offline synth's ({offline['n_frames']} frames)")
    if len(decoded) != chunks or any(d.shape[0] != win for d in decoded) or counts != want:
        raise AssertionError(f"{tag}: {len(decoded)} vocodes of {[d.shape[0] for d in decoded]} "
                             f"frames, frame_step / conv / res_layer_fused launches {counts}, "
                             f"want {chunks} of {win} and {want}")
    check_dtype_launches(kernels, dtype, tag)
    ttfa = float(re.search(r"time to first audio: ([0-9.]+) ms", err.getvalue()).group(1))
    rtf = float(re.search(r"([0-9.]+)x real-time", err.getvalue()).group(1))
    log(f"stream path {tag}: {n_frames} frames in {chunks} chunks, WAV byte-identical to the "
        f"offline synth; time to first audio {ttfa} ms, {rtf}x real-time; frame_step / conv / "
        f"res_layer_fused launches {counts} on {card}")
    return {"ttfa_ms": ttfa, "rtf": rtf, "n_frames": n_frames, "chunks": chunks,
            "res_launches": crf.launches, "conv_launches": cc.launches}


def run_warmup(tmp: Path, card: str) -> dict:
    """cli.main warmup --surfaces all --buckets 16 on the float32 GGUFs: rc 0,
    the kernel library's path on stdout, and each stage's seconds."""
    from magpie_tts_tpu_torch import cli
    from magpie_tts_tpu_torch.ops.kernels import build

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["warmup", "-m", str(tmp / "magpie.gguf"), "-c", str(tmp / "codec.gguf"),
                       "--surfaces", "all", "--buckets", "16", "--device", "cuda"])
    log(err.getvalue().rstrip())
    if rc != 0 or out.getvalue().strip() != str(build.library_path()):
        raise AssertionError(f"cli.main warmup returned {rc}, stdout {out.getvalue()!r}")
    stages = {m.group(1): float(m.group(2))
              for m in re.finditer(r"warmup: (\w+)\s+([0-9.]+)s", err.getvalue())}
    if set(stages) != {"kernels", "offline", "codec", "fused", "stream", "serve", "total"}:
        raise AssertionError(f"warmup stages {stages}")
    log(f"warmup --surfaces all --buckets 16: rc 0, stage seconds {stages} on {card}")
    return stages


def run_quantized_main_paths(tmp: Path, mcfg, ccfg, card: str, q8_nodes: int,
                             dtype: str = "float32", splits=(False, True)) -> dict:
    """``--serve-q8`` on the Q8_0 GGUF, fused and ``--no-fused``, each at temp
    0 against the same file served without the flag (WAV byte-identical);
    ``--serve-int8`` on the float32 GGUF, fused and ``--no-fused``; all with
    ``--dtype dtype``."""
    runs = {}
    for split in splits:
        key = "split" if split else "fused"
        q8 = run_main_path(tmp, mcfg, ccfg, card, split, "magpie_q8.gguf", ["--serve-q8"], 0.0,
                           q8_nodes, dtype)
        dense = run_main_path(tmp, mcfg, ccfg, card, split, "magpie_q8.gguf", (), 0.0,
                              dtype=dtype)
        same = q8["wav"] == dense["wav"]
        log(f"--serve-q8{' --no-fused' if split else ''} --dtype {dtype} at temp 0: WAV "
            f"byte-identical to the Q8_0 file served without the flag: {same} "
            f"({len(q8['wav'])} bytes)")
        if not same:
            raise AssertionError(f"--serve-q8 ({key}, {dtype}) WAV differs from dequantized "
                                 f"serving")
        runs[f"q8_{key}"], runs[f"q8_dense_{key}"] = q8, dense
        runs[f"int8_{key}"] = run_main_path(tmp, mcfg, ccfg, card, split, "magpie.gguf",
                                            ["--serve-int8"], 0.7, dtype=dtype)
    return runs


def run_batched_streams(tmp: Path, dev, q8_nodes: int, dtype: str = "float32") -> dict:
    """``synthesize_codes_batched_program(int8_stream=...)``, the batched
    kernels' only caller with a stream, at full width on the GGUFs' weights,
    B = 8, 24 frames, temp 0.7: the Q8_0 stream of ``from_gguf(serve_q8=True)``
    (block-stored weights, so kernel 10 runs at program entry) against the
    dense program on the materialized weights, codes equal, fused (kernel C)
    and split (kernels 7 + 8); and the int8 stream of ``serve_int8=True``; in
    compute ``dtype``. Counts each batched kernel's launches by weight stream
    and dtype."""
    import torch

    from magpie_tts_tpu_torch.io.magpie_weights import materialize_weights
    from magpie_tts_tpu_torch.models.magpie import synthesize_codes_batched_program
    from magpie_tts_tpu_torch.ops import sampling
    from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
    from magpie_tts_tpu_torch.ops.kernels import q8_dequant
    from magpie_tts_tpu_torch.pipeline import MagpiePipeline

    dt = getattr(torch, dtype)
    q8_pipe = MagpiePipeline.from_gguf(str(tmp / "magpie_q8.gguf"), device=dev, serve_q8=True,
                                       compute_dtype=dt)
    int8_pipe = MagpiePipeline.from_gguf(str(tmp / "magpie.gguf"), device=dev, serve_int8=True,
                                         compute_dtype=dt)
    c = q8_pipe.config
    B, steps = 8, 24
    rng = np.random.default_rng(7)
    tokens = torch.tensor(rng.integers(2, c.text_vocab_size - 2, size=(B, 32)), device=dev)
    common = dict(tokens=tokens, enc_lengths=[int(n) for n in rng.integers(8, 33, B)],
                  speaker_ids=[b % c.num_speakers for b in range(B)],
                  keys=[sampling.prng_key(b) for b in range(B)], temperature=0.7, config=c,
                  top_k=80, max_steps=steps)
    runs = {}
    with torch.no_grad():
        dense_w = materialize_weights(q8_pipe.engine.weights)
        for fused in (True, False):
            key = "fused" if fused else "split"
            got = {}
            for mode, weights, stream in (
                    ("q8", q8_pipe.engine.weights, q8_pipe.engine.int8_stream),
                    ("dense", dense_w, None),
                    ("int8", int8_pipe.engine.weights, int8_pipe.engine.int8_stream)):
                reset_counts((fsb, dsb, q8_dequant))
                codes, n_frames = synthesize_codes_batched_program(
                    weights=weights, use_fused=fused, int8_stream=stream, **common)
                torch.cuda.synchronize()
                check_dtype_launches((fsb, dsb, q8_dequant), dtype,
                                     f"batched program {fused} {mode} {dtype}")
                kernel = fsb if fused else dsb
                other = dsb if fused else fsb
                n = kernel.launches
                if (n == 0 or kernel.mode_launches[mode] != n or other.launches
                        or q8_dequant.launches != (q8_nodes if mode == "q8" else 0)):
                    raise AssertionError(
                        f"batched program {key} {mode}: {kernel.__name__} launches "
                        f"{kernel.mode_launches}, other batched kernel {other.launches}, "
                        f"q8 dequant {q8_dequant.launches}")
                got[mode] = (codes, n_frames)
                runs[f"{mode}_{key}"] = {"launches": n, "deq_launches": q8_dequant.launches}
                log(f"batched program {key}, {mode} stream, {dtype}: {n} "
                    f"{kernel.__name__.rsplit('.', 1)[1]} launches "
                    f"(all {mode}), q8_dequant launches {q8_dequant.launches}, frames "
                    f"{n_frames.tolist()}")
            same = all(torch.equal(a, b) for a, b in zip(got["q8"], got["dense"]))
            log(f"batched program {key}: Q8_0 stream codes equal to the dense program's on the "
                f"materialized weights: {same}")
            if not same:
                raise AssertionError(f"batched program {key}: Q8_0 stream codes differ")
    return runs


# Admission (phase 11): groups of ADMIT_M requests a prepare_batch, per
# token bucket. A row of a group against the request's prepare alone:
# cuBLAS picks its algorithm by shape, so the float32 sums differ in their
# last bits (~2e-6 of the tensor's largest value at 357M, H100) and in bf16
# every later rounding spreads a flipped value (69-87% within 1 scaled ulp,
# at most 10.9). The bars (as tests/test_torch_admission_cuda.py holds
# them): float32 max |diff| over the tensor's max |value| ADMIT_REL; bf16
# ADMIT_ULP_SHARE within 1 scaled ulp and none past ADMIT_ULP_MAX.
ADMIT_M = (1, 2, 4, 8, 32)
ADMIT_BUCKETS = (32, 128)
ADMIT_REL, ADMIT_ULP_SHARE, ADMIT_ULP_MAX = 1e-5, 0.5, 16.0


def _wall_ms(fn) -> float:
    """Host ms of fn() to its last device work (the admission is host-bound:
    ~1000 small launches a pass)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def time_admission(tmp: Path, dev, card: str) -> dict:
    """Admission (serve's ``prepare_batch``; plain PyTorch: encoder, XA
    K/V, prefill, BOS step) on the GGUF's weights: for each dtype, token
    bucket and M of ADMIT_M, one group of M requests (mixed lengths, 1 and
    the full bucket among them, every speaker) against M calls of
    ``prepare``, in turns (group, requests, requests, group; host ms to the
    last device work, one warm-up of each first). Every row of each group is
    held against its request's ``prepare`` (ADMIT_REL, ADMIT_ULP_*). bf16
    multiplies with ``float32_products`` as the engines do. Returns
    {dtype: {bucket: {M: {"group_ms", "alone_ms", "ms_a_request", ...}}}}."""
    import torch

    from magpie_tts_tpu_torch.io.magpie_weights import load_magpie_weights
    from magpie_tts_tpu_torch.models import magpie as magpie_mod

    c, w32 = load_magpie_weights(str(tmp / "magpie.gguf"))
    n_rows = c.context_frames + 1
    rng = np.random.default_rng(14)
    out = {}
    for dtype in ("float32", BF):
        w = magpie_mod.float32_products(w32.to(device=dev, dtype=getattr(torch, dtype)))
        out[dtype] = {}
        for bucket in ADMIT_BUCKETS:
            m_max = max(ADMIT_M)
            lens = [int(n) for n in rng.integers(1, bucket + 1, m_max)]
            lens[0], lens[1] = 1, bucket
            spk = [i % c.num_speakers for i in range(m_max)]
            tokens = np.zeros((m_max, bucket), np.int64)
            for i, n in enumerate(lens):
                tokens[i, :n] = rng.integers(2, c.text_vocab_size - 2, n)
            tokens = torch.from_numpy(tokens).to(dev)
            res = out[dtype][bucket] = {}
            with torch.no_grad():
                for m in ADMIT_M:
                    group = lambda: magpie_mod.prepare_batch(tokens[:m], lens[:m], spk[:m], w, c)
                    got, alone = [], []
                    requests = lambda: alone.append(
                        [magpie_mod.prepare(tokens[i], lens[i], spk[i], w, c) for i in range(m)])
                    group(), requests()     # warm-up
                    times = {"group": [], "alone": []}
                    for who in ("group", "alone", "alone", "group"):
                        times[who].append(_wall_ms(
                            (lambda: got.append(group())) if who == "group" else requests))
                    g, a = got[-1], alone[-1]
                    want = [torch.stack([r[0] for r in a]), torch.stack([r[1] for r in a]),
                            torch.stack([r[2].k_cache[:, :n_rows] for r in a]),
                            torch.stack([r[2].v_cache[:, :n_rows] for r in a]),
                            torch.stack([r[2].hidden for r in a])]
                    check = {}
                    for name, x, y in zip(("xa_k", "xa_v", "k_rows", "v_rows", "hidden"), g, want):
                        if x.shape != y.shape or not bool(torch.isfinite(x).all()):
                            raise AssertionError(f"admission {dtype} bucket {bucket} M={m}: "
                                                 f"{name} {tuple(x.shape)} against "
                                                 f"{tuple(y.shape)}, or not finite")
                        if dtype == BF:
                            d = scaled_ulps(x, y)
                            check[name] = ulp_summary(d)
                            ok = ulp_ok(d, ADMIT_ULP_SHARE, ADMIT_ULP_MAX)
                        else:
                            check[name] = float((x - y).abs().max() / y.abs().max())
                            ok = check[name] <= ADMIT_REL
                        if not ok:
                            raise AssertionError(
                                f"admission {dtype} bucket {bucket} M={m}: {name} against the "
                                f"requests alone {check[name]}, bar "
                                f"{(ADMIT_ULP_SHARE, ADMIT_ULP_MAX) if dtype == BF else ADMIT_REL}")
                    equal = all(torch.equal(x, y) for x, y in zip(g, want))
                    res[m] = {"group_ms": times["group"], "alone_ms": times["alone"],
                              "ms_a_request": float(np.mean(times["group"])) / m,
                              "alone_ms_a_request": float(np.mean(times["alone"])) / m,
                              "rows_bit_equal": equal, "rows_vs_alone": check}
                    log(f"admission {dtype} bucket {bucket} M={m}: group "
                        f"{times['group'][0]:.3f} / {times['group'][1]:.3f} ms, {m} prepare calls "
                        f"{times['alone'][0]:.3f} / {times['alone'][1]:.3f} ms (turns group, "
                        f"calls, calls, group); ms a request {res[m]['ms_a_request']:.3f} "
                        f"grouped, {res[m]['alone_ms_a_request']:.3f} alone; rows against the "
                        f"requests alone: bit-equal {equal}, "
                        f"{'scaled ulps' if dtype == BF else 'rel'} {check}; on {card}")
    return out


SERVE_SLOTS, SERVE_SEGMENT = 8, 16  # serve's default slots
SERVE_TEXTS = ["hello world", "hello, world!", "world hello.", "abc def", "hello abc world",
               "def, hello"]


def run_serve(tmp: Path, mcfg, ccfg, card: str, split: bool = False,
              dtype: str = "bfloat16", fused_codec: bool = False, slots: int = None,
              n_requests: int = None) -> dict:
    """cli.main serve at full width: ``n_requests`` JSONL requests (default
    the six SERVE_TEXTS; more cycle through them with their own seeds) and a
    malformed line on a stdin stand-in, ``--slots slots`` (default
    SERVE_SLOTS); checks every result, the error line, the WAVs, and the
    launch counts: one ``PrepareGraphs`` call (``prepare_batch``, replayed as
    a CUDA graph) a (bucket, power-of-two chunk) group of each admission, as
    the JAX engine groups; kernel C once per
    slot group (``slot_groups(slots)``) per segment frame, or with ``split``
    (``MAGPIE_NO_FUSED=1``) kernels 7 and 8 so and kernel C never; the plain
    frame versions never; codec conv 92 per ``decode_batch`` (N utterances a
    call), or with ``fused_codec`` (MAGPIE_FUSED_CODEC=1) 38 and kernel 9
    three times; every launch in ``dtype`` (bfloat16: serve's default, no
    ``--dtype`` given)."""
    from magpie_tts_tpu_torch import cli
    from magpie_tts_tpu_torch.io.wav import read_wav
    from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
    from magpie_tts_tpu_torch.ops.kernels import codec_res_fused as crf
    from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
    from magpie_tts_tpu_torch.models import magpie as magpie_mod
    from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine, pick_bucket

    hop = ccfg.hop_length
    slots = SERVE_SLOTS if slots is None else slots
    texts = [SERVE_TEXTS[i % len(SERVE_TEXTS)] for i in range(n_requests or len(SERVE_TEXTS))]
    lines = [json.dumps({"id": f"r{i}", "text": t, "seed": i}) for i, t in enumerate(texts)]
    lines.insert(3, '{"id": "bad", "text": ')
    counts = {"segments": 0, "decode_batch": 0, "plain": 0}
    groups = {"want": [], "got": []}   # (bucket, m) of each admission group

    def counted(fn, key):
        def wrapper(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapper

    def admit_counted(engine):
        """The (bucket, m) groups the JAX engine's rule makes of what this
        call admits: the queue's head, as many as slots are free, by token
        bucket in queue order, power-of-two chunks of at most n_slots."""
        n = min(sum(r is None for r in engine._slot_req), len(engine._queue))
        by_bucket: dict = {}
        for req in list(engine._queue)[:n]:
            bucket = pick_bucket(engine.token_buckets, len(req.token_ids))
            by_bucket[bucket] = by_bucket.get(bucket, 0) + 1
        for bucket, left in by_bucket.items():
            while left:
                m = 1
                while m * 2 <= left and m * 2 <= engine.n_slots:
                    m *= 2
                groups["want"].append((bucket, m))
                left -= m
        return admit_fn(engine)

    def prepare_counted(owner, tokens, *a, **k):
        groups["got"].append((tokens.shape[1], tokens.shape[0]))
        return prepare_fn(owner, tokens, *a, **k)

    out_dir = tmp / (f"serve_{dtype}{'_split' if split else ''}{'_fc' if fused_codec else ''}"
                     f"_{slots}")
    argv = ["serve", "-m", str(tmp / "magpie.gguf"), "-c", str(tmp / "codec.gguf"),
            "--out-dir", str(out_dir), "--slots", str(slots),
            "--segment-frames", str(SERVE_SEGMENT), "--temp", "0.7", "--device", "cuda"]
    if dtype != "bfloat16":
        argv += ["--dtype", dtype]
    out, err = io.StringIO(), io.StringIO()
    seg_fn, dec_fn, stdin = ContinuousBatchingEngine._segment, CodecEngine.decode_batch, sys.stdin
    admit_fn = ContinuousBatchingEngine._admit_pending
    prepare_fn = magpie_mod.PrepareGraphs.__call__
    ContinuousBatchingEngine._segment = counted(seg_fn, "segments")
    CodecEngine.decode_batch = counted(dec_fn, "decode_batch")
    ContinuousBatchingEngine._admit_pending = admit_counted
    magpie_mod.PrepareGraphs.__call__ = prepare_counted
    sys.stdin = io.StringIO("\n".join(lines) + "\n")
    kernels = (fsb, ltsb, dsb, cc, crf)
    plain = [(mod, name, getattr(mod, name)) for mod, name in (
        (fsb, "frame_step_batched_reference"), (ltsb, "sample_frame_codes_batched_reference"),
        (dsb, "decode_step_batched_reference"))]
    def on_card(fn):
        def wrapper(*a, **k):
            rows = a[0] if a else k.get("hidden", k.get("x_pe"))
            counts["plain"] += rows.device.type == "cuda"
            return fn(*a, **k)
        return wrapper

    for mod, name, fn in plain:
        setattr(mod, name, on_card(fn))
    if split:
        os.environ["MAGPIE_NO_FUSED"] = "1"
    try:
        reset_counts(kernels)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
                fused_codec_env(fused_codec):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        batched_launches, lt_launches, dec_launches, conv_launches, res_launches = (
            k.launches for k in kernels)
    finally:
        ContinuousBatchingEngine._segment, CodecEngine.decode_batch = seg_fn, dec_fn
        ContinuousBatchingEngine._admit_pending = admit_fn
        magpie_mod.PrepareGraphs.__call__ = prepare_fn
        for mod, name, fn in plain:
            setattr(mod, name, fn)
        sys.stdin = stdin
        os.environ.pop("MAGPIE_NO_FUSED", None)
    log(err.getvalue().rstrip())
    if rc != 0:
        raise AssertionError(f"cli.main serve returned {rc}")
    results = [json.loads(ln) for ln in out.getvalue().splitlines()]
    errors = [r for r in results if "error" in r]
    done = {r["id"]: r for r in results if "error" not in r}
    if len(errors) != 1 or sorted(done) != sorted(f"r{i}" for i in range(len(texts))):
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
    n_groups = len(fsb.slot_groups(slots))
    group_launches = n_groups * seg_frames
    want = (0, group_launches, group_launches) if split else (group_launches, 0, 0)
    if seg_frames == 0 or (batched_launches, lt_launches, dec_launches) != want:
        raise AssertionError(f"frame_step_batched / lt_sampler_batched / decoder_step_batched "
                             f"launched {batched_launches} / {lt_launches} / {dec_launches}x for "
                             f"{counts['segments']} segments of {SERVE_SEGMENT} frames in "
                             f"{n_groups} slot groups of {slots} slots (split {split})")
    if counts["plain"]:
        raise AssertionError(f"serve at {slots} slots ran a plain frame version "
                             f"{counts['plain']}x on the card")
    per_call = (38, 3) if fused_codec else (92, 0)
    if conv_launches == 0 or (conv_launches, res_launches) != tuple(
            n * counts["decode_batch"] for n in per_call):
        raise AssertionError(f"codec conv / kernel 9 launched {conv_launches} / {res_launches}x "
                             f"for {counts['decode_batch']} decode_batch calls, want {per_call} "
                             f"per call")
    check_dtype_launches(kernels, dtype, f"serve {dtype} split {split}")
    if not groups["got"] or groups["got"] != groups["want"]:
        raise AssertionError(f"serve admission: PrepareGraphs groups (bucket, m) {groups['got']}, "
                             f"want one a power-of-two chunk of each bucket {groups['want']}")
    m = re.search(r"in ([0-9.]+)s \(([0-9.]+) aggregate fps", err.getvalue())
    fps = float(m.group(2)) if m else float("nan")
    log(f"serve path {dtype}{' MAGPIE_NO_FUSED=1' if split else ''}"
        f"{' MAGPIE_FUSED_CODEC=1' if fused_codec else ''}, {slots} slots ({n_groups} slot "
        f"groups): {len(done)} requests, "
        f"{frames} frames, {counts['segments']} segments, frame_step_batched / "
        f"lt_sampler_batched / decoder_step_batched launches {batched_launches} / {lt_launches} / "
        f"{dec_launches}, "
        f"conv / res_layer_fused launches {conv_launches} / {res_launches} "
        f"({counts['decode_batch']} decode_batch calls), admission groups (bucket, m) "
        f"{groups['got']}, {fps} aggregate fps (cli.main serve "
        f"wall {wall:.2f} s incl. load) on {card}")
    return {"batched_launches": batched_launches, "lt_launches": lt_launches,
            "dec_launches": dec_launches, "conv_launches": conv_launches,
            "res_launches": res_launches, "frames": frames, "fps": fps, "slots": slots}


# ------------------------------------------------------ the H100 probes (11-18)

PROBE_ATTEND_REL = 5e-4   # attends: float32 sums in another order move a bf16 probability
PROBE_GEMV_REL = 1e-5     # bf16 GEMV: float32 sums in another order
# Reduced counts of the probe path (the entry points' full counts: 50 / 450
# launches for the copy and GEMV slopes, 64 / 1024 for the attends, 20 / 100
# frames, 5-6 replays).
PROBE_N = (10, 50, 2)      # copy and GEMV: n_lo, n_hi, replays
PROBE_ATTEND_N = (8, 40, 2)
PROBE_FRAME_N = (2, 6, 1)


def _rel(got, want) -> dict:
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return {"max_abs_err": err, "max_abs": scale, "rel_err": err / scale if scale else err}


def check_gemv_bits(dev) -> None:
    """Kernels 11-13 on a seeded normal x at the probe's shape: two
    launches, 100 launches replayed from one CUDA graph and the stamped
    launch give the same bits, within PROBE_GEMV_REL of plain; the nibble
    formats on a seeded small-integer x (every sum an exact integer) are
    bit-equal to plain. Raises on any difference."""
    import numpy as np
    import torch

    from magpie_tts_tpu_torch.ops.kernels import probe_gemv
    from magpie_tts_tpu_torch.scripts import probe_int4

    rng = np.random.default_rng(7)
    xr = torch.from_numpy(rng.standard_normal((8, 768))).to(device=dev, dtype=torch.bfloat16)
    xi = torch.from_numpy(rng.integers(-3, 4, size=(8, 768)).astype(np.float32)).to(
        device=dev, dtype=torch.bfloat16)
    inputs = probe_int4.make_inputs(dev)
    for fmt in probe_gemv.FORMATS:
        w = inputs[fmt][1]
        a, b = probe_gemv.gemv(xr, w, fmt), probe_gemv.gemv(xr, w, fmt)
        stamped, _ = probe_gemv.gemv_stamps(xr, w, fmt)
        outs = torch.zeros(100, *a.shape, device=dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(100):
                outs[i].copy_(probe_gemv.gemv(xr, w, fmt))
        graph.replay()
        torch.cuda.synchronize()
        same = (torch.equal(a, b), torch.equal(a, stamped), torch.equal(outs, a.expand_as(outs)))
        del graph
        rel = _rel(a, probe_gemv.gemv_reference(xr, w, fmt))["rel_err"]
        plan = probe_gemv.plan_gemv(fmt, 768, 3072)
        log(f"probe gemv [{fmt}] {plan.tiles} tiles x {plan.splits} splits = {plan.ctas} CTAs, "
            f"clusters of {plan.cluster}, normal x: two launches / stamped / 100 graph "
            f"replays bit-equal {same}; {rel:.3g} of the largest value off plain")
        if not all(same) or rel > PROBE_GEMV_REL:
            raise AssertionError(f"probe gemv [{fmt}] changes its bits between launches")
        if fmt != "bf16":
            exact = torch.equal(probe_gemv.gemv(xi, w, fmt), probe_gemv.gemv_reference(xi, w, fmt))
            log(f"probe gemv [{fmt}] small-integer x: bit-equal to plain {exact}")
            if not exact:
                raise AssertionError(f"probe gemv [{fmt}] is not the exact integer product")


def check_probes(dev) -> dict:
    """The probe kernels (11-18) against their plain versions at the probe
    shapes, once each; then the probe path: every probe module's functions
    on the card at the reduced counts above (PROBE_*), with every probe
    wrapper's launch count reset before and read after, kernel A's chain among
    them as one short CUDA-graph slope. Returns {row key: result} for the
    kernels line."""
    import torch

    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.ops.kernels import probe_attend, probe_copy, probe_gemv
    from magpie_tts_tpu_torch.scripts import (opt_attend_probe, opt_int8_attend_probe,
                                              opt_launch_probe, opt_slope_probe, probe_int4)

    t0 = time.perf_counter()
    err = {}
    # ---- each kernel against its plain version, once
    for fmt, (x, w, _, _) in probe_int4.make_inputs(dev).items():
        got, want = probe_gemv.gemv(x, w, fmt), probe_gemv.gemv_reference(x, w, fmt)
        torch.cuda.synchronize()
        r = {**_rel(got, want), "bit_equal": bool(torch.equal(got, want))}
        log(f"probe gemv [{fmt}] vs plain: max abs err {r['max_abs_err']:.3g} of "
            f"{r['max_abs']:.4g}, bit-equal {r['bit_equal']}")
        if (fmt != "bf16" and not r["bit_equal"]) or r["rel_err"] > PROBE_GEMV_REL:
            raise AssertionError(f"probe gemv [{fmt}] disagrees with its plain version")
        err[f"gemv_{fmt}"] = r
    check_gemv_bits(dev)
    i8 = opt_int8_attend_probe.make_inputs(dev)
    orient = opt_attend_probe.make_inputs(dev)
    attend_x = {m: opt_int8_attend_probe.inputs_for(m, i8) for m in ("bf16", "i8mixed", "i8cast")}
    attend_x.update(cur=orient, tr=orient)
    for mode, x in attend_x.items():
        checks = [opt_attend_probe.agreement(mode, rows, 2, x) for rows in (320, 640)]
        for r in checks:
            log(f"probe attend [{mode}] rows {r['rows']} iters 2 vs plain: max abs err "
                f"{r['max_abs_err']:.3g} of {r['max_abs']:.4g} ({r['rel_err']:.3g} of the largest, "
                f"bar {PROBE_ATTEND_REL})")
        worst = max(checks, key=lambda r: r["rel_err"])
        if not worst["rel_err"] <= PROBE_ATTEND_REL:
            raise AssertionError(f"probe attend [{mode}] disagrees with its plain version")
        err[f"attend_{mode}"] = worst
    randn = lambda *s: torch.randn(*s, device=dev).to(torch.bfloat16)
    copies = {"minimal": (8, {}, 3), "constblk": (8, {"consts": [randn(*s) for s in
                                                                 opt_slope_probe.WSHAPES]}, 3),
              "grid1": (1, {}, 100), "grid8": (8, {}, 100), "grid20": (20, {}, 100),
              "streamed": (8, {"slab": randn(8, 512, 1024)}, 3)}
    for name, (g, kw, n) in copies.items():
        h = hr = torch.zeros(32, 768, dtype=torch.bfloat16, device=dev)
        same = True
        for _ in range(n):
            h, cs = probe_copy.copy(h, g, **kw)
            hr, csr = probe_copy.copy_reference(hr, g, **kw)
            same = same and bool(torch.equal(cs, csr))
        torch.cuda.synchronize()
        same = same and bool(torch.equal(h, hr))
        plan = probe_copy.plan_for(h, g, **kw)
        log(f"probe copy [{name}] grid {g} = {g} clusters x {plan.ctas} CTAs ({plan.blocks} "
            f"CTAs), {n} chained launches: output and per-step checksums bit-equal to plain: "
            f"{same}; value {float(h.float()[0, 0])}")
        if not same or (name == "grid8" and not bool((h == 764).all())):
            raise AssertionError(f"probe copy [{name}] disagrees with its plain version")
        err[f"copy_{name}"] = {"max_abs_err": 0.0}
    # ---- the probe path: the probe modules' functions, counts reset before, read after
    probe_gemv.launches = probe_attend.launches = probe_copy.launches = 0
    probe_gemv.format_launches = dict.fromkeys(probe_gemv.FORMATS, 0)
    probe_attend.mode_launches = dict.fromkeys(probe_attend.MODES, 0)
    probe_copy.variant_launches = dict.fromkeys(probe_copy.VARIANTS, 0)
    fs.launches = 0
    n_lo, n_hi, reps = PROBE_N
    a_lo, a_hi, a_reps = PROBE_ATTEND_N
    f_lo, f_hi, f_reps = PROBE_FRAME_N
    log(f"probe path at reduced counts: copy / GEMV slopes over {n_lo} / {n_hi} launches, "
        f"attends {a_lo} / {a_hi}, frames {f_lo} / {f_hi}; best of {reps} / {a_reps} / {f_reps} "
        f"replays")
    t1 = time.perf_counter()
    res = {}
    with torch.no_grad():
        for fmt in probe_gemv.FORMATS:
            r = probe_int4.probe(fmt, dev, n_lo, n_hi, reps, timed_n=10)
            log("probe_int4 " + probe_int4.report(r))
            res[f"gemv_{fmt}"] = {**r, **err[f"gemv_{fmt}"]}
        for mode, x in attend_x.items():
            r = opt_attend_probe.slopes(mode, 320, x, dev, a_lo, a_hi, a_reps)
            log("attend probe " + opt_attend_probe.report(r))
            res[f"attend_{mode}"] = {**r, "max_abs_err": err[f"attend_{mode}"]["max_abs_err"],
                                     "rel_err": err[f"attend_{mode}"]["rel_err"]}
        res["copy_minimal"] = opt_slope_probe.probe_minimal(dev, n_lo, n_hi, reps)
        res["copy_constblk"] = opt_slope_probe.probe_constblk(dev, n_lo, n_hi, reps)
        for g in (1, 8, 20):
            res[f"copy_grid{g}"] = opt_launch_probe.run(f"minimal copy kernel grid=({g},)", 32, g,
                                                        0, dev, n_lo, n_hi, reps)
        res["copy_streamed"] = opt_launch_probe.run(
            "minimal + 1MB streamed block/step grid=(8,)", 32, 8, 1, dev, n_lo, n_hi, reps)
        t2 = time.perf_counter()
        frames = {"single": opt_slope_probe.probe_single(dev, 40, f_lo, f_hi, f_reps)}
        a_launches = fs.launches
        for name in ("fused", "dec", "split"):
            frames[name] = opt_slope_probe.PROBES[name](dev, 40, f_lo, f_hi, f_reps)
        frames["lt"] = opt_slope_probe.probe_lt(dev, f_lo, f_hi, f_reps)
        frames["q8"] = opt_slope_probe.probe_q8(dev, f_lo, f_hi, f_reps, pos_offs=(40,))
    launches = {"gemv": dict(probe_gemv.format_launches),
                "attend": dict(probe_attend.mode_launches),
                "copy": dict(probe_copy.variant_launches)}
    log(f"probe path launches: {launches}; kernel A {a_launches} in its captured slope (graph "
        f"{frames['single']['graph_ms']:.4f} ms / eager {frames['single']['eager_ms']:.4f} ms a "
        f"frame); probes {t2 - t1:.1f} s, frame probes {time.perf_counter() - t2:.1f} s")
    missing = [f"{k}[{m}]" for k, d in launches.items() for m, v in d.items() if v == 0]
    if missing or a_launches == 0:
        raise AssertionError(f"the probe path launched no {missing or 'kernel A'}")
    res["launches"], res["frames"] = launches, frames
    for fn in (opt_slope_probe._weights, opt_slope_probe._state, opt_slope_probe._streams):
        fn.cache_clear()
    torch.cuda.empty_cache()
    log(f"probe phase: {time.perf_counter() - t0:.1f} s")
    return res


def probe_rows(res: dict) -> list:
    """Rows 11-18 of the kernels line: ms is the CUDA-graph slope a launch
    with the data L2-resident (graph_hbm_ms: rotated past the L2; eager_ms:
    issued from Python), plain_ms the plain version's CUDA-event mean,
    library_ms the library call's graph slope (cuBLAS bf16 matmul, for the
    nibble formats on the widened weight; SDPA; torch.add), launches the
    probe path's; the GEMVs add the main path's batched GEMM (split-K
    partials, not reduced) L2-resident and from HBM (main_gemm_ms,
    main_gemm_hbm_ms), their plan and phase stamps; the attends add SDPA's
    slope from HBM and the main path's attention (decode_attention)
    L2-resident and from HBM; the copies add their plan (clusters x CTAs)
    and, for the constant blocks and the slabs, the slope from HBM."""
    src = "magpie_tts_tpu_torch/csrc/"
    launches = res["launches"]
    rows = []

    def row(name, source, replaces, n, r, ms, library_ms, bound, **extra):
        rows.append({"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                     "launches": n, "max_abs_err": r["max_abs_err"], "ms": ms,
                     "plain_ms": r["plain_ms"], "bound_ms": bound["bound_ms"],
                     "bound_by": bound["bound_by"], "library_ms": library_ms, "path": "probe",
                     **extra})

    for fmt, line in (("native_int4", 42), ("packed_int8", 71), ("bf16", 110)):
        r = res[f"gemv_{fmt}"]
        extra = {"phase_us": r["phase_us"]} if "phase_us" in r else {}
        row(f"probe_gemv[{fmt}]", "probe_gemv.cu", f"scripts/probe_int4.py:{line}",
            launches["gemv"][fmt], r, r["graph_l2_ms"], r["library_graph_l2_ms"], r,
            graph_hbm_ms=r["graph_hbm_ms"], event_ms=r["ms"],
            library_graph_hbm_ms=r["library_graph_hbm_ms"], main_gemm_ms=r["main_gemm_ms"],
            main_gemm_hbm_ms=r["main_gemm_hbm_ms"], plan=r["plan"], **extra)
    for mode, replaces in (("bf16", "scripts/opt_int8_attend_probe.py:106"),
                           ("i8mixed", "scripts/opt_int8_attend_probe.py:106"),
                           ("i8cast", "scripts/opt_int8_attend_probe.py:106"),
                           ("cur", "scripts/opt_attend_probe.py:83"),
                           ("tr", "scripts/opt_attend_probe.py:83")):
        r = res[f"attend_{mode}"]
        row(f"probe_attend[{mode}]", "probe_attend.cu", replaces, launches["attend"][mode], r,
            r["graph_l2_ms"], r["library_ms"], r, graph_hbm_ms=r["graph_hbm_ms"],
            eager_ms=r["eager_ms"], rows=r["rows"], rel_err=r["rel_err"],
            library_hbm_ms=r["library_hbm_ms"], main_attention_ms=r["main_attention_ms"],
            main_attention_hbm_ms=r["main_attention_hbm_ms"])
    for name, replaces, variant in (("minimal", "scripts/opt_slope_probe.py:69", "minimal"),
                                    ("constblk", "scripts/opt_slope_probe.py:89", "constblk"),
                                    ("grid1", "scripts/opt_launch_probe.py:43", "minimal"),
                                    ("grid8", "scripts/opt_launch_probe.py:43", "minimal"),
                                    ("grid20", "scripts/opt_launch_probe.py:43", "minimal"),
                                    ("streamed", "scripts/opt_launch_probe.py:43", "streamed")):
        r = res[f"copy_{name}"]
        extra = {"eager_ms": r["eager"]["per_launch_ms"], "plan": r["plan"]}
        if "graph_hbm" in r:
            extra["graph_hbm_ms"] = r["graph_hbm"]["per_launch_ms"]
        row(f"probe_copy[{name}]", "probe_copy.cu", replaces, launches["copy"][variant],
            {"max_abs_err": 0.0, **r}, r["graph"]["per_launch_ms"],
            r["library"]["per_launch_ms"], r["bound"], **extra)
    return rows


# ------------------------------------------------------- oracle and acceptance

ORACLE_TEXT = "hello world"
ORACLE_FRAMES = 4       # dump_golden's greedy frames (the CPU reference tree's)
STANDARD_FRAMES = 8     # the standard path against the cached engine
DUMP_REL = 1e-4        # cuda vs cpu float dumps, relative to a dump's largest |value|
EXACT_DUMPS = ("tokens", "greedy_codes", "lt_greedy_codes", "codec_latent")
DUMP_PREFIXES = ("tokens", "text_embedding", "encoder_input", "encoder_layer", "encoder_output",
                 "xa_", "decoder_input", "decoder_layer", "decoder_output", "final_proj",
                 "lt_logits", "lt_greedy_codes", "greedy_codes", "codec_latent", "codec_pre",
                 "codec_stage", "codec_audio")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def check_readers(tmp: Path, card: str):
    """The native reader against the numpy one on the production-width GGUFs:
    metadata equal, and every load (float32 dense, Q8_0 dequantized at load,
    Q8_0 block-stored) bit-equal through both, each load's seconds printed.
    Returns the float32 weights (native) and the seconds by load."""
    import torch

    from magpie_tts_tpu_torch.io import native
    from magpie_tts_tpu_torch.io.gguf import GGUFReader
    from magpie_tts_tpu_torch.io.magpie_weights import Q8Blocks, load_magpie_weights, q8_blocks
    from magpie_tts_tpu_torch.io.tree import flatten_tensors, map_tensors

    _, build_s = _timed(native.load_library)
    log(f"native GGUF reader: {native.library_path().name} built in "
        f"{native.build_seconds if native.build_seconds is not None else 0.0:.2f} s "
        f"(load {build_s:.2f} s)")
    seconds, kept = {}, None
    for model, q8_native in (("magpie.gguf", False), ("magpie_q8.gguf", False),
                             ("magpie_q8.gguf", True)):
        path = str(tmp / model)
        tag = f"{model}{' block-stored' if q8_native else ''}"
        nat, s_nat = _timed(lambda: load_magpie_weights(path, q8_native=q8_native))
        ref, s_ref = _timed(lambda: load_magpie_weights(path, reader=GGUFReader(path),
                                                        q8_native=q8_native))
        if native.open_gguf(path).metadata != GGUFReader(path).metadata or nat[0] != ref[0]:
            raise AssertionError(f"{tag}: metadata or config differ between the readers")
        a, b = (flatten_tensors(map_tensors(w, lambda x: x.q if isinstance(x, Q8Blocks) else x,
                                            is_leaf=lambda x: isinstance(x, Q8Blocks)))
                for w in (nat[1], ref[1]))
        blocks_a, blocks_b = q8_blocks(nat[1]), q8_blocks(ref[1])
        same = list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
        same = same and list(blocks_a) == list(blocks_b) and all(
            torch.equal(blk.q, blocks_b[k].q) and torch.equal(blk.s, blocks_b[k].s)
            for k, blk in blocks_a.items())
        if not same or bool(blocks_a) != q8_native:
            raise AssertionError(f"{tag}: the weights loaded through the native reader differ "
                                 f"from the numpy reader's")
        seconds[tag] = {"native_s": s_nat, "numpy_s": s_ref}
        log(f"reader {tag}: bit-equal through both readers; load {s_nat:.3f} s native, "
            f"{s_ref:.3f} s numpy (host of {card})")
        if model == "magpie.gguf":
            kept = nat
    return kept, seconds


def dump_prefix_errors(ref_dir: Path, cand_dir: Path) -> dict:
    """Two dump trees by dump prefix: the max abs difference, the largest
    |value| of the reference's dumps, and the difference over it. Raises
    where a token / code dump differs, or a float dump differs by more than
    verify_golden's tolerance for it and by more than DUMP_REL of its
    largest value (random codec weights at full width drive the stages to
    ~1e8, where the absolute bars are below float32's reordering)."""
    from magpie_tts_tpu_torch.io.golden import read_golden
    from magpie_tts_tpu_torch.tools.verify_golden import tolerance_for

    errs, bad = {}, []
    for path in sorted(ref_dir.glob("*.bin")):
        a, b = read_golden(str(path)), read_golden(str(cand_dir / path.name))
        if a.shape != b.shape:
            raise AssertionError(f"dump {path.stem}: shape {a.shape} vs {b.shape}")
        err = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
        top = float(np.abs(a).max()) if a.size else 0.0
        e = errs.setdefault(next(p for p in DUMP_PREFIXES if path.stem.startswith(p)),
                            {"max_abs": 0.0, "max_ref": 0.0, "rel": 0.0})
        e["max_abs"], e["max_ref"] = max(e["max_abs"], err), max(e["max_ref"], top)
        e["rel"] = max(e["rel"], err / top if top else err)
        if err > (0.0 if path.stem in EXACT_DUMPS else
                  max(tolerance_for(path.stem, ()), DUMP_REL * top)):
            bad.append(f"{path.stem} max abs {err:.3e} at max |value| {top:.3e}")
    log("dump tree diff by prefix (max abs / max |value| / relative): " + ", ".join(
        f"{k} {v['max_abs']:.3e} / {v['max_ref']:.3e} / {v['rel']:.3e}" for k, v in errs.items()))
    if bad:
        raise AssertionError(f"{cand_dir} against {ref_dir}: " + "; ".join(bad))
    return errs


def run_tool(main, argv) -> str:
    """A tool's main(argv) with its stdout / stderr captured; raises unless rc 0."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{main.__module__} {argv} returned {rc}:\n{out.getvalue()}"
                             f"{err.getvalue()}")
    return out.getvalue() + err.getvalue()


def standard_against_cached(w, c, tokens, std: np.ndarray, cached: np.ndarray, dev) -> dict:
    """The standard path's temperature-0 codes against the cached engine's
    (kernel A): equal, or the first frame that differs differs only at
    near-ties of the plain LT scores on the standard path's hidden
    (``codes_agree``); later frames then follow other codes."""
    import torch

    from magpie_tts_tpu_torch.models import decoder as decoder_mod
    from magpie_tts_tpu_torch.models.encoder import run_encoder
    from magpie_tts_tpu_torch.models.magpie import audio_frame_embedding, speaker_context

    n = min(len(std), len(cached))
    differ = [i for i in range(n) if not np.array_equal(std[i], cached[i])]
    if not differ:
        if len(std) != len(cached):
            raise AssertionError(f"standard path made {len(std)} frames, the engine "
                                 f"{len(cached)}, with equal codes")
        return {"frames": n, "equal": True, "first_diff": None}
    i = differ[0]
    with torch.no_grad():
        frames = np.concatenate([np.full((1, c.num_codebooks), c.audio_bos_id), std[:i]])
        emb = audio_frame_embedding(torch.as_tensor(frames, device=dev), w, c)
        dec_input = torch.cat([speaker_context(w, 0).to(emb.dtype), emb])
        enc = run_encoder(torch.as_tensor(tokens, device=dev), w, c)
        hidden = decoder_mod.decode_full(dec_input, enc, w, c)[-1:]
    got = torch.as_tensor(cached[i:i + 1], device=dev, dtype=torch.int32)
    want = torch.as_tensor(std[i:i + 1], device=dev, dtype=torch.int32)
    codes_agree(f"standard vs kernel A frame {i}", (got, got), (want, want), hidden, w, c,
                [0], 0.0, [i < c.min_generated_frames])
    return {"frames": n, "equal": False, "first_diff": i}


def run_oracle_acceptance(tmp: Path, mcfg, card: str, q8_nodes: int) -> dict:
    """The verification oracle and the acceptance tooling at 357M width on
    the card: the native reader bit-equal to the numpy one (load seconds),
    dump_golden on cuda against a CPU dump of the same file (max abs by dump
    prefix, ``dump_prefix_errors``), acceptance --device cuda on the float32
    file against that CPU tree's model dumps (kernel A's launches in stage 3
    counted against the frames it decoded, kernel B's in stage 5) and on the
    Q8_0 file for stage 3b (kernel 10 and A's Q8_0 stream), and the standard
    path on cuda at temperature 0 against the cached engine for 8 frames."""
    import torch

    from magpie_tts_tpu_torch.io.native import open_gguf
    from magpie_tts_tpu_torch.models.standard import synthesize_codes_standard
    from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.ops.kernels import q8_dequant
    from magpie_tts_tpu_torch.text.tokenizer import MagpieTokenizer
    from magpie_tts_tpu_torch.tools import acceptance, dump_golden

    t0 = time.perf_counter()
    (config, weights), load_s = check_readers(tmp, card)
    model, q8_model, codec = (str(tmp / n) for n in ("magpie.gguf", "magpie_q8.gguf",
                                                    "codec.gguf"))
    trees = {d: tmp / f"golden_{d}" for d in ("cpu", "cuda")}
    for d, tree in trees.items():
        log(run_tool(dump_golden.main, ["-m", model, "-c", codec, "-t", ORACLE_TEXT,
                                        "-o", str(tree), "--frames", str(ORACLE_FRAMES),
                                        "--device", d]).rstrip())
    errs = dump_prefix_errors(trees["cpu"], trees["cuda"])
    log(f"dump_golden cuda vs cpu: {sum(1 for _ in trees['cpu'].glob('*.bin'))} dumps, codes "
        f"equal, floats within verify_golden's tolerances or {DUMP_REL:g} of each dump's "
        f"largest value; on {card}")
    # verify_golden's codec bars are absolute (1e-2 on the stages, 4.5e-3 on
    # the audio), set for the real checkpoint's magnitudes; random codec
    # weights at full width grow the stages' values by orders of magnitude
    # (printed above), so acceptance's stage 4 reads the model's dumps here
    # and the codec's are held by the relative bar above.
    model_tree = tmp / "golden_cpu_model"
    shutil.copytree(trees["cpu"], model_tree, ignore=shutil.ignore_patterns("codec_*"))

    kernels = (fs, cc, q8_dequant)
    reset_counts(kernels)
    def steps(out: str, cap: int) -> tuple:
        """(frames decoded, frame steps run): one step a kept frame, plus the
        EOS frame's when it stopped before the cap."""
        frames = int(re.search(r"greedy: (\d+) frames", out).group(1))
        return frames, frames + (1 if frames < cap else 0)

    reset_counts(kernels)
    out = run_tool(acceptance.main, ["-m", model, "-c", codec, "-r", str(model_tree),
                                     "-t", ORACLE_TEXT, "--max-frames", str(ORACLE_FRAMES),
                                     "--device", "cuda"])
    counts = (dict(fs.mode_launches), cc.launches, q8_dequant.launches)
    log(out.rstrip())
    frames, want = steps(out, ORACLE_FRAMES)
    if "ACCEPTANCE: PASS" not in out or counts != ({"dense": want, "int8": 0, "q8": 0}, 92, 0):
        raise AssertionError(f"acceptance on {model}: frame_step / codec conv / q8 dequant "
                             f"launches {counts}, want {want} dense / 92 / 0 ({frames} frames)")
    log(f"acceptance --device cuda on {model}: PASS; kernel A {want} launches for {frames} "
        f"frames in stage 3, kernel B 92 in stage 5")
    reset_counts(kernels)
    out_q8 = run_tool(acceptance.main, ["-m", q8_model, "-t", ORACLE_TEXT, "--max-frames",
                                        str(STANDARD_FRAMES), "--device", "cuda"])
    counts_q8 = (dict(fs.mode_launches), q8_dequant.launches)
    log(out_q8.rstrip())
    frames_q8, want_q8 = steps(out_q8, STANDARD_FRAMES)
    if ("ACCEPTANCE: PASS" not in out_q8 or not re.search(r"ok\s+q8_native_codes", out_q8)
            or counts_q8 != ({"dense": want_q8, "int8": 0, "q8": want_q8}, q8_nodes)):
        raise AssertionError(f"acceptance on {q8_model}: stage 3b not ok, or frame_step by "
                             f"stream / q8 dequant launches {counts_q8} ({frames_q8} frames)")
    log(f"acceptance --device cuda on {q8_model}: PASS; stage 3b {frames_q8} frames, kernel A "
        f"{want_q8} dense + {want_q8} Q8_0-stream launches, kernel 10 {q8_nodes}")

    tokens = MagpieTokenizer.from_gguf_metadata(open_gguf(model).metadata).encode(ORACLE_TEXT)
    dev = torch.device("cuda")
    w = weights.to(device=dev)
    std, std_s = _timed(lambda: synthesize_codes_standard(tokens, w, config, temperature=0.0,
                                                          max_steps=STANDARD_FRAMES))
    cached = dump_golden.greedy_codes(weights, config, tokens, 0, STANDARD_FRAMES, dev)
    agree = standard_against_cached(w, config, tokens, std, cached, dev)
    wall = time.perf_counter() - t0
    log(f"standard path on cuda, temp 0, {STANDARD_FRAMES} frames ({std_s:.2f} s): "
        f"{'equal to' if agree['equal'] else 'near-ties only against'} the cached engine's "
        f"kernel A codes (first difference {agree['first_diff']}); oracle and acceptance phase "
        f"{wall:.1f} s wall on {card}")
    return {"load_s": load_s, "dump_errs": {k: v["max_abs"] for k, v in errs.items()},
            "stage3_launches": want,
            "stage3_frames": frames, "standard": agree, "wall_s": wall}


# Phase 13, whole loops and the device list (scripts.parity_decode /
# parity_batched, probe_lockstep, parallel.mesh), at 357M width.
PARITY_FRAMES, PARITY_TEXTS = 300, 3   # the VERDICT bar: >= 3 texts x >= 300 frames
PARITY_PLAIN_TEXTS = 1                 # the plain (CPU) arm: text 0, all 300 frames
BATCHED_B, BATCHED_FRAMES = 32, 100    # parity_batched's defaults
BATCHED_PLAIN_B = {"float32": 4, "bfloat16": 2}   # the plain lockstep arm's slots (CPU)
LOCKSTEP_N = (100, 400, 3)             # probe_lockstep: frames lo / hi, runs each (best of)
MESH_B, MESH_FRAMES = 8, 100           # the device-list engines: slots, forced frames


def mesh_codes_agree(who: str, ref_engine, reqs, got, want, temp: float, seed: int,
                     B: int = MESH_B) -> list:
    """A meshed engine's codes (one request each, in slot order) against the
    unmeshed engine's (``ref_engine``, B slots): equal, or each differing
    slot parting first at a near-tie of the unmeshed loop re-run to that
    frame (parity_decode's rule). Returns the near-tied slots. The unmeshed
    engine admits all B rows in one ``prepare_batch``, a mesh entry its
    slice: cuBLAS picks its algorithm by shape, so the rows may differ in
    their last bits. The same holds for one engine of B slots against the
    same requests in smaller batches."""
    from magpie_tts_tpu_torch.ops import sampling
    from magpie_tts_tpu_torch.parallel.serving import pad_wave
    from magpie_tts_tpu_torch.scripts import parity_batched as pb
    from magpie_tts_tpu_torch.scripts import parity_decode as pd

    base = sampling.prng_key(seed)
    tokens, lens, spk, keys = pad_wave(reqs, [0] * len(reqs),
                                       [sampling.fold_in(base, i) for i in range(B)],
                                       B, ref_engine.token_buckets)
    inputs = {"tokens": tokens, "lens": lens.tolist(), "spk": spk.tolist(), "keys": keys}
    replica = (ref_engine.weights, ref_engine.prepare_weights)
    ties = []
    for b, (g, w) in enumerate(zip(got, want)):
        def classify(frame, row_a, row_b, b=b):
            hidden, wt, sd, forbid = pb.rerun_hidden(inputs, replica, ref_engine.config, True,
                                                     b, frame, temp)
            return (pd.frame_gaps(hidden, row_a, wt, ref_engine.config, sd, temp, 80, forbid)
                    + pd.frame_gaps(hidden, row_b, wt, ref_engine.config, sd, temp, 80, forbid))
        res = pd.compare_rows(f"slot {b}", "unmeshed", who, w, g, False, classify)
        if not res["ok"]:
            raise AssertionError(res["line"])
        if res["status"] == "NEAR-TIE":
            log(res["line"])
            ties.append(b)
    return ties


def run_whole_loops(dev, card: str, probes: dict) -> dict:
    """Whole decode loops at 357M width, float32 then bf16: parity_decode's
    arms over PARITY_TEXTS x PARITY_FRAMES forced frames at temp 0 (kernel A
    against kernels 4 + 5 on every text, the plain loop on the CPU on the
    first PARITY_PLAIN_TEXTS; float32 also at temp 0.7, fused against split),
    parity_batched's at B = 32 x 100 frames (kernel C against 7 + 8, the plain
    lockstep loop on the CPU at BATCHED_PLAIN_B slots); probe_lockstep's host
    slopes (bf16, B = 32, LOCKSTEP_N) beside kernel C's graph slope
    from the probe phase; and BatchedMagpieEngine over a mesh of every card
    present and over ["cuda:0", "cuda:0"] against the unmeshed engine at
    temp 0 and 0.7. Every arm's launch counters are reset before it and
    checked after it (the scripts' check_launches)."""
    import torch

    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
    from magpie_tts_tpu_torch.parallel import mesh as mesh_mod
    from magpie_tts_tpu_torch.parallel.serving import BatchedMagpieEngine
    from magpie_tts_tpu_torch.scripts import opt_slope_probe
    from magpie_tts_tpu_torch.scripts import parity_batched as pb
    from magpie_tts_tpu_torch.scripts import parity_decode as pd

    t_phase = time.perf_counter()
    _, w = prod_weights(dev)          # random_magpie_weights(MagpieConfig(), seed=0), float32
    cfg = pd.parity_config(PARITY_FRAMES)
    bcfg = pd.parity_config(BATCHED_FRAMES)
    texts = pd.make_token_lists(cfg, PARITY_TEXTS)
    out = {"decode": {}, "batched": {}, "launches": {}}

    def report(who: str, res: dict) -> None:
        for r in res["pairs"]:
            if r["status"] != "EXACT" or who.startswith("parity_decode"):
                log(r["line"])
        if not res["ok"]:
            raise AssertionError(f"{who}: parity FAIL")
        log(f"{who}: PASS, near-ties {res['near_ties']}, arms " + "; ".join(
            f"{arm} {run['seconds']:.2f} s, launches {run['launches']}"
            for arm, run in res["arms"].items()) + f"; on {card}")

    for dt in ("float32", BF):
        dtype = getattr(torch, dt)
        t0 = time.perf_counter()
        res = pd.run_parity(cfg, w, texts, ("fused", "split", "plain"), dev, dtype, 0.0,
                            plain_texts=PARITY_PLAIN_TEXTS)
        report(f"parity_decode {dt} temp 0 ({PARITY_TEXTS} texts x {PARITY_FRAMES} frames, "
               f"plain on {PARITY_PLAIN_TEXTS})", res)
        out["decode"][dt] = {"fps": {a: r["fps"] for a, r in res["arms"].items()},
                             "near_ties": res["near_ties"],
                             "wall_s": time.perf_counter() - t0}
        for arm in ("fused", "split"):
            for k, n in res["arms"][arm]["launches"].items():
                out["launches"][dt, k] = out["launches"].get((dt, k), 0) + n
        if dt == "float32":
            res07 = pd.run_parity(cfg, w, texts, ("fused", "split"), dev, dtype, 0.7)
            report(f"parity_decode float32 temp 0.7 ({PARITY_TEXTS} texts, fused vs split)",
                   res07)
            out["decode"]["float32 temp 0.7 fps"] = {a: r["fps"]
                                                      for a, r in res07["arms"].items()}
        t0 = time.perf_counter()
        inputs = pb.make_inputs(bcfg, BATCHED_B, 0)
        res = pb.run_parity(bcfg, w, inputs, ("fused", "split", "plain"), dev, dtype, 0.0,
                            plain_batch=BATCHED_PLAIN_B[dt])
        report(f"parity_batched {dt} temp 0 (B={BATCHED_B} x {BATCHED_FRAMES} frames, plain "
               f"on {BATCHED_PLAIN_B[dt]} slots)", res)
        for arm in ("fused", "split"):
            for k, n in res["arms"][arm]["launches"].items():
                out["launches"][dt, k] = out["launches"].get((dt, k), 0) + n
        out["batched"][dt] = {"near_ties": res["near_ties"],
                              "aggregate_fps": {a: int(r["n_frames"].sum()) / r["seconds"]
                                                for a, r in res["arms"].items()},
                              "wall_s": time.perf_counter() - t0}

    n_lo, n_hi, reps = LOCKSTEP_N
    lock = opt_slope_probe.probe_lockstep(dev, n_lo, n_hi, reps)
    graph_c = probes["frames"]["fused"]["graph_ms"]
    out["lockstep"] = {o["kernel"]: o["host_ms"] for o in lock}
    out["lockstep_glue_share"] = 1.0 - graph_c / out["lockstep"]["C"]
    log(f"probe_lockstep (bf16, B={lock[0]['B']}, {n_lo} / {n_hi} frames, host slope): fused "
        f"{out['lockstep']['C']:.4f} ms a frame, split {out['lockstep']['7+8']:.4f}; kernel C's "
        f"CUDA-graph slope {graph_c:.4f} ms (probe phase, pos +40): host glue "
        f"{100 * out['lockstep_glue_share']:.1f}% of a fused lockstep frame; on {card}")

    mcfg = pd.parity_config(MESH_FRAMES)
    reqs = pd.make_token_lists(mcfg, MESH_B)
    unmeshed = BatchedMagpieEngine(w, mcfg, batch_size=MESH_B, device=dev)
    meshes = {"every card": mesh_mod.make_mesh(),
              "cuda:0 x2": mesh_mod.make_mesh(devices=["cuda:0", "cuda:0"])}
    out["mesh"] = {}
    for temp in (0.0, 0.7):
        t0 = time.perf_counter()
        want = unmeshed.synthesize_batch(reqs, temperature=temp, seed=5)
        t_ref = time.perf_counter() - t0
        for name, mesh in meshes.items():
            eng = BatchedMagpieEngine(w, mcfg, batch_size=MESH_B, mesh=mesh)
            reset_counts(tuple(pd.all_kernels(batched=True).values()))
            t0 = time.perf_counter()
            got = eng.synthesize_batch(reqs, temperature=temp, seed=5)
            secs = time.perf_counter() - t0
            launches = pd.read_launches(batched=True)
            want_c = len(mesh) * MESH_FRAMES * len(fsb.slot_groups(MESH_B // len(mesh)))
            if launches != {"C": want_c, "7": 0, "8": 0}:
                raise AssertionError(f"mesh {name}: launches {launches}, want C {want_c}")
            ties = mesh_codes_agree(name, unmeshed, reqs, got, want, temp, 5)
            out["mesh"][name, temp] = {"seconds": secs, "unmeshed_s": t_ref, "ties": ties}
            log(f"BatchedMagpieEngine mesh {name} ({[str(d) for d in mesh]}), B={MESH_B} x "
                f"{MESH_FRAMES} frames, temp {temp}: codes "
                f"{'equal to' if not ties else f'near-ties only (slots {ties}) against'} the "
                f"unmeshed engine's; kernel C {launches['C']} launches; {secs:.3f} s (unmeshed "
                f"{t_ref:.3f} s, host clock); on {card}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"whole loops and the device list: phase {out['wall_s']:.1f} s wall on {card}")
    return out


# ------------------------------------------ slot groups: more than 64 slots (phase 14)

GROUP_PLAIN_B = 65               # kernels C, 7, 8 against plain: one slot past a launch
GROUP_BITS_B = (96, 128)         # against the same slots in launches of GROUP_SPLIT
GROUP_SPLIT = 48                 # slots a launch of that comparison: <= 64, off the group edges
GROUP_SLOPE_B = (64, 96, 128)    # kernel C's CUDA-graph slope a frame
GROUP_SERVE_SLOTS = 96           # cli.main serve --slots, with as many requests
GROUP_LOCKSTEP_B, GROUP_LOCKSTEP_FRAMES = 128, 32   # against two batches of 64


def group_inputs(dev, B: int, write_row: int, rng, dtype: str):
    """Kernel C's arguments for B slots past BATCH_MAX: batched_state's
    prepared streams repeated (hidden, xa, enc_lengths), each slot with its
    own ring mask (slot B // 2 - 1 empty, so that the last group's slots are
    live), seed, forbid_eos, may_continue and posemb row; and [B, L, S, D]
    caches of batched_state's rows repeated."""
    import torch

    c, w, hidden, xa_k, xa_v, k_base, v_base, enc = batched_state(dev, dtype)
    reps = -(-B // BATCH_MAX)
    rep = lambda t: t.repeat(reps, *([1] * (t.dim() - 1)))[:B].contiguous()
    x = dict(
        hidden=rep(hidden), write_row=write_row,
        valid=torch.tensor(np.roll(_ring_valid(B, c.max_seq, write_row, rng), B // 2, axis=0),
                           device=dev),
        may_continue=torch.tensor(rng.random(B) < 0.8, device=dev),
        posemb=w.decoder.pos_emb[torch.tensor(rng.integers(c.context_frames + 1, c.max_seq, B),
                                               device=dev)],
        xa_k=rep(xa_k), xa_v=rep(xa_v),
        enc_lengths=torch.tensor((enc * reps)[:B], dtype=torch.int32, device=dev),
        seeds=torch.tensor(rng.integers(-2**31, 2**31, B), dtype=torch.int32, device=dev),
        forbid_eos=torch.tensor(rng.random(B) < 0.3, device=dev),
        weights=w, config=c, top_k=80)
    return x, rep(k_base), rep(v_base)


def bits_equal(a, b) -> bool:
    """Bit for bit (NaN payloads included)."""
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def check_slot_groups(dev) -> dict:
    """Kernels C, 7 and 8 past one launch's 64 slots at 357M, both dtypes,
    row 300: at B = 65 against their plain versions at temp 0 (float32 codes
    exact and floats within FRAME_TOL, bf16 codes equal or near-ties and
    floats within ULP_SHARE / ULP_MAX, live slots); at B = 96 and 128 every
    slot's codes, hidden row and new K/V rows bit-equal to the same slots
    run as launches of GROUP_SPLIT slots (temp 0.7); one launch a slot group
    each; kernel C's CUDA-graph slope a frame at GROUP_SLOPE_B. Memory at
    B = 128: float32 K/V caches of 47 MB a slot, 6.0 GB a copy, three copies
    live at once (the repeated rows, the grouped run's, the comparison's)."""
    import torch

    from magpie_tts_tpu_torch.models.magpie import audio_frame_embedding
    from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
    from magpie_tts_tpu_torch.scripts import timing

    kernels = (fsb, ltsb, dsb)
    out = {}
    t_phase = time.perf_counter()
    for dtype in ("float32", BF):
        c, w = prod_weights(dev, dtype)
        r = c.max_seq // 2 - 20
        rng = np.random.default_rng(14)
        res = out[dtype] = {}

        def step8(x, sampled, argmax):
            valid = x["valid"].clone()
            valid[:, r] = x["may_continue"] & ~_eos(sampled, argmax, c)
            return (audio_frame_embedding(sampled, w, c) + x["posemb"], r, valid, x["xa_k"],
                    x["xa_v"])

        def launched(who, B):
            want = len(fsb.slot_groups(B))
            counts = [k.launches for k in kernels]
            if counts != [want] * 3:
                raise AssertionError(f"{who}: kernels C / 7 / 8 launched {counts}x at B {B}, "
                                     f"want {want} each (its slot groups)")
            check_dtype_launches(kernels, dtype, who)
            return want

        with torch.no_grad():
            B = GROUP_PLAIN_B
            x, kb, vb = group_inputs(dev, B, r, rng, dtype)
            (kk, vk), (kr, vr), (k8, v8), (k8r, v8r) = [(kb.clone(), vb.clone())
                                                        for _ in range(4)]
            del kb, vb
            reset_counts(kernels)
            sk, ak, hk, _, _ = fsb.frame_step_batched(k_cache=kk, v_cache=vk, temperature=0.0,
                                                      **x)
            s7, a7 = ltsb.sample_frame_codes_batched(x["hidden"], w, c, x["seeds"], 0.0, 80,
                                                     x["forbid_eos"])
            sr, ar, hr, _, _ = fsb.frame_step_batched_reference(k_cache=kr, v_cache=vr,
                                                                temperature=0.0, **x)
            step = step8(x, sr, ar)
            h8 = dsb.decode_step_batched(*step, k8, v8, w, c, x["enc_lengths"])
            groups = launched(f"slot groups [{dtype}] B {B}", B)
            t0 = time.perf_counter()
            h8r = dsb.decode_step_batched_reference(*step, k8r, v8r, w, c, x["enc_lengths"])
            torch.cuda.synchronize()
            who = f"slot groups [{dtype}] B {B} row {r} temp 0"
            live = x["valid"].any(-1).nonzero().flatten().tolist()   # slots with a valid row
            # codes (sampled and argmax) that differ from plain, counted
            differ = {k: int((s != sr).sum() + (a != ar).sum())
                      for k, s, a in (("C", sk, ak), ("7", s7, a7))}
            if dtype == "float32":
                if any(differ.values()):
                    raise AssertionError(f"{who}: kernel C / 7 codes differ from plain {differ}")
                bad = bad7 = []
            else:
                bad = codes_agree(f"frame_step_batched {who}", (sk, ak), (sr, ar), x["hidden"],
                                  w, c, x["seeds"].tolist(), 0.0, x["forbid_eos"].tolist())
                bad7 = codes_agree(f"lt_sampler_batched {who}", (s7, a7), (sr, ar), x["hidden"],
                                   w, c, x["seeds"].tolist(), 0.0, x["forbid_eos"].tolist())
            live_c = [b for b in live if b not in bad]
            pairs_c = ((hk[live_c], hr[live_c]), (kk[live_c][:, :, r], kr[live_c][:, :, r]),
                       (vk[live_c][:, :, r], vr[live_c][:, :, r]))
            pairs_8 = ((h8[live], h8r[live]), (k8[live][:, :, r], k8r[live][:, :, r]),
                       (v8[live][:, :, r], v8r[live][:, :, r]))
            err = {k: max(float((a.float() - b.float()).abs().max()) for a, b in p)
                   for k, p in (("C", pairs_c), ("8", pairs_8))}
            finite = all(bool(torch.isfinite(t).all()) for t in (hk, h8))
            if dtype == "float32":
                ok = max(err.values()) <= FRAME_TOL
                ulps = {}
            else:
                ulps = {k: ulp_pairs(p) for k, p in (("C", pairs_c), ("8", pairs_8))}
                ok = all(ulp_ok(u) for u in ulps.values())
                ulps = {k: ulp_summary(u) for k, u in ulps.items()}
            log(f"{who}: {groups} launches each of C / 7 / 8; codes differing from plain "
                f"C {differ['C']} in slots {bad}, 7 {differ['7']} in slots {bad7}; max |err| "
                f"C {err['C']:.3g}, 8 {err['8']:.3g}"
                + (f"; scaled ulps {ulps}" if ulps else "") + f"; finite {finite}; plain 8 "
                f"{time.perf_counter() - t0:.1f} s")
            if not ok or not finite:
                raise AssertionError(f"{who}: kernels C / 8 disagree with plain ({err}, {ulps})")
            res["b65"] = {"max_abs_err": err, "ulps": ulps, "codes_differ": differ,
                          "near_tie_slots": {"C": bad, "7": bad7}}
            del kk, vk, kr, vr, k8, v8, k8r, v8r

            for B in GROUP_BITS_B:
                x, kb, vb = group_inputs(dev, B, r, rng, dtype)
                (kg, vg), (ks, vs) = (kb.clone(), vb.clone()), (kb.clone(), vb.clone())
                cuts = [slice(a, min(a + GROUP_SPLIT, B)) for a in range(0, B, GROUP_SPLIT)]
                reset_counts(kernels)
                sg, ag, hg, _, _ = fsb.frame_step_batched(k_cache=kg, v_cache=vg,
                                                          temperature=0.7, **x)
                s7g, a7g = ltsb.sample_frame_codes_batched(x["hidden"], w, c, x["seeds"], 0.7,
                                                           80, x["forbid_eos"])
                counts = [fsb.launches, ltsb.launches]
                parts = {k: [] for k in ("s", "a", "h", "s7", "a7")}
                for sl in cuts:
                    xs = {k: v[sl] if isinstance(v, torch.Tensor) else v for k, v in x.items()}
                    got = fsb.frame_step_batched(k_cache=ks[sl], v_cache=vs[sl], temperature=0.7,
                                                 **xs)[:3]
                    got += ltsb.sample_frame_codes_batched(xs["hidden"], w, c, xs["seeds"], 0.7,
                                                           80, xs["forbid_eos"])
                    for k, v in zip(parts, got):
                        parts[k].append(v)
                torch.cuda.synchronize()
                whole = dict(s=sg, a=ag, h=hg, s7=s7g, a7=a7g)
                same = {k: bits_equal(whole[k], torch.cat(v)) for k, v in parts.items()}
                same["kv"] = bits_equal(kg[:, :, r], ks[:, :, r]) and bits_equal(vg[:, :, r],
                                                                                  vs[:, :, r])
                # kernel 8 on the grouped frame's codes, the same caches reset
                step = step8(x, sg, ag)
                for t, base in ((kg, kb), (vg, vb), (ks, kb), (vs, vb)):
                    t.copy_(base)
                reset_counts(kernels)
                h8g = dsb.decode_step_batched(*step, kg, vg, w, c, x["enc_lengths"])
                counts.append(dsb.launches)
                if counts != [len(fsb.slot_groups(B))] * 3:
                    raise AssertionError(f"slot groups [{dtype}] B {B}: C / 7 / 8 launched "
                                         f"{counts}x, want one a slot group")
                h8s = torch.cat([dsb.decode_step_batched(step[0][sl], r, step[2][sl], step[3][sl],
                                                         step[4][sl], ks[sl], vs[sl], w, c,
                                                         x["enc_lengths"][sl]) for sl in cuts])
                torch.cuda.synchronize()
                same["h8"] = bits_equal(h8g, h8s)
                same["kv8"] = bits_equal(kg[:, :, r], ks[:, :, r]) and bits_equal(vg[:, :, r],
                                                                                   vs[:, :, r])
                log(f"slot groups [{dtype}] B {B} row {r} temp 0.7: C / 7 / 8 in "
                    f"{len(fsb.slot_groups(B))} launches against launches of {GROUP_SPLIT} "
                    f"slots, bit-equal {same}; finite {bool(torch.isfinite(hg).all())}")
                if not all(same.values()):
                    raise AssertionError(f"slot groups [{dtype}] B {B}: a slot's result depends "
                                         f"on its launch ({same})")
                res[f"b{B}"] = {"bit_equal": True}
                del kb, vb, kg, vg, ks, vs
                torch.cuda.empty_cache()

            res["graph_ms"] = {}
            for B in GROUP_SLOPE_B:
                x, kb, vb = group_inputs(dev, B, r, rng, dtype)
                args = {k: v for k, v in x.items() if k != "hidden"}

                def body(i, h):
                    return fsb.frame_step_batched(h, k_cache=kb, v_cache=vb, temperature=0.7,
                                                  **args)[2]
                res["graph_ms"][B] = timing.graph_slope(body, x["hidden"],
                                                        *PERSIST_N)["per_launch_ms"]
                del kb, vb
                torch.cuda.empty_cache()
        log(f"kernel C [{dtype}] CUDA-graph slope a frame, row {r}, temp 0.7: " + ", ".join(
            f"B {B} {ms:.4f} ms ({len(fsb.slot_groups(B))} launches)"
            for B, ms in res["graph_ms"].items()))
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def run_slot_group_paths(tmp: Path, dev, mcfg, ccfg, card: str) -> dict:
    """The entry points past 64 slots: ``cli.main serve --slots 96`` with 96
    requests, fused and under MAGPIE_NO_FUSED=1, in bf16 and float32
    (run_serve: every WAV, kernel C's launches = slot groups x segment
    frames, no plain version; ``decode_batch`` takes the finished requests,
    up to 96 a call); then ``BatchedMagpieEngine(batch_size=128)`` without a
    mesh at temp 0 over GROUP_LOCKSTEP_FRAMES forced frames against the same
    requests as two batches of 64 (codes equal, or near-ties only:
    ``mesh_codes_agree``; each batch is prepared in one ``prepare_batch``),
    and ``CodecEngine.decode_batch`` of its 128 results."""
    import torch

    from magpie_tts_tpu_torch.io.codec_weights import random_codec_weights
    from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
    from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
    from magpie_tts_tpu_torch.parallel.serving import BatchedMagpieEngine
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine
    from magpie_tts_tpu_torch.scripts import parity_decode as pd

    t_phase = time.perf_counter()
    out = {"serve": {}}
    for dt in (BF, "float32"):
        for split in (False, True):
            out["serve"][dt, split] = run_serve(tmp, mcfg, ccfg, card, split=split, dtype=dt,
                                                slots=GROUP_SERVE_SLOTS,
                                                n_requests=GROUP_SERVE_SLOTS)
    B, frames = GROUP_LOCKSTEP_B, GROUP_LOCKSTEP_FRAMES
    _, w = prod_weights(dev)
    lcfg = pd.parity_config(frames)
    reqs = pd.make_token_lists(lcfg, B)
    big = BatchedMagpieEngine(w, lcfg, batch_size=B, device=dev)
    half = BatchedMagpieEngine(w, lcfg, batch_size=B // 2, device=dev)
    kernels = (fsb, ltsb, dsb)
    reset_counts(kernels)
    t0 = time.perf_counter()
    want = big.synthesize_batch(reqs, temperature=0.0, seed=5)
    secs = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    if launches != [len(fsb.slot_groups(B)) * frames, 0, 0]:
        raise AssertionError(f"BatchedMagpieEngine B {B}: C / 7 / 8 launched {launches}x over "
                             f"{frames} frames")
    got = (half.synthesize_batch(reqs[:B // 2], temperature=0.0, seed=5)
           + half.synthesize_batch(reqs[B // 2:], temperature=0.0, seed=5))
    ties = mesh_codes_agree(f"two batches of {B // 2}", big, reqs, got, want, 0.0, 5, B=B)
    codec = CodecEngine(random_codec_weights(ccfg, seed=1), ccfg, device=dev)
    audio = codec.decode_batch(want)
    if len(audio) != B or not all(a.shape == (frames * ccfg.hop_length,)
                                  and np.all(np.isfinite(a)) for a in audio):
        raise AssertionError(f"decode_batch of {B} lockstep results: bad audio")
    torch.cuda.synchronize()
    out["lockstep"] = {"launches": launches[0], "seconds": secs, "ties": ties}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"BatchedMagpieEngine(batch_size={B}) without a mesh, {frames} forced frames, temp 0: "
        f"codes {'equal to' if not ties else f'near-ties only (slots {ties}) against'} two "
        f"batches of {B // 2}; kernel C {launches[0]} launches ({len(fsb.slot_groups(B))} slot "
        f"groups a frame), {secs:.3f} s (host clock); decode_batch of its {B} results finite; "
        f"serve and lockstep past 64 slots {out['wall_s']:.1f} s wall on {card}")
    return out


def kernel_ptxas(build_log: str, kinds) -> list:
    """The -Xptxas -v lines of the named kernels (both dtypes; the GEMM's
    stream mode and m16 tiles from its template arguments): each entry
    function's registers, shared memory, stack and spills."""
    out, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            kind = next((k for k in kinds if k in fn), None)
            name = None
            if kind:
                name = f"{kind}<{'bf16' if 'bfloat16' in fn else 'f32'}>"
                t = re.search(r"gemm_mma_kernelI(?:f|13__nv_bfloat16)Li(\d)ELi(\d)E", fn)
                if t:
                    name += f"[{('dense', 'int8', 'q8')[int(t.group(1))]}, m16 tiles {t.group(2)}]"
                t = re.search(r"frame_persistent_kernelI(?:f|13__nv_bfloat16)Li(\d)ELb(\d)E", fn)
                if t:
                    name += (f"[{('dense', 'int8', 'q8')[int(t.group(1))]}, "
                             f"{'A' if t.group(2) == '1' else '5'}]")
        elif name and ("spill" in line or "registers" in line):
            out.append(f"{name}: {line.strip()}")
    return out


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
    for line in kernel_ptxas(build.build_log, ("snake_conv_kernel", "res_fused_kernel")):
        log("  ptxas, codec: " + line)
    for line in kernel_ptxas(build.build_log, ("attention_scores_kernel", "attention_pv_kernel",
                                               "gemm_mma_kernel")):
        log("  ptxas, frame families: " + line)
    for line in kernel_ptxas(build.build_log, ("frame_persistent_kernel", "lt_persistent_kernel",
                                               "barrier_probe_kernel")):
        log("  ptxas, persistent: " + line)

    fs_res = check_frame_step(dev)
    fsb_res = check_frame_step_batched(dev)
    cc_res = check_codec_conv(dev)
    split_res = check_split_single(dev)
    splitb_res = check_split_batched(dev)
    stream_res = check_stream_single(dev)
    streamb_res = check_stream_batched(dev)
    bf_single = check_bf16_single(dev)
    bf_batched = check_bf16_batched(dev)
    invariance = {dt: check_batch_invariance(dev, dt) for dt in ("float32", BF)}
    slot_groups = check_slot_groups(dev)
    pers = time_persistent(dev)
    lt_times = time_lt_launch(dev)
    lt_count = count_lt_device_kernels(dev)
    for res, dt in ((split_res["lt"], "float32"), (bf_single["4"], BF)):
        res.update(graph_ms=lt_times[dt]["4"]["graph_ms"], draw_us=lt_times[dt]["4"]["draw_us"],
                   device_kernels=lt_count["4"]["device_kernels"])
    for res, dt in ((splitb_res["lt"], "float32"), (bf_batched["7"], BF)):
        res.update(graph_ms=lt_times[dt]["7"][8]["graph_ms"],
                   device_kernels=lt_count["7"]["device_kernels"],
                   **{f"graph_ms_b{B}": lt_times[dt]["7"][B]["graph_ms"] for B in LT_B[1:]})
    for res, dt, k in ((fs_res, "float32", "A"), (split_res["dec"], "float32", "5"),
                       (bf_single["A"], BF, "A"), (bf_single["5"], BF, "5")):
        res.update(pers[dt][k], library_covers="cuBLAS matmul of the frame's products + SDPA "
                                               "of its attentions, B 1, row 300")
    fam = time_families(dev)
    fsb_res["families"] = family_summary(fam["float32"], "C")
    splitb_res["dec"]["families"] = family_summary(fam["float32"], "8")
    bf_batched["C"]["families"] = family_summary(fam[BF], "C")
    bf_batched["8"]["families"] = family_summary(fam[BF], "8")
    bf_conv = check_codec_conv(dev, dtype=BF)
    res_res = check_res_layer_fused(dev)
    bf_res = check_res_layer_fused(dev, dtype=BF)
    decode_times = {dt: time_codec_decode(dev, dt) for dt in ("float32", BF)}
    probes = check_probes(dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        mcfg, ccfg = write_ggufs(tmp)
        deq_res = check_q8_dequant(tmp, dev)
        bf_deq = check_q8_dequant(tmp, dev, BF)
        nodes = deq_res["nodes"]
        # bfloat16: synth (fused, --no-fused, both streams), serve at its default
        bf_main = run_main_path(tmp, mcfg, ccfg, card, dtype=BF)
        bf_split_main = run_main_path(tmp, mcfg, ccfg, card, split=True, dtype=BF)
        bf_quant = run_quantized_main_paths(tmp, mcfg, ccfg, card, nodes, BF)
        bf_serve = run_serve(tmp, mcfg, ccfg, card, dtype=BF)
        bf_split_serve = run_serve(tmp, mcfg, ccfg, card, split=True, dtype=BF)
        bf_quant_batched = run_batched_streams(tmp, dev, nodes, BF)
        # streaming and kernel 9 on the main paths (MAGPIE_FUSED_CODEC=1), bf16 then float32:
        # synth at temp 0 with and without the switch, then --stream against each
        fc, streams = {}, {}
        for dt in (BF, "float32"):
            for on in (False, True):
                fc[dt, on] = run_main_path(tmp, mcfg, ccfg, card, temp=0.0, dtype=dt,
                                           fused_codec=on)
            fc[dt, "diff"] = compare_fused_codec(tmp, ccfg, card, fc[dt, False], fc[dt, True],
                                                 dt)
            for on in (False, True):
                streams[dt, on] = run_stream(tmp, mcfg, ccfg, card, fc[dt, on], dt, on)
        bf_serve_fc = run_serve(tmp, mcfg, ccfg, card, dtype=BF, fused_codec=True)
        warm = run_warmup(tmp, card)
        admission = time_admission(tmp, dev, card)
        # float32, as before
        main_res = run_main_path(tmp, mcfg, ccfg, card, count_kernels=True)
        split_main = run_main_path(tmp, mcfg, ccfg, card, split=True, count_kernels=True)
        serve_res = run_serve(tmp, mcfg, ccfg, card, dtype="float32")
        split_serve = run_serve(tmp, mcfg, ccfg, card, split=True, dtype="float32")
        quant_main = run_quantized_main_paths(tmp, mcfg, ccfg, card, nodes)
        quant_batched = run_batched_streams(tmp, dev, nodes)
        oracle = run_oracle_acceptance(tmp, mcfg, card, nodes)
        group_paths = run_slot_group_paths(tmp, dev, mcfg, ccfg, card)
    loops = run_whole_loops(dev, card, probes)
    for res, dt, k in ((fs_res, "float32", "A"), (split_res["lt"], "float32", "4"),
                       (split_res["dec"], "float32", "5"), (fsb_res, "float32", "C"),
                       (splitb_res["lt"], "float32", "7"), (splitb_res["dec"], "float32", "8"),
                       (bf_single["A"], BF, "A"), (bf_single["4"], BF, "4"),
                       (bf_single["5"], BF, "5"), (bf_batched["C"], BF, "C"),
                       (bf_batched["7"], BF, "7"), (bf_batched["8"], BF, "8")):
        res["whole_loop_launches"] = loops["launches"][dt, k]
    for res, dt, k in ((fsb_res, "float32", "C"), (splitb_res["lt"], "float32", "7"),
                       (splitb_res["dec"], "float32", "8"), (bf_batched["C"], BF, "C"),
                       (bf_batched["7"], BF, "7"), (bf_batched["8"], BF, "8")):
        serve96 = group_paths["serve"][dt, k != "C"]
        res["slot_groups"] = {
            "serve_slots": serve96["slots"], "serve_launches": serve96[
                {"C": "batched_launches", "7": "lt_launches", "8": "dec_launches"}[k]],
            "serve_fps": serve96["fps"],
            "bit_equal_b96_b128": True}
        b65 = slot_groups[dt]["b65"]
        if k in ("C", "8"):
            res["slot_groups"]["b65_max_abs_err"] = b65["max_abs_err"][k]
        if k in ("C", "7"):
            res["slot_groups"]["b65_codes_differ"] = b65["codes_differ"][k]
            res["slot_groups"]["b65_near_tie_slots"] = len(b65["near_tie_slots"][k])
        if k == "C":
            res["slot_groups"]["graph_ms"] = slot_groups[dt]["graph_ms"]
            if dt == "float32":
                res["slot_groups"]["lockstep_b128_launches"] = group_paths["lockstep"]["launches"]

    log(f"summary: e2e {main_res['fps']} fps over {main_res['n_frames']} frames, --no-fused "
        f"{split_main['fps']} fps over {split_main['n_frames']} frames; serve {serve_res['fps']} "
        f"aggregate fps over {serve_res['frames']} frames, MAGPIE_NO_FUSED=1 {split_serve['fps']} "
        f"over {split_serve['frames']}; batched frame B=32 {fsb_res['ms_b32']} ms; split B=32 "
        f"{splitb_res['lt']['ms_b32']} + {splitb_res['dec']['ms_b32']} ms; split frame vs fused "
        f"max err {split_res['split_vs_fused_err']} / {splitb_res['split_vs_fused_err']} "
        f"(B=8/32); codec_conv also replaces "
        f"magpie_tts_tpu/ops/pallas_kernels/codec_conv.py:373 (snake_causal_conv_packed); "
        f"on {card}")
    log(f"summary, quantized serving: --serve-q8 {quant_main['q8_fused']['fps']} fps / "
        f"--no-fused {quant_main['q8_split']['fps']} fps (the same file dequantized at load: "
        f"{quant_main['q8_dense_fused']['fps']} / {quant_main['q8_dense_split']['fps']}), "
        f"--serve-int8 {quant_main['int8_fused']['fps']} / {quant_main['int8_split']['fps']} fps "
        f"(float32 file: {main_res['fps']} / {split_main['fps']}); kernel A dense / q8 / int8 "
        f"{stream_res['q8']['A']['dense_ms']} / {stream_res['q8']['A']['ms']} / "
        f"{stream_res['int8']['A']['ms']} ms at pos 300; q8_dequant {deq_res['ms']} ms per "
        f"materialize of {deq_res['nodes']} tensors; on {card}")
    log(f"summary, bfloat16: synth {bf_main['fps']} fps over {bf_main['n_frames']} frames, "
        f"--no-fused {bf_split_main['fps']} over {bf_split_main['n_frames']}; --serve-q8 "
        f"{bf_quant['q8_fused']['fps']} / {bf_quant['q8_split']['fps']} fps (dequantized at load "
        f"{bf_quant['q8_dense_fused']['fps']} / {bf_quant['q8_dense_split']['fps']}), "
        f"--serve-int8 {bf_quant['int8_fused']['fps']} / {bf_quant['int8_split']['fps']}; serve "
        f"{bf_serve['fps']} aggregate fps over {bf_serve['frames']} frames, MAGPIE_NO_FUSED=1 "
        f"{bf_split_serve['fps']} over {bf_split_serve['frames']}; kernel A {bf_single['A']['ms']} "
        f"ms (float32 {fs_res['ms']}), C at B=8 {bf_batched['C']['ms']} ms (float32 "
        f"{fsb_res['ms']}), codec conv {bf_conv['ms']} ms per 32-frame decode (float32 "
        f"{cc_res['ms']}); codes differing from plain (near-ties) A "
        f"{bf_single['temp07_code_flips']}, C {bf_batched['temp07_code_flips']}; on {card}")
    log("summary, admission (prepare_batch, host ms a request grouped / alone, M = "
        + " / ".join(str(m) for m in ADMIT_M) + "): " + "; ".join(
            f"{dt} bucket {b}: " + " / ".join(
                f"{admission[dt][b][m]['ms_a_request']:.3f}" for m in ADMIT_M) + " against "
            + " / ".join(f"{admission[dt][b][m]['alone_ms_a_request']:.3f}" for m in ADMIT_M)
            for dt in ("float32", BF) for b in ADMIT_BUCKETS) + f"; on {card}")
    log(f"summary, streaming (--stream, temp 0, 'hello world', 4 frames a chunk, 32 context "
        f"frames): time to first audio / real-time factor: float32 "
        f"{streams['float32', False]['ttfa_ms']} ms / {streams['float32', False]['rtf']}x, with "
        f"MAGPIE_FUSED_CODEC=1 {streams['float32', True]['ttfa_ms']} ms / "
        f"{streams['float32', True]['rtf']}x; bf16 {streams[BF, False]['ttfa_ms']} ms / "
        f"{streams[BF, False]['rtf']}x, fused codec {streams[BF, True]['ttfa_ms']} ms / "
        f"{streams[BF, True]['rtf']}x; every streamed WAV byte-identical to the offline synth; "
        f"kernel 9 vs kernel B on the 3 layers of a 32-frame decode: float32 {res_res['ms']} / "
        f"{res_res['kernel_b_ms']} ms, bf16 {bf_res['ms']} / {bf_res['kernel_b_ms']} ms; "
        f"fused-codec WAV max sample difference float32 "
        f"{fc['float32', 'diff']['wav_max_diff']} (floats {fc['float32', 'diff']['float_max_diff']}"
        f"), bf16 {fc[BF, 'diff']['wav_max_diff']}; serve bf16 with the fused codec "
        f"{bf_serve_fc['fps']} aggregate fps ({bf_serve_fc['res_launches']} kernel 9 launches); "
        f"warmup stage seconds {warm}; on {card}")
    log(f"summary, codec on the tensor cores (CUDA-graph slopes, 92 convs of a 32-frame "
        f"decode): kernel B float32 {cc_res['ms']:.4f} ms (conv1d {cc_res['library_ms']:.4f}; "
        f"bound {cc_res['bound_ms']:.4f} as 3 TF32 products, {cc_res['bound_simt_ms']:.4f} SIMT "
        f"float32), bf16 {bf_conv['ms']:.4f} ms (conv1d {bf_conv['library_ms']:.4f}; bound "
        f"{bf_conv['bound_ms']:.4f}); kernel 9 on its 3 layers float32 {res_res['ms']:.4f} ms "
        f"against kernel B's {res_res['kernel_b_ms']:.4f}, bf16 {bf_res['ms']:.4f} against "
        f"{bf_res['kernel_b_ms']:.4f}; CodecEngine.decode of 32 frames wall / device: float32 "
        f"{decode_times['float32']['wall_ms']:.4f} / {decode_times['float32']['device_ms']:.4f} "
        f"ms, bf16 {decode_times[BF]['wall_ms']:.4f} / {decode_times[BF]['device_ms']:.4f} ms; "
        f"on {card}")
    log("summary, oracle and acceptance (357M random GGUFs): load seconds native / numpy "
        + ", ".join(f"{k} {v['native_s']:.3f} / {v['numpy_s']:.3f}"
                    for k, v in oracle["load_s"].items())
        + f" (host); dump_golden cuda vs cpu max abs: decoder_output "
        f"{oracle['dump_errs']['decoder_output']:.3e}, codec_audio "
        f"{oracle['dump_errs'].get('codec_audio', float('nan')):.3e}; acceptance PASS on the "
        f"float32 and Q8_0 files, kernel A {oracle['stage3_launches']} launches for "
        f"{oracle['stage3_frames']} frames in stage 3; standard path vs kernel A at temp 0: "
        f"{'equal' if oracle['standard']['equal'] else 'near-ties only'} over "
        f"{oracle['standard']['frames']} frames; phase {oracle['wall_s']:.1f} s; on {card}")
    dl, bl = loops["decode"], loops["batched"]
    log(f"summary, whole loops (357M, temp 0; parity_decode {PARITY_TEXTS} texts x "
        f"{PARITY_FRAMES} frames, fps by the host clock; parity_batched B={BATCHED_B} x "
        f"{BATCHED_FRAMES}): " + "; ".join(
            f"{dt} fps fused / split / plain {dl[dt]['fps']['fused']:.1f} / "
            f"{dl[dt]['fps']['split']:.1f} / {dl[dt]['fps']['plain']:.2f}, near-ties "
            f"{dl[dt]['near_ties']}; batched near-ties {bl[dt]['near_ties']}"
            for dt in ("float32", BF))
        + f"; probe_lockstep bf16 fused / split {loops['lockstep']['C']:.4f} / "
        f"{loops['lockstep']['7+8']:.4f} ms a frame (host glue "
        f"{100 * loops['lockstep_glue_share']:.1f}% of fused); mesh codes equal: "
        f"{all(not v['ties'] for v in loops['mesh'].values())}; phase {loops['wall_s']:.1f} s; "
        f"on {card}")
    fr = probes["frames"]
    log(f"summary, probes (device-only frame times by CUDA-graph slope, bf16, pos "
        f"context_frames + 40, {PROBE_FRAME_N[0]} / {PROBE_FRAME_N[1]} frames): kernel A "
        f"{fr['single']['graph_ms']:.4f} ms (eager {fr['single']['eager_ms']:.4f}), C at "
        f"B={fr['fused']['B']} {fr['fused']['graph_ms']:.4f} ({fr['fused']['eager_ms']:.4f}), "
        f"7 + 8 with glue {fr['split']['graph_ms']:.4f} ({fr['split']['eager_ms']:.4f}), 8 "
        f"{fr['dec']['graph_ms']:.4f}, 7 {fr['lt']['graph_ms']:.4f}; copy kernel a launch: graph "
        f"{probes['copy_minimal']['graph_ms'] * 1e3:.3f} us, eager "
        f"{probes['copy_minimal']['eager_ms'] * 1e3:.3f} us; on {card}")
    log(f"summary, persistent frame kernels (CUDA-graph slopes, B 1, row 300, ms a frame; "
        f"library composite in brackets): A float32 {pers['float32']['A']['graph_ms']:.4f} "
        f"({pers['float32']['A']['library_ms']:.4f}), bf16 {pers[BF]['A']['graph_ms']:.4f} "
        f"({pers[BF]['A']['library_ms']:.4f}); 5 float32 {pers['float32']['5']['graph_ms']:.4f} "
        f"({pers['float32']['5']['library_ms']:.4f}), bf16 {pers[BF]['5']['graph_ms']:.4f} "
        f"({pers[BF]['5']['library_ms']:.4f}); us a grid barrier "
        + ", ".join(f"{k} {v:.4f}" for k, v in pers["barrier"].items()) + f"; on {card}")
    log(f"summary, the LT samplers (CUDA-graph slopes, 357M, temp 0.7, ms a frame): kernel 4 "
        f"B 1 float32 {lt_times['float32']['4']['graph_ms']:.4f}, bf16 "
        f"{lt_times[BF]['4']['graph_ms']:.4f} (the draw {lt_times['float32']['4']['draw_us']:.2f}"
        f" / {lt_times[BF]['4']['draw_us']:.2f} us a codebook); kernel 7 float32 "
        + ", ".join(f"B {B} {lt_times['float32']['7'][B]['graph_ms']:.4f}" for B in LT_B)
        + ", bf16 " + ", ".join(f"B {B} {lt_times[BF]['7'][B]['graph_ms']:.4f}" for B in LT_B)
        + f"; device kernels a frame: 4 {lt_count['4']['device_kernels']}, 7 "
        f"{lt_count['7']['device_kernels']}, C {lt_count['C']['device_kernels']}; on {card}")
    fam_line = "; ".join(
        f"{dt} B{B} rows{rows}: " + ", ".join(
            f"{k} attention {fam[dt][B, rows][k]['attention']['ms']:.4f} (SDPA "
            f"{fam[dt][B, rows][k]['attention']['library_ms']:.4f}) GEMM "
            f"{fam[dt][B, rows][k]['gemm']['ms']:.4f} (cuBLAS decoder "
            f"{fam[dt][B, rows][k]['gemm']['library_ms']:.4f})" for k in ("C", "8"))
        for dt in ("float32", BF) for B in FAMILY_B for rows in FAMILY_ROWS)
    log(f"summary, frame families (CUDA-graph slopes, ms a frame): {fam_line}; slots bit-equal "
        f"at B = 3 / 8 / {BATCH_MAX}: {all(v['bit_equal'] for v in invariance.values())}; "
        f"on {card}")
    gs = group_paths["serve"]
    log(f"summary, slot groups past 64 slots (kernels C / 7 / 8, ceil(B / 64) launches a "
        f"frame): serve --slots {GROUP_SERVE_SLOTS} aggregate fps bf16 {gs[BF, False]['fps']} "
        f"(MAGPIE_NO_FUSED=1 {gs[BF, True]['fps']}), float32 {gs['float32', False]['fps']} "
        f"({gs['float32', True]['fps']}); kernel C graph slope a frame " + "; ".join(
            f"{dt} " + ", ".join(f"B {B} {ms:.4f} ms" for B, ms in slot_groups[dt][
                "graph_ms"].items()) for dt in ("float32", BF))
        + f"; B = 65 against plain, B = {GROUP_BITS_B} bit-equal to launches of {GROUP_SPLIT}; "
        f"lockstep B = {GROUP_LOCKSTEP_B} near-ties {group_paths['lockstep']['ties']}; kernel "
        f"checks {slot_groups['wall_s']:.1f} s, entry points {group_paths['wall_s']:.1f} s; "
        f"on {card}")
    pk = "magpie_tts_tpu/ops/pallas_kernels/"
    src = "magpie_tts_tpu_torch/csrc/"

    def entry(name, source, replaces, launches, res):
        row = {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
               "launches": launches, "max_abs_err": res["max_abs_err"], "ms": res["ms"],
               "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
               "bound_by": res["bound_by"], "library_ms": res.get("library_ms")}
        row.update({k: res[k] for k in ("max_ulps", "within_1ulp", "kernel_b_ms", "event_ms",
                                        "library_event_ms", "kernel_b_event_ms",
                                        "bound_simt_ms", "f64_err", "plain_f64_err",
                                        "kernel_signed_ulps", "plain_signed_ulps",
                                        "f64_within_1ulp", "plain_f64_within_1ulp",
                                        "families", "graph_ms", "library_covers",
                                        "graph_ms_b32", "graph_ms_b64", "draw_us",
                                        "device_kernels", "whole_loop_launches",
                                        "slot_groups")
                    if k in res})
        return row

    streams = []
    for m in STREAMS:
        streams += [
            entry(f"frame_step[{m}]", "frame_step.cu", pk + "frame_step.py:352",
                  quant_main[f"{m}_fused"]["frame_launches"], stream_res[m]["A"]),
            entry(f"decoder_step[{m}]", "frame_step.cu", pk + "decoder_step.py:212",
                  quant_main[f"{m}_split"]["dec_launches"], stream_res[m]["5"]),
            entry(f"frame_step_batched[{m}]", "frame_step_batched.cu",
                  pk + "frame_step_batched.py:591", quant_batched[f"{m}_fused"]["launches"],
                  streamb_res[m]["C"]),
            entry(f"decoder_step_batched[{m}]", "frame_step_batched.cu",
                  pk + "decoder_step_batched.py:280", quant_batched[f"{m}_split"]["launches"],
                  streamb_res[m]["8"])]
    for m in STREAMS:
        streams += [
            entry(f"frame_step[bf16 {m}]", "frame_step.cu", pk + "frame_step.py:352",
                  bf_quant[f"{m}_fused"]["frame_launches"], bf_single[f"A_{m}"]),
            entry(f"decoder_step[bf16 {m}]", "frame_step.cu", pk + "decoder_step.py:212",
                  bf_quant[f"{m}_split"]["dec_launches"], bf_single[f"5_{m}"]),
            entry(f"frame_step_batched[bf16 {m}]", "frame_step_batched.cu",
                  pk + "frame_step_batched.py:591", bf_quant_batched[f"{m}_fused"]["launches"],
                  bf_batched[f"C_{m}"]),
            entry(f"decoder_step_batched[bf16 {m}]", "frame_step_batched.cu",
                  pk + "decoder_step_batched.py:280", bf_quant_batched[f"{m}_split"]["launches"],
                  bf_batched[f"8_{m}"])]
    bf16_rows = [
        entry("frame_step[bf16]", "frame_step.cu", pk + "frame_step.py:352",
              bf_main["frame_launches"], bf_single["A"]),
        entry("frame_step_batched[bf16]", "frame_step_batched.cu",
              pk + "frame_step_batched.py:591", bf_serve["batched_launches"], bf_batched["C"]),
        entry("codec_conv[bf16]", "codec_conv.cu", pk + "codec_conv.py:157",
              bf_main["conv_launches"], bf_conv),
        entry("lt_sampler[bf16]", "frame_step.cu", pk + "lt_sampler.py:174",
              bf_split_main["lt_launches"], bf_single["4"]),
        entry("decoder_step[bf16]", "frame_step.cu", pk + "decoder_step.py:212",
              bf_split_main["dec_launches"], bf_single["5"]),
        entry("lt_sampler_batched[bf16]", "frame_step_batched.cu",
              pk + "lt_sampler_batched.py:259", bf_split_serve["lt_launches"], bf_batched["7"]),
        entry("decoder_step_batched[bf16]", "frame_step_batched.cu",
              pk + "decoder_step_batched.py:280", bf_split_serve["dec_launches"], bf_batched["8"]),
        entry("q8_dequant[bf16]", "q8_dequant.cu", "tests/test_pallas_kernels.py:443",
              bf_quant["q8_fused"]["deq_launches"], bf_deq),
        entry("res_layer_fused[bf16]", "codec_res_fused.cu", pk + "codec_res_fused.py:130",
              fc[BF, True]["res_launches"], bf_res)]
    log(json.dumps({"kernels": [
        entry("frame_step", "frame_step.cu", pk + "frame_step.py:352",
              main_res["frame_launches"], fs_res),
        entry("frame_step_batched", "frame_step_batched.cu", pk + "frame_step_batched.py:591",
              serve_res["batched_launches"], fsb_res),
        entry("codec_conv", "codec_conv.cu", pk + "codec_conv.py:157",
              main_res["conv_launches"], cc_res),
        entry("lt_sampler", "frame_step.cu", pk + "lt_sampler.py:174",
              split_main["lt_launches"], split_res["lt"]),
        entry("decoder_step", "frame_step.cu", pk + "decoder_step.py:212",
              split_main["dec_launches"], split_res["dec"]),
        entry("lt_sampler_batched", "frame_step_batched.cu", pk + "lt_sampler_batched.py:259",
              split_serve["lt_launches"], splitb_res["lt"]),
        entry("decoder_step_batched", "frame_step_batched.cu",
              pk + "decoder_step_batched.py:280", split_serve["dec_launches"], splitb_res["dec"]),
        entry("q8_dequant", "q8_dequant.cu", "tests/test_pallas_kernels.py:443",
              quant_main["q8_fused"]["deq_launches"], deq_res),
        entry("res_layer_fused", "codec_res_fused.cu", pk + "codec_res_fused.py:130",
              fc["float32", True]["res_launches"], res_res),
        *bf16_rows,
        *streams,
        *probe_rows(probes),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
