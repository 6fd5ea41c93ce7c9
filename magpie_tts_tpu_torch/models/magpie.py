"""Magpie pipeline assembly (magpie_tts_tpu/models/magpie.py): embeddings,
prefill, and the autoregressive decode loops.

1. ``prepare_batch`` encoder + XA-KV precompute + context prefill + BOS step for
                   M requests in one pass (plain PyTorch); ``prepare`` is its
                   M = 1 case.
2. ``decode_loop`` a Python loop over frames; each iteration is one call of
                   ``ops.kernels.frame_step.frame_step`` (the CUDA kernel on a
                   CUDA device, the plain LT sampler + embedding + decoder step
                   on the CPU), then the EOS test on the host. The split path
                   (``use_fused=False``) runs the LT sampler and the decoder
                   step as two kernels with the embedding between.
3. ``synthesize_codes_batched_program`` the lockstep loop over B utterances:
                   one ``ops.kernels.frame_step_batched.frame_step_batched``
                   call per frame (split: the batched sampler, then the
                   batched decoder step), EOS bookkeeping on the device.

``use_fused=None`` everywhere means: fused, unless the ``MAGPIE_NO_FUSED``
environment variable is set (the JAX package's debug switch).

``int8_stream`` is the JAX package's one stream slot: None (dense), an
``Int8DecoderStream`` or a ``Q8DecoderStream``; the loops hand it to the
frame and decoder-step kernels, which dispatch on its type. ``prepare``
(encoder, prefill, BOS step) always runs on the dense weights, in bfloat16
on the engines' ``float32_products`` copy of its matrices. Weights that
hold ``Q8Blocks`` (``--serve-q8``) are dequantized at program entry
(``materialize_weights``, kernel 10 on the card), once per call.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MagpieConfig
from ..io.magpie_weights import MagpieWeights, has_q8_blocks, materialize_weights
from ..ops import sampling
from ..ops.kernels.decoder_step import decode_step
from ..ops.kernels.decoder_step_batched import decode_step_batched
from ..ops.kernels.frame_step import frame_step
from ..ops.kernels.frame_step_batched import frame_step_batched
from ..ops.kernels.lt_sampler import sample_frame_codes
from ..ops.kernels.lt_sampler_batched import sample_frame_codes_batched
from . import decoder as decoder_mod
from .encoder import run_encoder


def audio_frame_embedding(codes: torch.Tensor, weights: MagpieWeights,
                          config: MagpieConfig) -> torch.Tensor:
    """codes: [..., 8] -> [..., d_model]: mean of the 8 per-codebook embeddings,
    accumulated in float32 and rounded back to the table dtype."""
    cb = torch.arange(config.num_codebooks, device=codes.device)
    per_cb = weights.audio_emb[cb, codes.long()]               # [..., 8, d_model]
    mean = per_cb.float().sum(dim=-2) / config.num_codebooks
    return mean.to(per_cb.dtype)


def speaker_context(weights: MagpieWeights, speaker_id) -> torch.Tensor:
    """Baked speaker context frames: [context_frames, d_model] for one id, or
    [M, context_frames, d_model] for an int tensor of M ids."""
    return weights.baked_context[speaker_id]


def resolve_use_fused(use_fused: Optional[bool]) -> bool:
    """None -> the fused frame kernels unless MAGPIE_NO_FUSED is set."""
    return not os.environ.get("MAGPIE_NO_FUSED") if use_fused is None else bool(use_fused)


@dataclasses.dataclass
class DecodeState:
    """What the decode loop carries from frame to frame."""
    k_cache: torch.Tensor      # [L, max_seq, d_model], updated in place
    v_cache: torch.Tensor      # [L, max_seq, d_model], updated in place
    hidden: torch.Tensor       # [d_model] decoder output for the current frame
    pos: int                   # next cache position to write
    frame_idx: int             # number of completed frames
    codes: np.ndarray          # [max_dec_steps, 8] int32 (filled up to frame_idx)
    done: bool


def prepare(tokens: torch.Tensor, enc_length: int, speaker_id: int,
            weights: MagpieWeights, config: MagpieConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, DecodeState]:
    """Everything before the AR loop for one request (``prepare_batch`` at
    M = 1); tokens [T] may be right-padded to a bucket. Returns (xa_k, xa_v
    [L, T, d_xa], state) with state.hidden the BOS-step output and the
    context + BOS rows in a fresh [L, max_seq, d_model] cache."""
    xa_k, xa_v, k_rows, v_rows, hidden = prepare_batch(tokens[None], [enc_length], [speaker_id],
                                                       weights, config)
    n_rows = k_rows.shape[2]
    k_cache = k_rows.new_zeros(config.dec_layers, config.max_seq, config.d_model)
    v_cache = torch.zeros_like(k_cache)
    k_cache[:, :n_rows] = k_rows[0]
    v_cache[:, :n_rows] = v_rows[0]
    state = DecodeState(
        k_cache=k_cache, v_cache=v_cache, hidden=hidden[0], pos=n_rows, frame_idx=0,
        codes=np.zeros((config.max_dec_steps, config.num_codebooks), np.int32), done=False)
    return xa_k[0], xa_v[0], state


def prepare_batch(tokens: torch.Tensor, enc_lengths: Sequence[int], speaker_ids: Sequence[int],
                  weights: MagpieWeights, config: MagpieConfig):
    """``prepare`` of M requests in one pass (the JAX package's
    ``jax.vmap(prepare)``): tokens [M, T] (right-padded to one bucket),
    ``enc_lengths`` and ``speaker_ids`` M ints. Every product and attention
    runs once for the M rows; each row's cross-attention masks its own
    encoder length, and the BOS step at position ``context_frames`` attends
    to that row's ``context_frames + 1`` rows.

    Returns (xa_k, xa_v [M, L, T, d_xa], k_rows, v_rows
    [M, L, context_frames + 1, d_model] (the context and BOS rows, cache rows
    0..context_frames), hidden [M, d_model]). The callers place the rows in
    their own caches, so no M full ``max_seq`` caches are built here.
    ``weights`` may be ``float32_products(w)`` of the engine's weights."""
    weights = materialize_weights(weights)
    dtype = weights.text_emb.dtype
    device = weights.text_emb.device
    M = tokens.shape[0]
    n_rows = config.context_frames + 1
    enc = torch.tensor([int(n) for n in enc_lengths], dtype=torch.int64).to(device)
    spk = torch.tensor([int(s) for s in speaker_ids], dtype=torch.int64).to(device)
    enc_out = run_encoder(tokens, weights, config)
    xa_k, xa_v = decoder_mod.precompute_xa_kv(enc_out, weights.decoder, config)
    k_rows = torch.zeros(M, config.dec_layers, n_rows, config.d_model, dtype=dtype,
                         device=device)
    v_rows = torch.zeros_like(k_rows)
    context = speaker_context(weights, spk).to(dtype)
    decoder_mod.prefill(context, xa_k, xa_v, k_rows, v_rows, weights, config, enc_length=enc)
    bos = torch.full((M, config.num_codebooks), config.audio_bos_id, dtype=torch.int32,
                     device=device)
    bos_emb = audio_frame_embedding(bos, weights, config).to(dtype)
    x_pe = bos_emb + weights.decoder.pos_emb[config.context_frames]
    every_row = torch.ones(n_rows, dtype=torch.bool, device=device)
    hidden = decoder_mod.decode_rows(x_pe, config.context_frames, every_row, xa_k, xa_v,
                                     k_rows, v_rows, weights, config, enc_length=enc)
    return xa_k, xa_v, k_rows, v_rows, hidden


# The matrices prepare multiplies: encoder and decoder fields.
PREPARE_PRODUCTS = {"encoder": ("qkv", "sa_out", "ff_proj", "ff_out"),
                     "decoder": ("qkv", "sa_out", "xa_q", "xa_kv", "xa_out", "ff_proj", "ff_out")}


def float32_products(weights: MagpieWeights) -> MagpieWeights:
    """``weights`` with the matrices ``prepare`` multiplies (the encoder's
    qkv / sa_out / ff_proj / ff_out, the decoder's qkv / sa_out / xa_q /
    xa_kv / xa_out / ff_proj / ff_out) as float32 copies, the rest shared.

    ``matmul_f32`` widens a bfloat16 operand to float32 on every product;
    with these copies it widens no weight, and since widening is exact the
    results are bit-equal (activations keep their bfloat16 rounding points).
    An engine makes the copy once, beside its weights (~0.74 GB at 357M in
    bfloat16). Float32 weights come back unchanged; Q8_0 blocks
    (``--serve-q8``) are not copied: their ``prepare`` widens per product.
    """
    if weights.text_emb.dtype == torch.float32 or has_q8_blocks(weights):
        return weights
    parts = {part: dataclasses.replace(getattr(weights, part), **{
        name: getattr(getattr(weights, part), name).float() for name in names})
        for part, names in PREPARE_PRODUCTS.items()}
    return dataclasses.replace(weights, **parts)


def decode_loop(xa_k: torch.Tensor, xa_v: torch.Tensor, state: DecodeState,
                enc_length: int, weights: MagpieWeights, config: MagpieConfig,
                key: Tuple[int, int], temperature: float, top_k: int,
                use_fused: Optional[bool] = None, int8_stream=None,
                target_frames: Optional[int] = None) -> DecodeState:
    """Sample frames until EOS, ``config.max_dec_steps`` or, when given,
    ``target_frames`` (streaming: the loop stops once ``frame_idx`` reaches
    it, keeping all state so a later call continues).

    Per frame: split the key (host threefry, as jax.random.split), run one
    frame step (sample 8 codes, embed, decoder step at ``pos``), then stop on
    EOS (any codebook's sampled or argmax code) — one host sync per frame.
    The key's split chain starts at this call's first frame, as in the JAX
    loop, which carries ``key`` in its state from the call's start.
    The EOS frame's codes are written but not counted, as in the JAX loop.
    The split path samples, tests EOS on the host, embeds and runs the
    decoder step, the last also on the EOS frame, as the JAX loop does.
    ``int8_stream`` goes to both kernels' stream slot.
    """
    weights = materialize_weights(weights)
    stop = config.max_dec_steps if target_frames is None else min(target_frames,
                                                                  config.max_dec_steps)
    first = state.frame_idx
    seeds = sampling.frame_seeds(key, max(stop - first, 0))
    fused = resolve_use_fused(use_fused)
    s = state
    while not s.done and s.frame_idx < stop:
        forbid_eos = s.frame_idx < config.min_generated_frames
        seed = seeds[s.frame_idx - first]
        if fused:
            sampled, argmax, s.hidden, s.k_cache, s.v_cache = frame_step(
                s.hidden, s.pos, xa_k, xa_v, s.k_cache, s.v_cache, weights, config,
                seed, temperature, top_k, forbid_eos, enc_length=enc_length,
                stream=int8_stream)
        else:
            sampled, argmax = sample_frame_codes(s.hidden, weights, config, seed, temperature,
                                                 top_k, forbid_eos)
        sampled_h, argmax_h = sampled.cpu(), argmax.cpu()
        s.codes[s.frame_idx] = sampled_h.numpy()
        s.done = sampling.frame_has_eos(sampled_h, argmax_h, config.audio_eos_id)
        if not fused:
            emb = audio_frame_embedding(sampled, weights, config)
            s.hidden = decode_step(emb, s.pos, xa_k, xa_v, s.k_cache, s.v_cache, weights,
                                   config, enc_length=enc_length, stream=int8_stream)
        if not s.done:
            s.frame_idx += 1
        s.pos += 1
    return s


def synthesize_codes_program(tokens: torch.Tensor, enc_length: int, speaker_id: int,
                             key: Tuple[int, int], temperature: float,
                             weights: MagpieWeights, config: MagpieConfig, top_k: int,
                             use_fused: Optional[bool] = None, int8_stream=None,
                             prepare_weights: Optional[MagpieWeights] = None):
    """The full single-utterance synthesis: returns (codes [max_dec_steps, 8], n_frames).
    ``prepare_weights``: what ``prepare`` multiplies with (an engine's
    ``float32_products`` copy), default ``weights``."""
    with torch.no_grad():
        weights = materialize_weights(weights)
        xa_k, xa_v, state = prepare(tokens, enc_length, speaker_id, prepare_weights or weights,
                                    config)
        state = decode_loop(xa_k, xa_v, state, enc_length, weights, config, key,
                            temperature, top_k, use_fused=use_fused, int8_stream=int8_stream)
    return state.codes, state.frame_idx


# Frames between the lockstep loop's host reads of the all-done flag: each
# read drains the device queue, so the host stops enqueueing ahead.
_SYNC_EVERY = 8


@dataclasses.dataclass
class BatchedDecodeState:
    """What the lockstep loop carries: one write position for all streams."""
    k_cache: torch.Tensor      # [B, L, max_seq, d_model], updated in place
    v_cache: torch.Tensor      # [B, L, max_seq, d_model], updated in place
    hidden: torch.Tensor       # [B, d_model]
    step: int                  # frames attempted so far
    frame_idx: torch.Tensor    # [B] int32 frames kept per stream (freezes at EOS)
    codes: torch.Tensor        # [B, max_dec_steps, 8] int32
    done: torch.Tensor         # [B] bool


def synthesize_codes_batched_program(
        tokens: torch.Tensor, enc_lengths: Sequence[int], speaker_ids: Sequence[int],
        keys: Sequence[Tuple[int, int]], temperature: float, weights: MagpieWeights,
        config: MagpieConfig, top_k: int, max_steps: Optional[int] = None,
        use_fused: Optional[bool] = None, int8_stream=None,
        prepare_weights: Optional[MagpieWeights] = None):
    """Lockstep batched synthesis: tokens [B, T] -> (codes [B, N, 8] int32,
    n_frames [B] int32), both on the weights' device (``lockstep_loop``'s
    codes and frame counts)."""
    s = lockstep_loop(tokens, enc_lengths, speaker_ids, keys, temperature, weights, config,
                      top_k, max_steps=max_steps, use_fused=use_fused, int8_stream=int8_stream,
                      prepare_weights=prepare_weights)
    return s.codes, s.frame_idx


def lockstep_loop(
        tokens: torch.Tensor, enc_lengths: Sequence[int], speaker_ids: Sequence[int],
        keys: Sequence[Tuple[int, int]], temperature: float, weights: MagpieWeights,
        config: MagpieConfig, top_k: int, max_steps: Optional[int] = None,
        use_fused: Optional[bool] = None, int8_stream=None,
        prepare_weights: Optional[MagpieWeights] = None) -> BatchedDecodeState:
    """The lockstep loop over B streams, returning its final state (the
    hidden rows after the last step run included, which the parity scripts
    read). The B streams are prepared in one ``prepare_batch`` (on
    ``prepare_weights``, default ``weights``).

    Streams that hit EOS idle (their ``frame_idx`` / codes freeze) while the
    rest continue. Per frame, as in the JAX loop: every stream's key splits
    (seeds from the host threefry, uploaded once), ``valid = arange(S) <= pos``
    and ``may_continue = ~done``. The all-done test reads the device every
    ``_SYNC_EVERY`` frames, so up to ``_SYNC_EVERY - 1`` frames may run after
    the last stream finished; they change no kept code. The split path runs
    the batched sampler, the bookkeeping, ``audio_frame_embedding + pos_emb[pos]``
    and the batched decoder step, whose row ``pos`` is valid for every stream
    (as in the JAX split branch). ``int8_stream`` goes to both batched
    kernels' stream slot.
    """
    max_steps = max_steps or config.max_dec_steps
    fused = resolve_use_fused(use_fused)
    with torch.no_grad():
        weights = materialize_weights(weights)
        device = weights.text_emb.device
        xa_k, xa_v, k_rows, v_rows, hidden = prepare_batch(
            tokens, enc_lengths, speaker_ids, prepare_weights or weights, config)
        B, L, n_rows, D = k_rows.shape
        k_cache = k_rows.new_zeros(B, L, config.max_seq, D)
        v_cache = torch.zeros_like(k_cache)
        k_cache[:, :, :n_rows] = k_rows
        v_cache[:, :, :n_rows] = v_rows
        seeds, _ = sampling.frame_seeds_batch(np.array(keys, np.uint32), max_steps)
        seeds = torch.from_numpy(seeds).to(device)                          # [steps, B]
        enc = torch.tensor(list(enc_lengths), dtype=torch.int32, device=device)
        s = BatchedDecodeState(
            k_cache=k_cache, v_cache=v_cache, hidden=hidden, step=0,
            frame_idx=torch.zeros(B, dtype=torch.int32, device=device),
            codes=torch.zeros(B, max_steps, config.num_codebooks, dtype=torch.int32,
                              device=device),
            done=torch.zeros(B, dtype=torch.bool, device=device))
        rows = torch.arange(config.max_seq, device=device)
        while s.step < max_steps:
            if s.step and s.step % _SYNC_EVERY == 0 and bool(s.done.all()):
                break
            pos = config.context_frames + 1 + s.step
            valid = (rows <= pos)[None].expand(B, -1)
            posemb = weights.decoder.pos_emb[pos][None].expand(B, -1)
            forbid = s.frame_idx < config.min_generated_frames
            if fused:
                sampled, argmax, s.hidden, _, _ = frame_step_batched(
                    s.hidden, pos, valid, ~s.done, posemb, xa_k, xa_v, s.k_cache, s.v_cache,
                    weights, config, enc, seeds[s.step], temperature, top_k, forbid,
                    rows=pos + 1, stream=int8_stream)
            else:
                sampled, argmax = sample_frame_codes_batched(s.hidden, weights, config,
                                                             seeds[s.step], temperature, top_k,
                                                             forbid)
            is_eos = ((sampled == config.audio_eos_id) | (argmax == config.audio_eos_id)).any(-1)
            s.done = s.done | is_eos
            s.codes[:, s.step] = sampled
            s.frame_idx = torch.where(s.done, s.frame_idx, s.frame_idx + 1)
            if not fused:
                x_pe = audio_frame_embedding(sampled, weights, config) + posemb
                s.hidden = decode_step_batched(x_pe, pos, valid, xa_k, xa_v, s.k_cache,
                                               s.v_cache, weights, config, enc, rows=pos + 1,
                                               stream=int8_stream)
            s.step += 1
    return s
