"""Magpie pipeline assembly (magpie_tts_tpu/models/magpie.py): embeddings,
prefill, and the autoregressive decode loops.

1. ``prepare``     encoder + XA-KV precompute + context prefill + BOS step (plain PyTorch).
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
(encoder, prefill, BOS step) always runs on the dense weights. Weights that
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
from ..io.magpie_weights import MagpieWeights, materialize_weights
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


def resolve_use_fused(use_fused: Optional[bool]) -> bool:
    """None -> the fused frame kernels unless MAGPIE_NO_FUSED is set."""
    return not os.environ.get("MAGPIE_NO_FUSED") if use_fused is None else bool(use_fused)


def speaker_context(weights: MagpieWeights, speaker_id: int) -> torch.Tensor:
    """Baked speaker context frames [context_frames, d_model]."""
    return weights.baked_context[speaker_id]


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
    """Everything before the AR loop; tokens may be right-padded to a bucket.
    Returns (xa_k, xa_v, state) with state.hidden the BOS-step output."""
    weights = materialize_weights(weights)
    dtype = weights.text_emb.dtype
    device = weights.text_emb.device
    enc_out = run_encoder(tokens, weights, config)
    xa_k, xa_v = decoder_mod.precompute_xa_kv(enc_out, weights.decoder, config)
    k_cache = torch.zeros(config.dec_layers, config.max_seq, config.d_model,
                          dtype=dtype, device=device)
    v_cache = torch.zeros_like(k_cache)
    context = speaker_context(weights, speaker_id).to(dtype)
    decoder_mod.prefill(context, xa_k, xa_v, k_cache, v_cache, weights, config,
                        enc_length=enc_length)
    bos = torch.full((config.num_codebooks,), config.audio_bos_id, dtype=torch.int32,
                     device=device)
    bos_emb = audio_frame_embedding(bos, weights, config).to(dtype)
    hidden = decoder_mod.decode_step(bos_emb, config.context_frames, xa_k, xa_v, k_cache,
                                     v_cache, weights, config, enc_length=enc_length)
    state = DecodeState(
        k_cache=k_cache, v_cache=v_cache, hidden=hidden, pos=config.context_frames + 1,
        frame_idx=0, codes=np.zeros((config.max_dec_steps, config.num_codebooks), np.int32),
        done=False)
    return xa_k, xa_v, state


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
                             use_fused: Optional[bool] = None, int8_stream=None):
    """The full single-utterance synthesis: returns (codes [max_dec_steps, 8], n_frames)."""
    with torch.no_grad():
        weights = materialize_weights(weights)
        xa_k, xa_v, state = prepare(tokens, enc_length, speaker_id, weights, config)
        state = decode_loop(xa_k, xa_v, state, enc_length, weights, config, key,
                            temperature, top_k, use_fused=use_fused, int8_stream=int8_stream)
    return state.codes, state.frame_idx


def prepare_batch(tokens: torch.Tensor, enc_lengths: Sequence[int], speaker_ids: Sequence[int],
                  weights: MagpieWeights, config: MagpieConfig):
    """``prepare`` of every row of tokens [B, T]. Returns (xa_k, xa_v
    [B, L, T, d_xa], k_cache, v_cache [B, L, max_seq, d_model], hidden [B, d_model])."""
    outs = [prepare(tokens[b], int(enc_lengths[b]), int(speaker_ids[b]), weights, config)
            for b in range(tokens.shape[0])]
    xa_k = torch.stack([o[0] for o in outs])
    xa_v = torch.stack([o[1] for o in outs])
    k_cache = torch.stack([o[2].k_cache for o in outs])
    v_cache = torch.stack([o[2].v_cache for o in outs])
    hidden = torch.stack([o[2].hidden for o in outs])
    return xa_k, xa_v, k_cache, v_cache, hidden


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
        use_fused: Optional[bool] = None, int8_stream=None):
    """Lockstep batched synthesis: tokens [B, T] -> (codes [B, N, 8] int32,
    n_frames [B] int32), both on the weights' device.

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
        xa_k, xa_v, k_cache, v_cache, hidden = prepare_batch(tokens, enc_lengths, speaker_ids,
                                                             weights, config)
        B = tokens.shape[0]
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
    return s.codes, s.frame_idx
