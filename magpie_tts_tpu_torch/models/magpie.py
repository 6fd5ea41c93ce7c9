"""Magpie pipeline assembly (magpie_tts_tpu/models/magpie.py): embeddings,
prefill, and the autoregressive decode loop.

1. ``prepare``     encoder + XA-KV precompute + context prefill + BOS step (plain PyTorch).
2. ``decode_loop`` a Python loop over frames; each iteration is one call of
                   ``ops.kernels.frame_step.frame_step`` (the CUDA kernel on a
                   CUDA device, the plain LT sampler + embedding + decoder step
                   on the CPU), then the EOS test on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import MagpieConfig
from ..io.magpie_weights import MagpieWeights
from ..ops import sampling
from ..ops.kernels.frame_step import frame_step
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
                key: Tuple[int, int], temperature: float, top_k: int) -> DecodeState:
    """Sample frames until EOS or ``config.max_dec_steps``.

    Per frame: split the key (host threefry, as jax.random.split), run one
    frame step (sample 8 codes, embed, decoder step at ``pos``), then stop on
    EOS (any codebook's sampled or argmax code) — one host sync per frame.
    The EOS frame's codes are written but not counted, as in the JAX loop.
    """
    max_steps = config.max_dec_steps
    seeds = sampling.frame_seeds(key, max_steps)
    s = state
    while not s.done and s.frame_idx < max_steps:
        forbid_eos = s.frame_idx < config.min_generated_frames
        sampled, argmax, s.hidden, s.k_cache, s.v_cache = frame_step(
            s.hidden, s.pos, xa_k, xa_v, s.k_cache, s.v_cache, weights, config,
            seeds[s.frame_idx], temperature, top_k, forbid_eos, enc_length=enc_length)
        sampled, argmax = sampled.cpu(), argmax.cpu()
        s.codes[s.frame_idx] = sampled.numpy()
        s.done = sampling.frame_has_eos(sampled, argmax, config.audio_eos_id)
        if not s.done:
            s.frame_idx += 1
        s.pos += 1
    return s


def synthesize_codes_program(tokens: torch.Tensor, enc_length: int, speaker_id: int,
                             key: Tuple[int, int], temperature: float,
                             weights: MagpieWeights, config: MagpieConfig, top_k: int):
    """The full single-utterance synthesis: returns (codes [max_dec_steps, 8], n_frames)."""
    with torch.no_grad():
        xa_k, xa_v, state = prepare(tokens, enc_length, speaker_id, weights, config)
        state = decode_loop(xa_k, xa_v, state, enc_length, weights, config, key,
                            temperature, top_k)
    return state.codes, state.frame_idx
