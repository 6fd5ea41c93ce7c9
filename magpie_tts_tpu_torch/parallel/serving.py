"""Lockstep batched serving (magpie_tts_tpu/parallel/serving.py) on one device.

B utterances decode in lockstep: one ``frame_step_batched`` call per frame
(split path: the batched sampler and decoder step) until every stream hit
EOS or the step budget. The JAX engine's ``mesh``
(data parallelism over chips) is not ported here; more than one device is
``continuous.MultiChipContinuousServer``'s job.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import MagpieConfig
from ..io.magpie_weights import MagpieWeights
from ..models import magpie as magpie_mod
from ..ops import sampling
from ..runtime.engine import check_dtype, pick_bucket, resolve_device, split_to_buckets


def batched_synthesize_program(tokens: torch.Tensor, enc_lengths: Sequence[int],
                               speaker_ids: Sequence[int], keys, temperature: float,
                               weights: MagpieWeights, config: MagpieConfig, top_k: int,
                               use_fused: Optional[bool] = None):
    """tokens [B, T]; enc_lengths, speaker_ids: B ints; keys: B (k0, k1).
    Returns (codes [B, N, 8], n_frames [B]) on the weights' device."""
    return magpie_mod.synthesize_codes_batched_program(
        tokens, enc_lengths, speaker_ids, keys, temperature, weights, config, top_k,
        use_fused=use_fused)


class BatchedMagpieEngine:
    """Fixed-batch lockstep serving engine on one device. ``use_fused``
    (None: fused unless MAGPIE_NO_FUSED) picks the fused frame kernel or the
    split sampler + decoder step."""

    def __init__(self, weights: MagpieWeights, config: MagpieConfig, batch_size: int,
                 device="cuda", compute_dtype=torch.float32,
                 token_buckets: Sequence[int] = (32, 64, 128, 256),
                 split_token_id: int = 93, use_fused: Optional[bool] = None):
        check_dtype(compute_dtype)
        self.config = config
        self.use_fused = use_fused
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.weights = weights.to(device=self.device, dtype=compute_dtype)
        self.token_buckets = tuple(token_buckets)
        self.split_token_id = split_token_id

    def synthesize_batch_audio(self, token_id_lists, codec_engine, **kwargs):
        """Batched codes + batched vocoding. Returns a list of waveforms."""
        return codec_engine.decode_batch(self.synthesize_batch(token_id_lists, **kwargs))

    def synthesize_batch(self, token_id_lists, *, speaker_ids=None, temperature: float = 0.7,
                         top_k: int = 80, seed: int = 0):
        """Synthesize up to ``batch_size`` utterances in lockstep.

        Inputs longer than the largest token bucket split at word boundaries;
        the chunks join the lockstep batch as extra rows (in waves of
        ``batch_size``) and each request's codes are re-concatenated. Keys
        are the JAX engine's: ``fold_in(PRNGKey(seed), i)`` per row, or
        ``fold_in(fold_in(PRNGKey(seed), r), k)`` for chunk k of request r.
        Returns a list of codes [n_frames_i, 8] int32.
        """
        B = self.batch_size
        if len(token_id_lists) > B:
            raise ValueError(f"{len(token_id_lists)} requests exceed batch size {B}")
        c = self.config
        per_request = [split_to_buckets(ids, self.token_buckets, self.split_token_id,
                                        c.text_bos_id, c.text_eos_id)
                       for ids in token_id_lists]
        speaker_ids = (np.zeros(len(token_id_lists), np.int32) if speaker_ids is None
                       else np.asarray(speaker_ids, np.int32))
        base = sampling.prng_key(seed)
        if all(len(ch) == 1 for ch in per_request):
            keys = [sampling.fold_in(base, i) for i in range(B)]
            return self._dispatch_wave([ch[0] for ch in per_request], speaker_ids, keys,
                                       temperature, top_k)

        work = [(r, k, chunk) for r, chunks in enumerate(per_request)
                for k, chunk in enumerate(chunks)]
        results = [[None] * len(ch) for ch in per_request]
        for w0 in range(0, len(work), B):
            wave = work[w0: w0 + B]
            keys = [sampling.fold_in(sampling.fold_in(base, r), k) for r, k, _ in wave]
            spk = np.asarray([speaker_ids[r] for r, _, _ in wave], np.int32)
            parts = self._dispatch_wave([ch for _, _, ch in wave], spk, keys, temperature,
                                        top_k)
            for (r, k, _), codes in zip(wave, parts):
                results[r][k] = codes
        return [np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
                for parts in results]

    def _dispatch_wave(self, chunk_lists, speaker_ids, keys, temperature, top_k):
        """One lockstep run over <= B token chunks, padded to B rows (padding
        rows: one token, speaker 0, zero key). Returns per-chunk codes."""
        B = self.batch_size
        bucket = pick_bucket(self.token_buckets, max(len(ch) for ch in chunk_lists))
        tokens = np.zeros((B, bucket), np.int64)
        enc_lengths = np.ones(B, np.int64)
        spk = np.zeros(B, np.int64)
        for i, ids in enumerate(chunk_lists):
            tokens[i, :len(ids)] = ids
            enc_lengths[i] = len(ids)
            spk[i] = speaker_ids[i]
        keys = list(keys) + [(0, 0)] * (B - len(keys))
        codes, n_frames = batched_synthesize_program(
            torch.from_numpy(tokens).to(self.device), enc_lengths.tolist(), spk.tolist(),
            keys, temperature, self.weights, self.config, top_k, use_fused=self.use_fused)
        codes, n_frames = codes.cpu().numpy(), n_frames.cpu().numpy()
        return [codes[i, :n_frames[i]] for i in range(len(chunk_lists))]
