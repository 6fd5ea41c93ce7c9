"""The standard (uncached, full-sequence) synthesis path
(magpie_tts_tpu/models/standard.py): the verification oracle of the cached
engine.

Each step rebuilds ``[context; BOS; frames so far]``, runs ``decode_full``
over all of it (O(n^2), plain PyTorch on any device by design, as the JAX
oracle is plain XLA) and samples the frame with the plain LT sampler
``models.local_transformer.sample_frame_codes``. Block-stored weights
(``Q8Blocks``) are dequantized first.

Keys: step i samples with ``seed_from_key(sub_i)``, where ``key, sub_i =
split(key)`` runs from ``prng_key(seed)``: the JAX standard path's chain, so
both packages draw the same codes from the same seed at any temperature. It
is also the chain of the cached engine's offline synthesis
(``MagpieEngine.synthesize_codes``, chunk 0: ``sampling.frame_seeds``), so at
temperature > 0 the two paths agree exactly when their hiddens do. On the CPU
they agree at temperature 0 and at 0.7 on the tiny test configs
(tests/test_torch_oracle.py). The streaming chunks (``decode_chunk``) sample
with ``fold_in(prng_key(seed), chunk)``, another chain: only their greedy
codes compare with this path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import MagpieConfig
from ..io.magpie_weights import MagpieWeights, materialize_weights
from ..ops import sampling
from ..ops.precision import matmul_f32
from . import local_transformer as lt_mod
from .decoder import decode_full
from .encoder import run_encoder
from .magpie import audio_frame_embedding, speaker_context


def synthesize_codes_standard(token_ids: Sequence[int], weights: MagpieWeights,
                              config: MagpieConfig, *, speaker_id: int = 0,
                              temperature: float = 0.0, top_k: int = 80, seed: int = 0,
                              max_steps: Optional[int] = None) -> np.ndarray:
    """Full-sequence synthesis on the weights' device. Returns codes
    [n_frames, 8] int32 (the EOS frame not included)."""
    weights = materialize_weights(weights)
    device = weights.text_emb.device
    max_steps = max_steps or config.max_dec_steps
    out_frames = []
    with torch.no_grad():
        tokens = torch.as_tensor(np.asarray(token_ids, np.int64), device=device)
        enc_out = run_encoder(tokens, weights, config)
        context = speaker_context(weights, speaker_id)
        static_mask = sampling.forbidden_token_mask(config.vocab_per_cb, config.audio_bos_id,
                                                    device=device)
        bos = torch.full((config.num_codebooks,), config.audio_bos_id, dtype=torch.int32,
                         device=device)
        embs = [audio_frame_embedding(bos, weights, config)]
        key = sampling.prng_key(seed)
        for step in range(max_steps):
            frames_emb = torch.stack(embs)
            dec_input = torch.cat([context.to(frames_emb.dtype), frames_emb], dim=0)
            hidden = decode_full(dec_input, enc_out, weights, config)[-1]
            key, sub = sampling.split(key)
            sampled, argmax = lt_mod.sample_frame_codes(
                hidden, weights, config, sampling.seed_from_key(sub), temperature, top_k,
                step < config.min_generated_frames, static_mask)
            sampled_h = sampled.cpu()
            if sampling.frame_has_eos(sampled_h, argmax.cpu(), config.audio_eos_id):
                break
            out_frames.append(sampled_h.numpy())
            embs.append(audio_frame_embedding(sampled, weights, config))
    return (np.stack(out_frames).astype(np.int32) if out_frames
            else np.zeros((0, config.num_codebooks), np.int32))


def final_projection(hidden: torch.Tensor, weights: MagpieWeights) -> torch.Tensor:
    """Linear d_model -> 8 * vocab_per_cb logits + bias, float32 out. Kept for
    checkpoint parity and analysis: sampling uses the local-transformer heads."""
    weights = materialize_weights(weights)
    logits = matmul_f32(hidden, weights.final_proj_w).to(hidden.dtype) + weights.final_proj_b
    return logits.float()
