"""Local transformer (magpie_tts_tpu/models/local_transformer.py): per-frame
autoregressive sampling of the 8 codebook codes, plain PyTorch.

The growing sequence lives in a fixed [9, lt_dim] buffer; the single LT layer
is causal, so row ``cb`` only attends to the filled prefix. The layer keeps
the frame-step kernel's rounding points (float32 residual carry, float32
products and sums, a round to the weight dtype only where the JAX source
writes ``.astype(wdt)``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import MagpieConfig
from ..io.magpie_weights import LocalTransformerWeights, MagpieWeights
from ..ops import sampling
from ..ops.attention import attn_scale
from ..ops.conv_ffn import gelu
from ..ops.norms import layer_norm
from ..ops.precision import matmul_f32

_MAX_SEQ = 9  # decoder hidden + up to 8 code embeddings


def _in_proj(x: torch.Tensor, lt: LocalTransformerWeights) -> torch.Tensor:
    """768 -> lt_dim projection with the bias added in float32."""
    return (matmul_f32(x, lt.in_proj_w) + lt.in_proj_b.float()).to(x.dtype)


def _lt_layer_f32(seq_buf: torch.Tensor, lt: LocalTransformerWeights,
                  config: MagpieConfig) -> torch.Tensor:
    """The causal LT layer over the whole [9, lt_dim] buffer, float32 out."""
    wdt = seq_buf.dtype
    x = seq_buf.float() + lt.pos_emb[:_MAX_SEQ].float()
    h = layer_norm(x, lt.norm_self, config.eps).to(wdt)
    qkv = matmul_f32(h, lt.qkv)
    d = config.lt_dim
    q, k, v = (qkv[:, i * d:(i + 1) * d].to(wdt) for i in range(3))
    scores = matmul_f32(q, k.T) * attn_scale(d)  # single head, d_head = lt_dim
    idx = torch.arange(_MAX_SEQ, device=x.device)
    scores = torch.where(idx[None, :] <= idx[:, None], scores,
                         torch.full_like(scores, sampling.NEG_INF))
    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores)
    probs = (probs / probs.sum(dim=-1, keepdim=True)).to(wdt)
    attn = matmul_f32(probs, v)
    x = x + matmul_f32(attn.to(wdt), lt.sa_out)
    h2 = layer_norm(x, lt.norm_ff, config.eps).to(wdt)
    ff = gelu(matmul_f32(h2, lt.ff_proj), approximate=config.gelu_tanh).to(wdt)
    return x + matmul_f32(ff, lt.ff_out)


def sample_frame_codes(decoder_hidden: torch.Tensor, weights: MagpieWeights,
                       config: MagpieConfig, seed: int, temperature: float,
                       top_k: int, forbid_eos: bool,
                       static_forbidden_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """decoder_hidden: [d_model] -> (sampled [8], argmax [8]) int32 codes.

    ``seed`` is the frame's int32 seed (``sampling.seed_from_key``); each
    codebook phase draws its noise from ``phase_seed(seed, cb)``.
    """
    lt = weights.lt
    seq_buf = torch.zeros(_MAX_SEQ, config.lt_dim, dtype=decoder_hidden.dtype,
                          device=decoder_hidden.device)
    seq_buf[0] = _in_proj(decoder_hidden, lt)
    sampled, argmaxed = [], []
    for cb in range(config.num_codebooks):
        hidden = _lt_layer_f32(seq_buf, lt, config)[cb]
        logits = (matmul_f32(hidden.to(decoder_hidden.dtype), lt.out_proj_w[cb])
                  + lt.out_proj_b[cb].float())
        logits = sampling.mask_logits(logits, static_forbidden_mask, forbid_eos,
                                      config.audio_eos_id)
        code, amax = sampling.sample_top_k_deterministic(seed, cb, logits,
                                                         temperature, top_k)
        sampled.append(code)
        argmaxed.append(amax)
        # Embed the sampled code with THIS codebook's table, re-project, append.
        if cb < config.num_codebooks - 1:
            seq_buf[cb + 1] = _in_proj(weights.audio_emb[cb, code.long()], lt)
    return torch.stack(sampled), torch.stack(argmaxed)
