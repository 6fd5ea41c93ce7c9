"""Text encoder (magpie_tts_tpu/models/encoder.py): 6 pre-norm layers of
causal self-attention + causal conv-FFN (k=3).

The encoder attends causally, so right-padded (bucketed) token sequences are
prefix-exact: padding cannot change outputs at valid positions.
"""

from __future__ import annotations

import torch

from ..config import MagpieConfig
from ..io.magpie_weights import MagpieWeights
from ..ops.attention import mha_full
from ..ops.conv_ffn import conv_ffn
from ..ops.norms import layer_norm


def encoder_layer(x: torch.Tensor, lw, config: MagpieConfig) -> torch.Tensor:
    """One pre-norm encoder layer. x: [..., seq, d_model]; ``lw`` = (norm_self,
    qkv, sa_out, norm_ff, ff_proj, ff_out) of that layer."""
    norm_self, qkv, sa_out, norm_ff, ff_proj, ff_out = lw
    h = layer_norm(x, norm_self, config.eps)
    x = x + mha_full(h, qkv, sa_out, config.enc_heads)
    h = layer_norm(x, norm_ff, config.eps)
    return x + conv_ffn(h, ff_proj, ff_out, gelu_tanh=config.gelu_tanh)


def layer_weights(enc, l: int) -> tuple:
    """Encoder layer ``l``'s weights in ``encoder_layer``'s order."""
    return (enc.norm_self[l], enc.qkv[l], enc.sa_out[l], enc.norm_ff[l], enc.ff_proj[l],
            enc.ff_out[l])


def run_encoder(tokens: torch.Tensor, weights: MagpieWeights,
                config: MagpieConfig) -> torch.Tensor:
    """tokens: [seq] int (possibly right-padded) -> encoder output [seq, d_model]."""
    enc = weights.encoder
    seq = tokens.shape[-1]
    x = weights.text_emb[tokens] + enc.pos_emb[:seq]
    for l in range(enc.qkv.shape[0]):
        x = encoder_layer(x, layer_weights(enc, l), config)
    return layer_norm(x, enc.norm_out, config.eps)
