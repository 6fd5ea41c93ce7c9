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


def run_encoder(tokens: torch.Tensor, weights: MagpieWeights,
                config: MagpieConfig) -> torch.Tensor:
    """tokens: [seq] int (possibly right-padded) -> encoder output [seq, d_model]."""
    enc = weights.encoder
    seq = tokens.shape[-1]
    x = weights.text_emb[tokens] + enc.pos_emb[:seq]
    for l in range(enc.qkv.shape[0]):
        h = layer_norm(x, enc.norm_self[l], config.eps)
        x = x + mha_full(h, enc.qkv[l], enc.sa_out[l], config.enc_heads)
        h = layer_norm(x, enc.norm_ff[l], config.eps)
        x = x + conv_ffn(h, enc.ff_proj[l], enc.ff_out[l], gelu_tanh=config.gelu_tanh)
    return layer_norm(x, enc.norm_out, config.eps)
