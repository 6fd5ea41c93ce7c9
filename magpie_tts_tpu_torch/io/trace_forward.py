"""Per-layer forward traces for golden-dump parity debugging
(magpie_tts_tpu/io/trace_forward.py).

The same intermediates, dump names and layouts as the JAX package's traces,
computed from the port's plain building blocks, so ``tools.dump_golden``
writes them in the reference's ``.bin`` layout (``io.golden``) and
``tools.verify_golden`` localizes a divergence to one layer. Every trace
runs plain PyTorch on the weights' device (no kernel), full-sequence where
the reference dumps full sequences. Returned dicts map dump names (file
stems) to float32 numpy arrays in [seq, features] / [T, C] order;
``codec_latent`` is [latent_dim, T], the reference's layout.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import CodecConfig, MagpieConfig
from ..models import codec as codec_mod
from ..models import decoder as decoder_mod
from ..models import encoder as encoder_mod
from ..models import local_transformer as lt_mod
from ..models.magpie import audio_frame_embedding, speaker_context
from ..models.standard import final_projection
from ..ops import sampling
from ..ops.norms import layer_norm
from ..ops.precision import matmul_f32
from .codec_weights import CodecWeights
from .magpie_weights import MagpieWeights, materialize_weights


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


@torch.no_grad()
def trace_encoder(tokens: torch.Tensor, weights: MagpieWeights,
                  config: MagpieConfig) -> Dict[str, np.ndarray]:
    """Encoder intermediates: embedding, + position, each layer, final LN."""
    weights = materialize_weights(weights)
    enc = weights.encoder
    tokens = torch.as_tensor(tokens, device=weights.text_emb.device).long()
    out: Dict[str, np.ndarray] = {}
    x = weights.text_emb[tokens]
    out["text_embedding"] = _np(x)
    x = x + enc.pos_emb[:tokens.shape[-1]]
    out["encoder_input"] = _np(x)
    for l in range(config.enc_layers):
        x = encoder_mod.encoder_layer(x, encoder_mod.layer_weights(enc, l), config)
        out[f"encoder_layer_{l}"] = _np(x)
    out["encoder_output"] = _np(layer_norm(x, enc.norm_out, config.eps))
    return out


@torch.no_grad()
def trace_decoder(enc_out: torch.Tensor, weights: MagpieWeights, config: MagpieConfig,
                  speaker_id: int = 0, frames: Optional[np.ndarray] = None
                  ) -> Dict[str, np.ndarray]:
    """Full-sequence decoder intermediates over [context; BOS; frames...]
    (``frames``: optional [n, 8] codes after BOS, the decoder state mid-
    utterance), the cross-attention K/V, and the final projection of the
    last row."""
    weights = materialize_weights(weights)
    dec = weights.decoder
    device = weights.text_emb.device
    enc_out = torch.as_tensor(enc_out, device=device)
    out: Dict[str, np.ndarray] = {}
    codes = np.full((1, config.num_codebooks), config.audio_bos_id, np.int32)
    if frames is not None and len(frames):
        codes = np.concatenate([codes, np.asarray(frames, np.int32)], axis=0)
    emb = audio_frame_embedding(torch.from_numpy(codes).to(device), weights, config)
    context = speaker_context(weights, speaker_id)
    dec_input = torch.cat([context.to(emb.dtype), emb], dim=0)
    out["decoder_input"] = _np(dec_input)
    x = dec_input + dec.pos_emb[:dec_input.shape[0]]
    xa_k, xa_v = decoder_mod.precompute_xa_kv(enc_out, dec, config)
    out["xa_k"] = _np(xa_k)
    out["xa_v"] = _np(xa_v)
    for l in range(config.dec_layers):
        x = decoder_mod._layer_full(x, enc_out, decoder_mod.layer_weights(dec, l), config)
        out[f"decoder_layer_{l}"] = _np(x)
    x = layer_norm(x, dec.norm_out, config.eps)
    out["decoder_output"] = _np(x)
    out["final_proj"] = _np(final_projection(x[-1], weights))
    return out


@torch.no_grad()
def trace_local_transformer(hidden: torch.Tensor, weights: MagpieWeights,
                            config: MagpieConfig) -> Dict[str, np.ndarray]:
    """The greedy LT pass from one decoder hidden [d_model] (its dtype is the
    compute dtype): each codebook's logits before the forbidden-token mask,
    and the greedy codes with EOS allowed."""
    weights = materialize_weights(weights)
    lt = weights.lt
    hidden = torch.as_tensor(hidden, device=weights.text_emb.device)
    wdt = hidden.dtype
    out: Dict[str, np.ndarray] = {}
    seq_buf = torch.zeros(lt_mod._MAX_SEQ, config.lt_dim, dtype=wdt, device=hidden.device)
    seq_buf[0] = lt_mod._in_proj(hidden, lt)
    static_mask = sampling.forbidden_token_mask(config.vocab_per_cb, config.audio_bos_id,
                                                device=hidden.device)
    codes = []
    for cb in range(config.num_codebooks):
        h = lt_mod._lt_layer_f32(seq_buf, lt, config)[cb]
        logits = matmul_f32(h.to(wdt), lt.out_proj_w[cb]) + lt.out_proj_b[cb].float()
        out[f"lt_logits_cb{cb}"] = _np(logits)
        masked = sampling.mask_logits(logits, static_mask, False, config.audio_eos_id)
        code = int(torch.argmax(masked))
        codes.append(code)
        if cb < config.num_codebooks - 1:
            seq_buf[cb + 1] = lt_mod._in_proj(weights.audio_emb[cb, code], lt)
    out["lt_greedy_codes"] = np.asarray(codes, np.float32)
    return out


@torch.no_grad()
def trace_codec(codes: np.ndarray, weights: CodecWeights,
                config: CodecConfig) -> Dict[str, np.ndarray]:
    """Codec intermediates: FSQ latent, pre-conv, each stage's upsample and
    res-layer output, audio; ``codes`` [8, T] or [T, 8]. The stages run the
    plain convs (``res_layer(plain=True)``), never a kernel."""
    device = weights.pre_conv_w.device
    codes = np.asarray(codes, np.int64)
    if codes.shape[0] != config.num_codebooks:
        codes = codes.T  # accept [T, 8] too
    out: Dict[str, np.ndarray] = {}
    latent = codec_mod.fsq_dequantize(torch.from_numpy(np.ascontiguousarray(codes)).to(device),
                                      config)
    out["codec_latent"] = _np(latent).T   # [latent_dim, T], the reference's layout
    x = latent[None].to(weights.pre_conv_w.dtype)
    x = codec_mod.causal_conv1d(x, weights.pre_conv_w, weights.pre_conv_b)
    out["codec_pre_conv"] = _np(x[0])
    for s, (stage, stride) in enumerate(zip(weights.stages, config.up_sample_rates)):
        x = codec_mod.half_snake(x, stage.act_alpha, config.leaky_slope)
        x = codec_mod.grouped_conv_transpose1d(x, stage.convt_w, stage.convt_b, stride)
        out[f"codec_stage{s}_upsample"] = _np(x[0])
        x = codec_mod.res_layer(x, stage.resblocks, config.resblock_dilations,
                                config.leaky_slope, plain=True)
        out[f"codec_stage{s}"] = _np(x[0])
    x = codec_mod.half_snake(x, weights.post_alpha, config.leaky_slope)
    x = codec_mod.causal_conv1d(x, weights.post_conv_w, weights.post_conv_b)
    out["codec_audio"] = _np(torch.tanh(x)[0, :, 0])
    return out
