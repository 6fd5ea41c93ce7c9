"""Nano-codec decoder (magpie_tts_tpu/models/codec.py): FSQ dequantization +
causal HiFiGAN vocoder, activations ``[N, T, C]``.

Every Conv1d (pre-conv, 5 stages x 18 res-block convs, post-conv: 92 per
decode) goes through ``ops.kernels.codec_conv.snake_causal_conv``, which runs
the CUDA kernel on a CUDA tensor and the plain ``half_snake`` +
``causal_conv1d`` below on a CPU tensor. FSQ, the HalfSnake before each
upsample and the grouped ConvTranspose are plain PyTorch, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import CodecConfig
from ..io.codec_weights import CodecWeights, ResBlockWeights
from ..ops.kernels.codec_conv import snake_causal_conv


def fsq_dequantize(codes: torch.Tensor, config: CodecConfig) -> torch.Tensor:
    """codes: [..., 8, T] int -> latent [..., T, 32] float32 (exact integer math)."""
    base = torch.tensor(config.fsq_dim_base, dtype=torch.int64, device=codes.device)
    levels = torch.tensor(config.fsq_levels, dtype=torch.int64, device=codes.device)
    half = levels // 2
    idx = codes.to(torch.int64)[..., :, :, None]             # [..., 8, T, 1]
    nonneg = torch.remainder(torch.div(idx, base, rounding_mode="floor"), levels)
    vals = (nonneg - half).to(torch.float32) / half.to(torch.float32)
    vals = vals.movedim(-3, -2)                              # [..., T, 8, 4]
    return vals.reshape(*vals.shape[:-2], vals.shape[-2] * vals.shape[-1])


def half_snake(x: torch.Tensor, alpha: torch.Tensor, leaky_slope: float = 0.01) -> torch.Tensor:
    """Snake ``x + sin(a*x)^2 / a`` on the first len(alpha) channels,
    LeakyReLU on the rest (handles odd splits: 27 -> 13 + 14)."""
    n_snake = alpha.shape[0]
    first, second = x[..., :n_snake], x[..., n_snake:]
    xf = first.float()
    af = alpha.float()
    s = torch.sin(af * xf)
    snake = (xf + (s * s) / af).to(x.dtype)
    leaky = torch.where(second >= 0, second, leaky_slope * second)
    return torch.cat([snake, leaky], dim=-1)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  dilation: int = 1) -> torch.Tensor:
    """x: [N, T, C_in]; w: [K, C_in, C_out] (WIO); left-pad (K-1)*dilation."""
    k = w.shape[0]
    xt = F.pad(x.transpose(1, 2), ((k - 1) * dilation, 0))
    out = F.conv1d(xt, w.permute(2, 1, 0), dilation=dilation)
    return (out.transpose(1, 2) + b).to(x.dtype)


def grouped_conv_transpose1d(x: torch.Tensor, w_pt: torch.Tensor, b: torch.Tensor,
                             stride: int) -> torch.Tensor:
    """Causal grouped ConvTranspose1d, groups = out_ch, in_ch = 2*out_ch.

    x: [N, T, in_ch]; w_pt: [in_ch, K] with K a multiple of ``stride`` (all
    production stages: K = 2*stride); returns [N, T*stride, out_ch],
    right-trimmed by K - stride. Computed as a broadcast multiply-add over the
    2 input channels of each group plus an overlap-add of the K/stride patches.
    """
    in_ch, k = w_pt.shape
    if k % stride:
        raise ValueError(f"ConvTranspose kernel {k} is not a multiple of stride {stride}")
    out_ch = in_ch // 2
    n, T, _ = x.shape
    m = k // stride
    xp = x.reshape(n, T, out_ch, 2)
    wp = w_pt.reshape(out_ch, 2, k).permute(1, 2, 0)                 # [2, k, out]
    z = (xp[:, :, None, :, 0] * wp[0][None, None] +
         xp[:, :, None, :, 1] * wp[1][None, None])                   # [n, T, k, out]
    z = z.reshape(n, T, m, stride, out_ch)
    out = z[:, :, 0]
    for j in range(1, m):
        shifted = F.pad(z[:, :, j], (0, 0, 0, 0, j, 0))[:, :T]
        out = out + shifted
    return (out.reshape(n, T * stride, out_ch) + b).to(x.dtype)


def residual_block(x: torch.Tensor, blk: ResBlockWeights, dilation: int,
                   leaky_slope: float) -> torch.Tensor:
    h = snake_causal_conv(x, blk.in_conv_w, blk.in_conv_b, blk.in_alpha, dilation,
                          leaky_slope)
    return snake_causal_conv(h, blk.sk_conv_w, blk.sk_conv_b, blk.sk_alpha, 1,
                             leaky_slope, residual=x)


def res_layer(x: torch.Tensor, branches, dilations, leaky_slope: float) -> torch.Tensor:
    """Mean of 3 parallel kernel branches, each 3 sequential dilated blocks."""
    acc = None
    for branch in branches:
        h = x
        for blk, dilation in zip(branch, dilations):
            h = residual_block(h, blk, dilation, leaky_slope)
        acc = h if acc is None else acc + h
    return acc / len(branches)


def codec_decode_latent(latent: torch.Tensor, weights: CodecWeights,
                        config: CodecConfig) -> torch.Tensor:
    """latent: [N, T, latent_dim] -> audio [N, T*hop]."""
    x = snake_causal_conv(latent, weights.pre_conv_w, weights.pre_conv_b, None, 1,
                          config.leaky_slope)
    for stage, stride in zip(weights.stages, config.up_sample_rates):
        x = half_snake(x, stage.act_alpha, config.leaky_slope)
        x = grouped_conv_transpose1d(x, stage.convt_w, stage.convt_b, stride)
        x = res_layer(x, stage.resblocks, config.resblock_dilations, config.leaky_slope)
    x = snake_causal_conv(x, weights.post_conv_w, weights.post_conv_b, weights.post_alpha,
                          1, config.leaky_slope)
    return torch.tanh(x)[..., 0]


def codec_decode(codes: torch.Tensor, weights: CodecWeights,
                 config: CodecConfig) -> torch.Tensor:
    """codes: [8, T] int -> waveform [T*hop] float32 (single utterance)."""
    latent = fsq_dequantize(codes, config).to(weights.pre_conv_w.dtype)
    return codec_decode_latent(latent[None].contiguous(), weights, config)[0]
