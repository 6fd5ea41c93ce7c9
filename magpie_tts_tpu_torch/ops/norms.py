"""LayerNorm without bias (magpie_tts_tpu/ops/norms.py): statistics in float32."""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * weight over the last axis. No bias."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    normed = centered / torch.sqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
