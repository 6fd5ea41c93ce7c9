"""Causal conv feed-forward network (magpie_tts_tpu/ops/conv_ffn.py), plain PyTorch.

NeMo ``pos_ff``: causal Conv1d(k) -> GELU -> causal Conv1d(k), no biases.
kernel=1 is a plain MLP; kernel=3 (encoder) is a sum of k shifted matmuls
``y[t] = sum_k x[t - (K-1) + k] @ W[k]``.
"""

from __future__ import annotations

import torch

from .precision import matmul_f32

_SQRT_HALF = 0.7071067811865476
_TANH_C = 0.7978845608028654  # sqrt(2/pi)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU in float32, rounded back to the input dtype.

    The erf form uses ``torch.erf``; the tanh form spells out the ggml formula
    with the op order of magpie_tts_tpu/ops/conv_ffn.py:36-41.
    """
    xf = x.float()
    if approximate:
        inner = _TANH_C * (xf + 0.044715 * xf * xf * xf)
        return (0.5 * xf * (1.0 + torch.tanh(inner))).to(x.dtype)
    return (0.5 * xf * (1.0 + torch.erf(xf * _SQRT_HALF))).to(x.dtype)


def conv1d_causal_shifted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal conv via shifted matmuls. x: [..., seq, in]; w: [k, in, out].
    The k terms are summed in float32 and returned unrounded."""
    k = w.shape[0]
    seq = x.shape[-2]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = None
    for i in range(k):
        term = matmul_f32(xp[..., i:i + seq, :], w[i])
        out = term if out is None else out + term
    return out


def conv_ffn(x: torch.Tensor, proj_w: torch.Tensor, out_w: torch.Tensor,
             gelu_tanh: bool = False) -> torch.Tensor:
    """x: [..., seq, d_model]; proj_w: [k, d_model, d_ffn] or [d_model, d_ffn];
    out_w: [k, d_ffn, d_model] or [d_ffn, d_model]."""
    if proj_w.dim() == 2:  # pointwise (decoder / local transformer)
        h = gelu(matmul_f32(x, proj_w).to(x.dtype), approximate=gelu_tanh)
        return matmul_f32(h, out_w).to(x.dtype)
    h = gelu(conv1d_causal_shifted(x, proj_w).to(x.dtype), approximate=gelu_tanh)
    return conv1d_causal_shifted(h, out_w).to(x.dtype)

