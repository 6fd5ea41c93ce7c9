"""Attention primitives (magpie_tts_tpu/ops/attention.py), plain PyTorch.

Softmax and score math run in float32; scaling is 1/sqrt(d_head) applied to
the scores. The feature dimension splits into heads as ``f -> (f // d_head,
f % d_head)``, the checkpoint's fused-QKV layout.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[..., seq, n_heads*d_head] -> [..., n_heads, seq, d_head]."""
    *batch, seq, d = x.shape
    return x.reshape(*batch, seq, n_heads, d // n_heads).transpose(-2, -3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., n_heads, seq, d_head] -> [..., seq, n_heads*d_head]."""
    x = x.transpose(-2, -3)
    *batch, seq, h, d = x.shape
    return x.reshape(*batch, seq, h * d)


def attn_scale(d_head: int) -> float:
    """1/sqrt(d_head) rounded as float32 arithmetic rounds it."""
    s = torch.tensor(float(d_head), dtype=torch.float32)
    return float(1.0 / torch.sqrt(s))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [..., H, Tq, D], k/v: [..., H, Tk, D]; mask (bool, True = attend)
    broadcastable to [..., H, Tq, Tk]."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * attn_scale(q.shape[-1])
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(v.dtype)


def mha_full(x: torch.Tensor, qkv_w: torch.Tensor, out_w: torch.Tensor,
             n_heads: int) -> torch.Tensor:
    """Full-sequence causal self-attention. x: [..., seq, d_model];
    qkv_w: [d_model, 3*d_model]; out_w: [d_model, d_model]."""
    seq = x.shape[-2]
    qkv = torch.matmul(x, qkv_w).to(x.dtype)
    q, k, v = (_split_heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
    idx = torch.arange(seq, device=x.device)
    out = _merge_heads(attend(q, k, v, idx[None, :] <= idx[:, None]))
    return torch.matmul(out, out_w).to(x.dtype)


def precompute_cross_attention_kv(memory_normed: torch.Tensor, xa_kv_w: torch.Tensor):
    """memory_normed: [enc_seq, d_model]; xa_kv_w: [d_model, 2*d_xa] ->
    (k, v) each [enc_seq, d_xa]; K is the first half of the fused output."""
    kv = torch.matmul(memory_normed, xa_kv_w).to(memory_normed.dtype)
    d_xa = xa_kv_w.shape[-1] // 2
    return kv[..., :d_xa], kv[..., d_xa:]


def cross_attention(query: torch.Tensor, xa_k: torch.Tensor, xa_v: torch.Tensor,
                    q_w: torch.Tensor, out_w: torch.Tensor, n_heads: int,
                    enc_length: Optional[int] = None) -> torch.Tensor:
    """query: [..., Tq, d_model] (already normed); xa_k/xa_v: [enc_seq, d_xa].
    ``enc_length`` masks padded encoder key positions."""
    q = torch.matmul(query, q_w).to(query.dtype)
    qh = _split_heads(q, n_heads)
    kh = _split_heads(xa_k, n_heads)
    vh = _split_heads(xa_v, n_heads)
    mask = None
    if enc_length is not None:
        mask = (torch.arange(xa_k.shape[-2], device=xa_k.device) < enc_length)[None, None, :]
    out = _merge_heads(attend(qh, kh, vh, mask))
    return torch.matmul(out, out_w)

