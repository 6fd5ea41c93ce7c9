"""Main decoder (magpie_tts_tpu/models/decoder.py): 12 pre-norm layers
(causal SA, 1-head XA, pointwise FFN), plain PyTorch.

- ``precompute_xa_kv``  cross-attention K/V from the encoder output, once per utterance.
- ``prefill``           the speaker-context frames through all layers, filling the cache.
- ``decode_step``       one autoregressive position against the fixed-capacity cache;
                        the plain version of the frame-step kernel's decoder half.
- ``decode_step_masked`` the same with the cache row, the position embedding and
                        the attended rows decoupled (continuous batching's ring
                        cache); ``decode_rows`` is its body, the plain version of
                        the batched frame kernel's decoder half.

Cache layout: ``[n_layers, max_seq, d_model]`` for K and V. ``decode_step``
writes the new row in place (the JAX version returns updated copies).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import MagpieConfig
from ..io.magpie_weights import DecoderWeights, MagpieWeights
from ..ops.attention import attend, cross_attention, precompute_cross_attention_kv
from ..ops.conv_ffn import conv_ffn, conv_ffn_step
from ..ops.norms import layer_norm


def precompute_xa_kv(enc_out: torch.Tensor, dec: DecoderWeights,
                     config: MagpieConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """enc_out: [enc_seq, d_model] -> (xa_k, xa_v) each [L, enc_seq, d_xa].
    The memory norm is folded into this precompute."""
    ks, vs = [], []
    for l in range(dec.qkv.shape[0]):
        mem = layer_norm(enc_out, dec.norm_xa_mem[l], config.eps)
        k, v = precompute_cross_attention_kv(mem, dec.xa_kv[l])
        ks.append(k)
        vs.append(v)
    return torch.stack(ks).contiguous(), torch.stack(vs).contiguous()


def prefill(context: torch.Tensor, xa_k: torch.Tensor, xa_v: torch.Tensor,
            k_cache: torch.Tensor, v_cache: torch.Tensor,
            weights: MagpieWeights, config: MagpieConfig,
            enc_length: Optional[int] = None) -> None:
    """Run the speaker-context frames [T_ctx, d_model] through all layers,
    writing their K/V into ``cache[:, :T_ctx]`` in place."""
    dec = weights.decoder
    t_ctx = context.shape[0]
    n_heads = config.dec_sa_heads
    d_head = config.d_model // n_heads
    x = context + dec.pos_emb[:t_ctx]
    idx = torch.arange(t_ctx, device=x.device)
    mask = (idx[None, :] <= idx[:, None])[None]
    for l in range(dec.qkv.shape[0]):
        h = layer_norm(x, dec.norm_self[l], config.eps)
        qkv = torch.matmul(h, dec.qkv[l]).to(x.dtype)
        q, k_new, v_new = qkv.chunk(3, dim=-1)
        k_cache[l, :t_ctx] = k_new
        v_cache[l, :t_ctx] = v_new
        qh, kh, vh = (t.reshape(t_ctx, n_heads, d_head).transpose(0, 1)
                      for t in (q, k_new, v_new))
        attn = attend(qh, kh, vh, mask).transpose(0, 1).reshape(t_ctx, config.d_model)
        x = x + torch.matmul(attn, dec.sa_out[l]).to(x.dtype)
        qn = layer_norm(x, dec.norm_xa_q[l], config.eps)
        x = x + cross_attention(qn, xa_k[l], xa_v[l], dec.xa_q[l], dec.xa_out[l],
                                config.dec_xa_heads, enc_length=enc_length).to(x.dtype)
        h = layer_norm(x, dec.norm_ff[l], config.eps)
        x = x + conv_ffn(h, dec.ff_proj[l], dec.ff_out[l], gelu_tanh=config.gelu_tanh)


def decode_step(x: torch.Tensor, pos: int, xa_k: torch.Tensor, xa_v: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                weights: MagpieWeights, config: MagpieConfig,
                enc_length: Optional[int] = None) -> torch.Tensor:
    """One autoregressive decoder position.

    x: [d_model] frame embedding (without position); pos: absolute position,
    also the cache row written (in place) before attending; xa_k/xa_v:
    [L, enc_seq, d_xa]; caches: [L, max_seq, d_model]. Returns hidden [d_model].
    """
    valid = torch.arange(k_cache.shape[1], device=x.device) <= pos
    return decode_step_masked(x, pos, pos, valid, xa_k, xa_v, k_cache, v_cache, weights,
                              config, enc_length=enc_length)


def decode_step_masked(x: torch.Tensor, logical_pos, write_row: int, valid_mask: torch.Tensor,
                       xa_k: torch.Tensor, xa_v: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       weights: MagpieWeights, config: MagpieConfig,
                       enc_length: Optional[int] = None) -> torch.Tensor:
    """Decoder step with cache row, position embedding and attention
    membership decoupled (the continuous-batching ring cache).

    ``logical_pos`` (int or 0-d tensor) indexes the position-embedding table;
    ``write_row`` is the cache row the new K/V land in (in place);
    ``valid_mask`` [max_seq] bool marks the rows this step attends to (it
    must include ``write_row``). Returns hidden [d_model].
    """
    x_pe = x + weights.decoder.pos_emb[logical_pos]
    return decode_rows(x_pe, write_row, valid_mask, xa_k, xa_v, k_cache, v_cache, weights,
                       config, enc_length=enc_length)


def decode_rows(x_pe: torch.Tensor, write_row: int, valid_mask: torch.Tensor,
                xa_k: torch.Tensor, xa_v: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                weights: MagpieWeights, config: MagpieConfig,
                enc_length: Optional[int] = None) -> torch.Tensor:
    """The 12 layers of ``decode_step_masked`` on an input that already holds
    its position embedding (the batched frame kernel receives posemb rows).

    The residual carry stays float32 and attention covers the rows of the
    whole ``max_seq`` buffer that ``valid_mask`` admits, the frame-step
    kernels' rounding points.
    """
    dec = weights.decoder
    n_heads = config.dec_sa_heads
    d_model = config.d_model
    d_head = d_model // n_heads
    wdt = x_pe.dtype
    xf = x_pe.float()
    max_seq = k_cache.shape[1]
    length_mask = valid_mask[None, None, :]

    for l in range(dec.qkv.shape[0]):
        h = layer_norm(xf, dec.norm_self[l], config.eps).to(wdt)
        qkv = torch.matmul(h, dec.qkv[l]).to(wdt)
        q = qkv[:d_model]
        k_cache[l, write_row] = qkv[d_model:2 * d_model]
        v_cache[l, write_row] = qkv[2 * d_model:]
        qh = q.reshape(n_heads, 1, d_head)
        kh = k_cache[l].reshape(max_seq, n_heads, d_head).transpose(0, 1)
        vh = v_cache[l].reshape(max_seq, n_heads, d_head).transpose(0, 1)
        attn = attend(qh, kh.to(wdt), vh.to(wdt), length_mask).reshape(d_model)
        xf = xf + torch.matmul(attn, dec.sa_out[l]).float()

        q = layer_norm(xf, dec.norm_xa_q[l], config.eps).to(wdt)
        xf = xf + cross_attention(q[None, :], xa_k[l], xa_v[l], dec.xa_q[l],
                                  dec.xa_out[l], config.dec_xa_heads,
                                  enc_length=enc_length)[0].float()

        h = layer_norm(xf, dec.norm_ff[l], config.eps).to(wdt)
        xf = xf + conv_ffn_step(h, dec.ff_proj[l], dec.ff_out[l],
                                gelu_tanh=config.gelu_tanh)

    return layer_norm(xf, dec.norm_out, config.eps).to(wdt)
