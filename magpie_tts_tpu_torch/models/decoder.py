"""Main decoder (magpie_tts_tpu/models/decoder.py): 12 pre-norm layers
(causal SA, 1-head XA, pointwise FFN), plain PyTorch.

- ``decode_full``       the full-sequence forward over [context; frames]: the
                        uncached oracle of ``models.standard`` and the traces.
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

The decode steps take a ``stream``: None (the dense weights), an
``Int8DecoderStream`` or a ``Q8DecoderStream``, which then supplies the four
streamed matrices (``stream_matmul``, the plain version of every stream
kernel). ``prefill`` always runs on the dense weights, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..config import MagpieConfig
from ..io.magpie_weights import DecoderWeights, Int8DecoderStream, MagpieWeights, Q8DecoderStream
from ..ops.attention import (_merge_heads, _split_heads, attend, cross_attention, mha_full,
                             precompute_cross_attention_kv)
from ..ops.conv_ffn import conv_ffn, gelu
from ..ops.norms import layer_norm
from ..ops.precision import matmul_f32


def stream_matmul(x: torch.Tensor, dec: DecoderWeights, stream, name: str,
                  layer: int) -> torch.Tensor:
    """``x @ W`` of streamed matrix ``name`` at ``layer``, float32 (products
    and sum, unrounded): dense ``x @ W``; int8 ``(x @ q) * s`` (the TPU
    kernels' out_scale order; int8 values are exact in x's dtype); Q8
    ``x @ (repeat(s, 32, in-axis) * q)`` with the exact f32 dequant rounded to
    x's dtype first (the kernels' stream_w), so the product equals the dense
    one on the weights dequantized at load in that dtype."""
    if stream is None:
        return matmul_f32(x, getattr(dec, name)[layer])
    if isinstance(stream, Int8DecoderStream):
        q = getattr(stream, f"{name}_q")[layer]
        return matmul_f32(x, q) * getattr(stream, f"{name}_s")[layer]
    if isinstance(stream, Q8DecoderStream):
        q = getattr(stream, f"{name}_q")[layer].float()
        s = getattr(stream, f"{name}_bs")[layer]
        return matmul_f32(x, (torch.repeat_interleave(s, 32, dim=0) * q).to(x.dtype))
    raise TypeError(f"not a decoder stream: {type(stream).__name__}")


def precompute_xa_kv(enc_out: torch.Tensor, dec: DecoderWeights,
                     config: MagpieConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """enc_out: [..., enc_seq, d_model] -> (xa_k, xa_v) each
    [..., L, enc_seq, d_xa]. The memory norm is folded into this precompute."""
    ks, vs = [], []
    for l in range(dec.qkv.shape[0]):
        mem = layer_norm(enc_out, dec.norm_xa_mem[l], config.eps)
        k, v = precompute_cross_attention_kv(mem, dec.xa_kv[l])
        ks.append(k)
        vs.append(v)
    return torch.stack(ks, dim=-3).contiguous(), torch.stack(vs, dim=-3).contiguous()


def layer_weights(dec: DecoderWeights, l: int) -> tuple:
    """Decoder layer ``l``'s weights in ``_layer_full``'s order."""
    return (dec.norm_self[l], dec.qkv[l], dec.sa_out[l], dec.norm_xa_q[l], dec.norm_xa_mem[l],
            dec.xa_q[l], dec.xa_kv[l], dec.xa_out[l], dec.norm_ff[l], dec.ff_proj[l],
            dec.ff_out[l])


def _layer_full(x: torch.Tensor, enc_out: torch.Tensor, lw, config: MagpieConfig,
                enc_length=None) -> torch.Tensor:
    """One decoder layer over a whole sequence x [seq, d_model]: causal
    self-attention, cross-attention with K/V recomputed from the encoder
    output's memory norm, then the pointwise FFN; each sublayer's output
    rounds to x's dtype, as in the JAX source."""
    (norm_self, qkv, sa_out, norm_xa_q, norm_xa_mem, xa_q, xa_kv, xa_out,
     norm_ff, ff_proj, ff_out) = lw
    h = layer_norm(x, norm_self, config.eps)
    x = x + mha_full(h, qkv, sa_out, config.dec_sa_heads)
    q = layer_norm(x, norm_xa_q, config.eps)
    mem = layer_norm(enc_out, norm_xa_mem, config.eps)
    k, v = precompute_cross_attention_kv(mem, xa_kv)
    x = x + cross_attention(q, k, v, xa_q, xa_out, config.dec_xa_heads, enc_length=enc_length)
    h = layer_norm(x, norm_ff, config.eps)
    return x + conv_ffn(h, ff_proj, ff_out, gelu_tanh=config.gelu_tanh)


def decode_full(dec_input: torch.Tensor, enc_out: torch.Tensor, weights: MagpieWeights,
                config: MagpieConfig, enc_length=None) -> torch.Tensor:
    """Full-sequence decoder: dec_input [seq, d_model] (context + frame
    embeddings, position embeddings added here from offset 0), enc_out
    [enc_seq, d_model] -> the normed output [seq, d_model]. Row
    ``context_frames`` of ``[context; BOS]`` is the BOS-step hidden that
    ``models.magpie.prepare`` computes with its cache."""
    dec = weights.decoder
    x = dec_input + dec.pos_emb[:dec_input.shape[-2]]
    for l in range(dec.qkv.shape[0]):
        x = _layer_full(x, enc_out, layer_weights(dec, l), config, enc_length)
    return layer_norm(x, dec.norm_out, config.eps)


def prefill(context: torch.Tensor, xa_k: torch.Tensor, xa_v: torch.Tensor,
            k_cache: torch.Tensor, v_cache: torch.Tensor,
            weights: MagpieWeights, config: MagpieConfig,
            enc_length: Union[int, torch.Tensor, None] = None) -> None:
    """Run the speaker-context frames [..., T_ctx, d_model] through all
    layers, writing their K/V into ``cache[..., :, :T_ctx]`` (caches
    [..., L, rows, d_model]) in place. xa_k / xa_v: [..., L, enc_seq, d_xa];
    ``enc_length``: an int, or one length per leading index."""
    dec = weights.decoder
    t_ctx = context.shape[-2]
    x = context + dec.pos_emb[:t_ctx]
    idx = torch.arange(t_ctx, device=x.device)
    mask = (idx[None, :] <= idx[:, None])[None]
    for l in range(dec.qkv.shape[0]):
        h = layer_norm(x, dec.norm_self[l], config.eps)
        qkv = matmul_f32(h, dec.qkv[l]).to(x.dtype)
        q, k_new, v_new = qkv.chunk(3, dim=-1)
        k_cache[..., l, :t_ctx, :] = k_new
        v_cache[..., l, :t_ctx, :] = v_new
        qh, kh, vh = (_split_heads(t, config.dec_sa_heads) for t in (q, k_new, v_new))
        attn = _merge_heads(attend(qh, kh, vh, mask))
        x = x + matmul_f32(attn, dec.sa_out[l]).to(x.dtype)
        qn = layer_norm(x, dec.norm_xa_q[l], config.eps)
        x = x + cross_attention(qn, xa_k[..., l, :, :], xa_v[..., l, :, :], dec.xa_q[l],
                                dec.xa_out[l], config.dec_xa_heads,
                                enc_length=enc_length).to(x.dtype)
        h = layer_norm(x, dec.norm_ff[l], config.eps)
        x = x + conv_ffn(h, dec.ff_proj[l], dec.ff_out[l], gelu_tanh=config.gelu_tanh)


def decode_step(x: torch.Tensor, pos: int, xa_k: torch.Tensor, xa_v: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                weights: MagpieWeights, config: MagpieConfig,
                enc_length: Optional[int] = None, stream=None) -> torch.Tensor:
    """One autoregressive decoder position.

    x: [d_model] frame embedding (without position); pos: absolute position,
    also the cache row written (in place) before attending; xa_k/xa_v:
    [L, enc_seq, d_xa]; caches: [L, max_seq, d_model]. Returns hidden [d_model].
    """
    valid = torch.arange(k_cache.shape[1], device=x.device) <= pos
    return decode_step_masked(x, pos, pos, valid, xa_k, xa_v, k_cache, v_cache, weights,
                              config, enc_length=enc_length, stream=stream)


def decode_step_masked(x: torch.Tensor, logical_pos, write_row: int, valid_mask: torch.Tensor,
                       xa_k: torch.Tensor, xa_v: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       weights: MagpieWeights, config: MagpieConfig,
                       enc_length: Optional[int] = None, stream=None) -> torch.Tensor:
    """Decoder step with cache row, position embedding and attention
    membership decoupled (the continuous-batching ring cache).

    ``logical_pos`` (int or 0-d tensor) indexes the position-embedding table;
    ``write_row`` is the cache row the new K/V land in (in place);
    ``valid_mask`` [max_seq] bool marks the rows this step attends to (it
    must include ``write_row``). Returns hidden [d_model].
    """
    x_pe = x + weights.decoder.pos_emb[logical_pos]
    return decode_rows(x_pe, write_row, valid_mask, xa_k, xa_v, k_cache, v_cache, weights,
                       config, enc_length=enc_length, stream=stream)


def decode_rows(x_pe: torch.Tensor, write_row: int, valid_mask: torch.Tensor,
                xa_k: torch.Tensor, xa_v: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                weights: MagpieWeights, config: MagpieConfig,
                enc_length: Union[int, torch.Tensor, None] = None,
                stream=None) -> torch.Tensor:
    """The 12 layers of ``decode_step_masked`` on an input that already holds
    its position embedding (the batched frame kernel receives posemb rows).

    x_pe [..., d_model]; valid_mask [..., rows]; xa_k / xa_v
    [..., L, enc_seq, d_xa]; caches [..., L, rows, d_model]; ``enc_length``
    an int or one length per leading index (prepare's BOS step runs M rows
    at once). The residual carry stays float32 and attention covers the
    rows of the whole cache buffer that ``valid_mask`` admits, the
    frame-step kernels' rounding points. ``stream`` supplies qkv / sa_out /
    ff_proj / ff_out (``stream_matmul``).
    """
    dec = weights.decoder
    n_heads = config.dec_sa_heads
    d_model = config.d_model
    wdt = x_pe.dtype
    xf = x_pe.float()
    lead = x_pe.shape[:-1]
    length_mask = valid_mask[..., None, None, :]

    for l in range(dec.qkv.shape[0]):
        h = layer_norm(xf, dec.norm_self[l], config.eps).to(wdt)
        qkv = stream_matmul(h, dec, stream, "qkv", l).to(wdt)
        q = qkv[..., :d_model]
        k_cache[..., l, write_row, :] = qkv[..., d_model:2 * d_model]
        v_cache[..., l, write_row, :] = qkv[..., 2 * d_model:]
        qh = q.reshape(*lead, n_heads, 1, d_model // n_heads)
        kh = _split_heads(k_cache[..., l, :, :], n_heads)
        vh = _split_heads(v_cache[..., l, :, :], n_heads)
        attn = attend(qh, kh.to(wdt), vh.to(wdt), length_mask).reshape(*lead, d_model)
        xf = xf + stream_matmul(attn, dec, stream, "sa_out", l)

        q = layer_norm(xf, dec.norm_xa_q[l], config.eps).to(wdt)
        xf = xf + cross_attention(q[..., None, :], xa_k[..., l, :, :], xa_v[..., l, :, :],
                                  dec.xa_q[l], dec.xa_out[l], config.dec_xa_heads,
                                  enc_length=enc_length, out_dtype=torch.float32)[..., 0, :]

        h = layer_norm(xf, dec.norm_ff[l], config.eps).to(wdt)
        f = gelu(stream_matmul(h, dec, stream, "ff_proj", l),
                 approximate=config.gelu_tanh).to(wdt)
        xf = xf + stream_matmul(f, dec, stream, "ff_out", l)

    return layer_norm(xf, dec.norm_out, config.eps).to(wdt)
