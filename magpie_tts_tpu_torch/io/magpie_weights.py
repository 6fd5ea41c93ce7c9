"""Magpie 357M weight containers + GGUF loading + synthetic init (dense only).

The layouts are the JAX package's (magpie_tts_tpu/io/magpie_weights.py): linear
weights transposed at load to ``[in, out]`` so the compute path is ``x @ W``,
per-layer tensors stacked on a leading layer axis, conv-FFN weights ``[k, in,
out]``. Quantized GGUF tensors (Q8_0 / Q4_0) are dequantized to float32 at load.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config import MagpieConfig
from .gguf import GGUFReader
from .tree import flatten_tensors, map_tensors


@dataclasses.dataclass(frozen=True)
class EncoderWeights:
    pos_emb: torch.Tensor        # [max_pos, d_model]
    norm_self: torch.Tensor      # [L, d_model]
    qkv: torch.Tensor            # [L, d_model, 3*d_model]
    sa_out: torch.Tensor         # [L, d_model, d_model]
    norm_ff: torch.Tensor        # [L, d_model]
    ff_proj: torch.Tensor        # [L, k, d_model, d_ffn]
    ff_out: torch.Tensor         # [L, k, d_ffn, d_model]
    norm_out: torch.Tensor       # [d_model]


@dataclasses.dataclass(frozen=True)
class DecoderWeights:
    pos_emb: torch.Tensor        # [max_pos, d_model]
    norm_self: torch.Tensor      # [L, d_model]
    qkv: torch.Tensor            # [L, d_model, 3*d_model]
    sa_out: torch.Tensor         # [L, d_model, d_model]
    norm_xa_q: torch.Tensor      # [L, d_model]
    norm_xa_mem: torch.Tensor    # [L, d_model]
    xa_q: torch.Tensor           # [L, d_model, d_xa]
    xa_kv: torch.Tensor          # [L, d_model, 2*d_xa]
    xa_out: torch.Tensor         # [L, d_xa, d_model]
    norm_ff: torch.Tensor        # [L, d_model]
    ff_proj: torch.Tensor        # [L, d_model, d_ffn]   (kernel=1 -> pointwise)
    ff_out: torch.Tensor         # [L, d_ffn, d_model]
    norm_out: torch.Tensor       # [d_model]


@dataclasses.dataclass(frozen=True)
class LocalTransformerWeights:
    in_proj_w: torch.Tensor      # [d_model, lt_dim]
    in_proj_b: torch.Tensor      # [lt_dim]
    pos_emb: torch.Tensor        # [lt_max_pos, lt_dim]
    norm_self: torch.Tensor      # [lt_dim]
    qkv: torch.Tensor            # [lt_dim, 3*lt_dim]
    sa_out: torch.Tensor         # [lt_dim, lt_dim]
    norm_ff: torch.Tensor        # [lt_dim]
    ff_proj: torch.Tensor        # [lt_dim, lt_ffn_dim]
    ff_out: torch.Tensor         # [lt_ffn_dim, lt_dim]
    out_proj_w: torch.Tensor     # [n_cb, lt_dim, vocab_per_cb]
    out_proj_b: torch.Tensor     # [n_cb, vocab_per_cb]


@dataclasses.dataclass(frozen=True)
class MagpieWeights:
    text_emb: torch.Tensor       # [text_vocab, d_model]
    audio_emb: torch.Tensor      # [n_cb, vocab_per_cb, d_model]
    baked_context: torch.Tensor  # [num_speakers, context_frames, d_model]
    encoder: EncoderWeights
    decoder: DecoderWeights
    final_proj_w: torch.Tensor   # [d_model, n_cb * vocab_per_cb]
    final_proj_b: torch.Tensor   # [n_cb * vocab_per_cb]
    lt: LocalTransformerWeights

    def to(self, device=None, dtype=None) -> "MagpieWeights":
        return map_tensors(self, lambda t: t.to(device=device, dtype=dtype))

    def flatten(self) -> Dict[str, torch.Tensor]:
        return flatten_tensors(self)


_SUBTREES = {"encoder": EncoderWeights, "decoder": DecoderWeights,
             "lt": LocalTransformerWeights}


def magpie_weights_from_numpy(arrays: Mapping[str, np.ndarray],
                              dtype=torch.float32) -> MagpieWeights:
    """Build MagpieWeights from ``{field.path: array}`` (e.g. ``"decoder.qkv"``,
    ``"lt.out_proj_w"``, ``"text_emb"``) — how tests carry the JAX package's
    parameters across. Every field must be present; extra keys raise."""
    used = set()

    def take(key):
        used.add(key)
        return torch.as_tensor(np.array(arrays[key]), dtype=dtype)

    def build(cls, prefix):
        kw = {}
        for f in dataclasses.fields(cls):
            key = f"{prefix}{f.name}"
            sub = _SUBTREES.get(f.name) if not prefix else None
            kw[f.name] = build(sub, key + ".") if sub else take(key)
        return cls(**kw)

    weights = build(MagpieWeights, "")
    extra = set(arrays) - used
    if extra:
        raise KeyError(f"unknown weight keys: {sorted(extra)}")
    return weights


def _t(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.T)


def _conv_ffn_w(x: np.ndarray) -> np.ndarray:
    """PyTorch conv weight [out, in, k] -> [k, in, out]."""
    return np.ascontiguousarray(np.transpose(x, (2, 1, 0)))


def load_magpie_weights(path: str, config: Optional[MagpieConfig] = None,
                        dtype=torch.float32, reader: Optional[GGUFReader] = None):
    """Load a Magpie GGUF checkpoint into (config, MagpieWeights) on the CPU.

    Quantized tensors are dequantized at load (the GGUF reader's f32 path),
    then transformed to the compute layouts exactly as the JAX loader does.
    """
    if reader is None:
        reader = GGUFReader(path)
    if config is None:
        config = MagpieConfig.from_gguf_metadata(reader.metadata)
    get = reader.tensor
    c = config

    def stack(fmt: str, n: int, transform=lambda x: x):
        return np.stack([transform(get(fmt.format(i))) for i in range(n)])

    def conv1(x):
        return _t(x[:, :, 0])

    enc = dict(
        pos_emb=get("encoder.position_embeddings.weight"),
        norm_self=stack("encoder.layers.{}.norm_self.weight", c.enc_layers),
        qkv=stack("encoder.layers.{}.self_attention.qkv_net.weight", c.enc_layers, _t),
        sa_out=stack("encoder.layers.{}.self_attention.o_net.weight", c.enc_layers, _t),
        norm_ff=stack("encoder.layers.{}.norm_pos_ff.weight", c.enc_layers),
        ff_proj=stack("encoder.layers.{}.pos_ff.proj.conv.weight", c.enc_layers,
                      _conv_ffn_w),
        ff_out=stack("encoder.layers.{}.pos_ff.o_net.conv.weight", c.enc_layers,
                     _conv_ffn_w),
        norm_out=get("encoder.norm_out.weight"),
    )
    dec = dict(
        pos_emb=get("decoder.position_embeddings.weight"),
        norm_self=stack("decoder.layers.{}.norm_self.weight", c.dec_layers),
        qkv=stack("decoder.layers.{}.self_attention.qkv_net.weight", c.dec_layers, _t),
        sa_out=stack("decoder.layers.{}.self_attention.o_net.weight", c.dec_layers, _t),
        norm_xa_q=stack("decoder.layers.{}.norm_xattn_query.weight", c.dec_layers),
        norm_xa_mem=stack("decoder.layers.{}.norm_xattn_memory.weight", c.dec_layers),
        xa_q=stack("decoder.layers.{}.cross_attention.q_net.weight", c.dec_layers, _t),
        xa_kv=stack("decoder.layers.{}.cross_attention.kv_net.weight", c.dec_layers, _t),
        xa_out=stack("decoder.layers.{}.cross_attention.o_net.weight", c.dec_layers, _t),
        norm_ff=stack("decoder.layers.{}.norm_pos_ff.weight", c.dec_layers),
        ff_proj=stack("decoder.layers.{}.pos_ff.proj.conv.weight", c.dec_layers, conv1),
        ff_out=stack("decoder.layers.{}.pos_ff.o_net.conv.weight", c.dec_layers, conv1),
        norm_out=get("decoder.norm_out.weight"),
    )
    lp = "local_transformer.layers.0"
    lt = dict(
        in_proj_w=_t(get("local_transformer_in_projection.weight")),
        in_proj_b=get("local_transformer_in_projection.bias"),
        pos_emb=get("local_transformer.position_embeddings.weight"),
        norm_self=get(f"{lp}.norm_self.weight"),
        qkv=_t(get(f"{lp}.self_attention.qkv_net.weight")),
        sa_out=_t(get(f"{lp}.self_attention.o_net.weight")),
        norm_ff=get(f"{lp}.norm_pos_ff.weight"),
        ff_proj=conv1(get(f"{lp}.pos_ff.proj.conv.weight")),
        ff_out=conv1(get(f"{lp}.pos_ff.o_net.conv.weight")),
        out_proj_w=stack("local_transformer_out_projections.{}.weight",
                         c.num_codebooks, _t),
        out_proj_b=stack("local_transformer_out_projections.{}.bias", c.num_codebooks),
    )
    arrays = {
        "text_emb": get("text_embedding.weight"),
        "audio_emb": stack("audio_embeddings.{}.weight", c.num_codebooks),
        "baked_context": get("baked_context_embedding.weight").reshape(
            c.num_speakers, c.context_frames, c.d_model),
        "final_proj_w": _t(get("final_proj.weight")),
        "final_proj_b": get("final_proj.bias"),
    }
    for prefix, sub in (("encoder", enc), ("decoder", dec), ("lt", lt)):
        arrays.update({f"{prefix}.{k}": v for k, v in sub.items()})
    return config, magpie_weights_from_numpy(arrays, dtype=dtype)


def random_magpie_weights(config: MagpieConfig, seed: int = 0, scale: float = 0.02,
                          dtype=torch.float32) -> MagpieWeights:
    """Synthetic weights with realistic scales (tests / benchmarks).

    Draws from ``np.random.default_rng(seed)`` in the JAX package's order
    (magpie_tts_tpu/io/magpie_weights.py random_magpie_weights), so the two
    packages build bit-identical weights from one seed.
    """
    rng = np.random.default_rng(seed)
    c = config

    def w(*shape):
        return rng.normal(0.0, scale, size=shape).astype(np.float32)

    def g(*shape):
        return (1.0 + rng.normal(0.0, 0.05, size=shape)).astype(np.float32)

    # Dict insertion order IS the draw order: keep it field-for-field with
    # the JAX constructor calls (encoder, decoder, LT, then the top level).
    draws = [
        ("encoder.pos_emb", lambda: w(c.max_pos, c.d_model)),
        ("encoder.norm_self", lambda: g(c.enc_layers, c.d_model)),
        ("encoder.qkv", lambda: w(c.enc_layers, c.d_model, 3 * c.d_model)),
        ("encoder.sa_out", lambda: w(c.enc_layers, c.d_model, c.d_model)),
        ("encoder.norm_ff", lambda: g(c.enc_layers, c.d_model)),
        ("encoder.ff_proj", lambda: w(c.enc_layers, c.enc_kernel, c.d_model, c.d_ffn)),
        ("encoder.ff_out", lambda: w(c.enc_layers, c.enc_kernel, c.d_ffn, c.d_model)),
        ("encoder.norm_out", lambda: g(c.d_model)),
        ("decoder.pos_emb", lambda: w(c.max_pos, c.d_model)),
        ("decoder.norm_self", lambda: g(c.dec_layers, c.d_model)),
        ("decoder.qkv", lambda: w(c.dec_layers, c.d_model, 3 * c.d_model)),
        ("decoder.sa_out", lambda: w(c.dec_layers, c.d_model, c.d_model)),
        ("decoder.norm_xa_q", lambda: g(c.dec_layers, c.d_model)),
        ("decoder.norm_xa_mem", lambda: g(c.dec_layers, c.d_model)),
        ("decoder.xa_q", lambda: w(c.dec_layers, c.d_model, c.d_xa)),
        ("decoder.xa_kv", lambda: w(c.dec_layers, c.d_model, 2 * c.d_xa)),
        ("decoder.xa_out", lambda: w(c.dec_layers, c.d_xa, c.d_model)),
        ("decoder.norm_ff", lambda: g(c.dec_layers, c.d_model)),
        ("decoder.ff_proj", lambda: w(c.dec_layers, c.d_model, c.d_ffn)),
        ("decoder.ff_out", lambda: w(c.dec_layers, c.d_ffn, c.d_model)),
        ("decoder.norm_out", lambda: g(c.d_model)),
        ("lt.in_proj_w", lambda: w(c.d_model, c.lt_dim)),
        ("lt.in_proj_b", lambda: w(c.lt_dim)),
        ("lt.pos_emb", lambda: w(c.lt_max_pos, c.lt_dim)),
        ("lt.norm_self", lambda: g(c.lt_dim)),
        ("lt.qkv", lambda: w(c.lt_dim, 3 * c.lt_dim)),
        ("lt.sa_out", lambda: w(c.lt_dim, c.lt_dim)),
        ("lt.norm_ff", lambda: g(c.lt_dim)),
        ("lt.ff_proj", lambda: w(c.lt_dim, c.lt_ffn_dim)),
        ("lt.ff_out", lambda: w(c.lt_ffn_dim, c.lt_dim)),
        ("lt.out_proj_w", lambda: w(c.num_codebooks, c.lt_dim, c.vocab_per_cb)),
        ("lt.out_proj_b", lambda: w(c.num_codebooks, c.vocab_per_cb)),
        ("text_emb", lambda: w(c.text_vocab_size, c.d_model)),
        ("audio_emb", lambda: w(c.num_codebooks, c.vocab_per_cb, c.d_model)),
        ("baked_context", lambda: w(c.num_speakers, c.context_frames, c.d_model)),
        ("final_proj_w", lambda: w(c.d_model, c.num_codebooks * c.vocab_per_cb)),
        ("final_proj_b", lambda: w(c.num_codebooks * c.vocab_per_cb)),
    ]
    return magpie_weights_from_numpy({k: draw() for k, draw in draws}, dtype=dtype)
