"""Magpie 357M weight containers + GGUF loading + synthetic init, and the
quantized serving formats.

The layouts are the JAX package's (magpie_tts_tpu/io/magpie_weights.py): linear
weights transposed at load to ``[in, out]`` so the compute path is ``x @ W``,
per-layer tensors stacked on a leading layer axis, conv-FFN weights ``[k, in,
out]``. Quantized GGUF tensors (Q8_0 / Q4_0) are dequantized to float32 at load,
unless ``load_magpie_weights(q8_native=True)`` keeps the allowlisted Q8_0
tensors as their blocks (``Q8Blocks``, dequantized at program entry by
``materialize_weights``).

The four decoder matrices a frame streams (qkv, sa_out, ff_proj, ff_out) can
also be served quantized through one "stream" slot of the decode kernels:
``Int8DecoderStream`` (per-column int8, a serving requantization) or
``Q8DecoderStream`` (the checkpoint's own Q8_0 blocks, no requantization).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config import MagpieConfig
from . import quant
from .gguf import GGML_Q8_0
from .native import Reader, open_gguf
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
        """Move to ``device`` and cast the dense tensors to ``dtype``;
        ``Q8Blocks`` keep their int8 / f32 storage (materialize_weights
        dequantizes straight to the compute dtype)."""
        def move(x):
            if isinstance(x, Q8Blocks):
                return x.to(device)
            return x.to(device=device, dtype=dtype)
        return map_tensors(self, move, is_leaf=_is_q8_blocks)

    def flatten(self) -> Dict[str, torch.Tensor]:
        return flatten_tensors(self)


@dataclasses.dataclass(frozen=True)
class Int8DecoderStream:
    """Serving-quantized copies of the four decoder matrices a frame streams:
    per-OUTPUT-column int8, ``W[:, o] ~ q[:, o] * s[o]``, so a kernel scales
    the matmul OUTPUT (``(x @ q) * s``) and reads a quarter of the float32
    weight bytes. A device serving format, not the GGUF Q8_0 block layout."""
    qkv_q: torch.Tensor      # [L, d_model, 3*d_model] int8
    qkv_s: torch.Tensor      # [L, 3*d_model] f32
    sa_out_q: torch.Tensor   # [L, d_model, d_model] int8
    sa_out_s: torch.Tensor   # [L, d_model] f32
    ff_proj_q: torch.Tensor  # [L, d_model, d_ffn] int8
    ff_proj_s: torch.Tensor  # [L, d_ffn] f32
    ff_out_q: torch.Tensor   # [L, d_ffn, d_model] int8
    ff_out_s: torch.Tensor   # [L, d_model] f32

    def to(self, device=None) -> "Int8DecoderStream":
        return map_tensors(self, lambda t: t.to(device=device))


@dataclasses.dataclass(frozen=True)
class Q8DecoderStream:
    """The GGUF Q8_0 checkpoint's OWN blocks of the four streamed decoder
    matrices: int8 values plus one f16-valued scale per 32 INPUT rows per
    output column. A kernel dequantizes in-kernel (``repeat(s, 32, in-axis) *
    q`` in f32): the product of an f16-valued scale and an int8 value is exact
    in f32, so the weights it multiplies are bit-identical to the
    dequantize-at-load path's."""
    qkv_q: torch.Tensor      # [L, d_model, 3*d_model] int8
    qkv_bs: torch.Tensor     # [L, d_model//32, 3*d_model] f32 (f16-valued)
    sa_out_q: torch.Tensor   # [L, d_model, d_model] int8
    sa_out_bs: torch.Tensor  # [L, d_model//32, d_model] f32
    ff_proj_q: torch.Tensor  # [L, d_model, d_ffn] int8
    ff_proj_bs: torch.Tensor  # [L, d_model//32, d_ffn] f32
    ff_out_q: torch.Tensor   # [L, d_ffn, d_model] int8
    ff_out_bs: torch.Tensor  # [L, d_ffn//32, d_model] f32

    def to(self, device=None) -> "Q8DecoderStream":
        return map_tensors(self, lambda t: t.to(device=device))


STREAMED = ("qkv", "sa_out", "ff_proj", "ff_out")  # the decoder matrices a stream carries


def _stream_from_numpy(cls, arrays: Mapping[str, np.ndarray]):
    names = {f.name for f in dataclasses.fields(cls)}
    if set(arrays) != names:
        raise KeyError(f"{cls.__name__} wants keys {sorted(names)}, got {sorted(arrays)}")
    return cls(**{k: torch.as_tensor(np.array(v), dtype=torch.int8 if k.endswith("_q")
                                     else torch.float32) for k, v in arrays.items()})


def int8_stream_from_numpy(arrays: Mapping[str, np.ndarray]) -> Int8DecoderStream:
    """Int8DecoderStream from ``{field: array}`` (``qkv_q``, ``qkv_s``, ...):
    how tests carry the JAX package's stream across."""
    return _stream_from_numpy(Int8DecoderStream, arrays)


def q8_stream_from_numpy(arrays: Mapping[str, np.ndarray]) -> Q8DecoderStream:
    """Q8DecoderStream from ``{field: array}`` (``qkv_q``, ``qkv_bs``, ...)."""
    return _stream_from_numpy(Q8DecoderStream, arrays)


def _colquant(w: torch.Tensor):
    """[..., In, Out] -> (int8 q, f32 s[..., Out]) with W ~ q * s; a zero
    column gets scale 1.0. Rounds half to even, as jnp.round does."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / s[..., None, :]), -127, 127).to(torch.int8)
    return q, s


def quantize_decoder_stream(dec: DecoderWeights) -> Int8DecoderStream:
    """Per-column int8 copies of the streamed matrices, on dec's device."""
    kw = {}
    for name in STREAMED:
        kw[f"{name}_q"], kw[f"{name}_s"] = _colquant(getattr(dec, name))
    return Int8DecoderStream(**kw)


def _q8_split_t(payload: np.ndarray, out_dim: int, in_dim: int):
    """Raw Q8_0 payload of a [out, in] (torch-layout) tensor ->
    (q [in, out] int8, s [in//32, out] f32): ggml blocks run along the
    contiguous ``in`` axis; both arrays are transposed to the [in, out]
    matmul convention."""
    if in_dim % quant.QK != 0:
        # quantize_q8_0 pads the FLATTENED tensor, so blocks would straddle
        # rows and the per-row split would mis-scale values.
        raise ValueError(f"Q8_0-native streaming needs in_dim % {quant.QK} == 0, got "
                         f"shape [{out_dim}, {in_dim}]")
    q, s = quant.split_q8_0(payload, out_dim * in_dim)
    q = q.reshape(out_dim, in_dim).T
    s = s.reshape(out_dim, in_dim // quant.QK).T
    return np.ascontiguousarray(q), np.ascontiguousarray(s)


# GGUF names and torch-layout [out, in] shapes of the streamed matrices.
def _streamed_tensors(c: MagpieConfig):
    D, F = c.d_model, c.d_ffn
    return {"qkv": ("decoder.layers.{}.self_attention.qkv_net.weight", 3 * D, D),
            "sa_out": ("decoder.layers.{}.self_attention.o_net.weight", D, D),
            # conv weights are [out, in, 1]: the unit dim leaves the block order as is
            "ff_proj": ("decoder.layers.{}.pos_ff.proj.conv.weight", F, D),
            "ff_out": ("decoder.layers.{}.pos_ff.o_net.conv.weight", D, F)}


def _q8_stream(split) -> Q8DecoderStream:
    kw = {}
    for name in STREAMED:
        q, s = split(name)
        kw[f"{name}_q"] = torch.from_numpy(q)
        kw[f"{name}_bs"] = torch.from_numpy(s)
    return Q8DecoderStream(**kw)


def q8_stream_from_gguf(reader: Reader, config: MagpieConfig) -> Q8DecoderStream:
    """The native Q8_0 stream of a Q8_0-quantized Magpie GGUF (CPU tensors).
    Raises ValueError if any of the four streamed matrices is not Q8_0."""
    c = config

    def split(name):
        fmt, out_dim, in_dim = _streamed_tensors(c)[name]
        qs, ss = [], []
        for layer in range(c.dec_layers):
            tname = fmt.format(layer)
            ggml_type = reader.tensors[tname].ggml_type
            if ggml_type != GGML_Q8_0:
                raise ValueError(f"{tname}: not Q8_0 (type {ggml_type}); Q8_0-native "
                                 "streaming needs a fully Q8_0 decoder")
            q, s = _q8_split_t(reader.raw(tname), out_dim, in_dim)
            qs.append(q)
            ss.append(s)
        return np.stack(qs), np.stack(ss)

    return _q8_stream(split)


def q8_stream_from_arrays(dec: DecoderWeights) -> Q8DecoderStream:
    """Round-trip float decoder weights through the Q8_0 byte codec (tests and
    benchmarks on synthetic weights; checkpoints use q8_stream_from_gguf).
    The matching dequantized-weights oracle is ``q8_dequantized_decoder``."""
    def split(name):
        w = getattr(dec, name).detach().cpu().float().numpy()
        qs, ss = [], []
        for layer in range(w.shape[0]):
            t = np.ascontiguousarray(w[layer].T)       # [out, in]
            payload = np.frombuffer(quant.quantize_q8_0(t), np.uint8)
            q, s = _q8_split_t(payload, t.shape[0], t.shape[1])
            qs.append(q)
            ss.append(s)
        return np.stack(qs), np.stack(ss)

    return _q8_stream(split)


def q8_dequantized_decoder(dec: DecoderWeights, q8: Q8DecoderStream) -> DecoderWeights:
    """The dequantize-at-load oracle of a Q8 stream: ``dec`` with the four
    streamed matrices replaced by their block-dequantized values."""
    def deq(q, s):
        return torch.repeat_interleave(s.float(), quant.QK, dim=1) * q.float()

    return dataclasses.replace(dec, **{name: deq(getattr(q8, f"{name}_q"),
                                                 getattr(q8, f"{name}_bs"))
                                       for name in STREAMED})


@dataclasses.dataclass(frozen=True)
class Q8Blocks:
    """A weight tensor kept as its GGUF Q8_0 blocks (``--serve-q8``): every
    tensor on the converter's quant allowlist stays in this form inside
    MagpieWeights, and a program dequantizes it at entry
    (``materialize_weights``), once per utterance. The dequant is the exact
    f32 product of the load path followed by the loader's layout transform,
    so the materialized tensor is BIT-IDENTICAL to ``load_magpie_weights`` on
    the same file. On a CUDA device it runs kernel 10
    (ops/kernels/q8_dequant.py)."""
    q: torch.Tensor          # [*lead, n_blocks, 32] int8 (torch-flattened order)
    s: torch.Tensor          # [*lead, n_blocks, 1] f32 (f16-valued)
    torch_shape: tuple       # the GGUF tensor's [out, in(, k)] shape
    transform: str           # the loader's: "linear" (_t), "conv1" ([:, :, 0] then _t),
    #                          "conv_ffn" (transpose (2, 1, 0))

    def to(self, device=None) -> "Q8Blocks":
        return dataclasses.replace(self, q=self.q.to(device=device), s=self.s.to(device=device))

    def materialize(self, dtype=torch.float32) -> torch.Tensor:
        """The dense tensor in ``dtype``: the exact f32 product rounded once
        (kernel 10 writes float32 or bfloat16 directly)."""
        from ..ops.kernels.q8_dequant import dequantize

        return dequantize(self.q, self.s, self.torch_shape, self.transform, dtype)


def _is_q8_blocks(x) -> bool:
    return isinstance(x, Q8Blocks)


def q8_blocks_from_numpy(q: np.ndarray, s: np.ndarray, torch_shape, transform: str) -> Q8Blocks:
    """Q8Blocks from its arrays (how tests carry the JAX package's across)."""
    return Q8Blocks(q=torch.as_tensor(np.array(q), dtype=torch.int8),
                    s=torch.as_tensor(np.array(s), dtype=torch.float32),
                    torch_shape=tuple(int(n) for n in torch_shape), transform=transform)


def _q8_blocks_from_reader(reader: Reader, names, torch_shape, transform) -> Q8Blocks:
    """Stacked Q8Blocks of one tensor (or an [L]-stack of same-shape tensors)
    read RAW from a Q8_0 GGUF."""
    n = int(np.prod(torch_shape))
    if n % quant.QK != 0:
        raise ValueError(f"{names[0]}: {torch_shape} not /{quant.QK}")
    qs, ss = [], []
    for name in names:
        ggml_type = reader.tensors[name].ggml_type
        if ggml_type != GGML_Q8_0:
            raise ValueError(f"{name}: not Q8_0 (type {ggml_type}); full-native serving "
                             "needs the allowlisted tensors stored as Q8_0")
        q, s = quant.split_q8_0(reader.raw(name), n)
        qs.append(q.reshape(-1, quant.QK))
        ss.append(s.reshape(-1, 1))
    q = np.stack(qs) if len(names) > 1 else qs[0]
    s = np.stack(ss) if len(names) > 1 else ss[0]
    return q8_blocks_from_numpy(q, s, torch_shape, transform)


def materialize_weights(weights: "MagpieWeights", dtype=None) -> "MagpieWeights":
    """Replace every Q8Blocks node by its dequantized dense tensor (kernel 10
    on a CUDA device). Call at program entry: dense copies then live only for
    that call. ``dtype`` defaults to text_emb's (never quantized). Returns
    ``weights`` itself when it holds no Q8Blocks."""
    if not has_q8_blocks(weights):
        return weights
    dtype = dtype or weights.text_emb.dtype
    return map_tensors(weights, lambda x: x.materialize(dtype) if _is_q8_blocks(x) else x,
                       is_leaf=_is_q8_blocks)


def q8_blocks(obj, prefix: str = "") -> Dict[str, Q8Blocks]:
    """{field path: Q8Blocks} of every block-stored tensor in ``obj``."""
    if isinstance(obj, Q8Blocks):
        return {prefix: obj}
    if not dataclasses.is_dataclass(obj):
        return {}
    out: Dict[str, Q8Blocks] = {}
    for f in dataclasses.fields(obj):
        out.update(q8_blocks(getattr(obj, f.name), f"{prefix}.{f.name}" if prefix else f.name))
    return out


def has_q8_blocks(weights) -> bool:
    return bool(q8_blocks(weights))


_SUBTREES = {"encoder": EncoderWeights, "decoder": DecoderWeights,
             "lt": LocalTransformerWeights}


def magpie_weights_from_numpy(arrays: Mapping[str, np.ndarray],
                              dtype=torch.float32) -> MagpieWeights:
    """Build MagpieWeights from ``{field.path: array}`` (e.g. ``"decoder.qkv"``,
    ``"lt.out_proj_w"``, ``"text_emb"``) — how tests carry the JAX package's
    parameters across. Every field must be present; extra keys raise. A
    ``Q8Blocks`` value is kept as it is."""
    used = set()

    def take(key):
        used.add(key)
        if isinstance(arrays[key], Q8Blocks):
            return arrays[key]
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
                        dtype=torch.float32, reader: Optional[Reader] = None,
                        q8_native: bool = False):
    """Load a Magpie GGUF checkpoint into (config, MagpieWeights) on the CPU.

    Quantized tensors are dequantized at load (the GGUF reader's f32 path),
    then transformed to the compute layouts exactly as the JAX loader does.
    ``q8_native=True`` (``--serve-q8``): every allowlisted tensor stored as
    Q8_0 stays as its raw blocks (``Q8Blocks``); programs dequantize them at
    entry (``materialize_weights``). Tensors the converter left dense load
    normally.
    """
    if reader is None:
        reader = open_gguf(path)
    if config is None:
        config = MagpieConfig.from_gguf_metadata(reader.metadata)
    get = reader.tensor
    c = config

    def stack(fmt: str, n: int, transform=lambda x: x):
        return np.stack([transform(get(fmt.format(i))) for i in range(n)])

    def conv1(x):
        return _t(x[:, :, 0])

    def q8_or(fmt: str, n: int, transform, torch_shape, kind):
        """Q8Blocks when q8-native serving is on and the file stores Q8_0;
        the ordinary dense load otherwise. ``n=0``: one unstacked tensor."""
        names = [fmt] if n == 0 else [fmt.format(i) for i in range(n)]
        if q8_native and all(reader.tensors[nm].ggml_type == GGML_Q8_0 for nm in names):
            return _q8_blocks_from_reader(reader, names, torch_shape, kind)
        return transform(get(fmt)) if n == 0 else stack(fmt, n, transform)

    D, F, k, X, LT, LF = c.d_model, c.d_ffn, c.enc_kernel, c.d_xa, c.lt_dim, c.lt_ffn_dim
    el, dl = c.enc_layers, c.dec_layers
    enc = dict(
        pos_emb=get("encoder.position_embeddings.weight"),
        norm_self=stack("encoder.layers.{}.norm_self.weight", el),
        qkv=q8_or("encoder.layers.{}.self_attention.qkv_net.weight", el, _t, (3 * D, D),
                  "linear"),
        sa_out=q8_or("encoder.layers.{}.self_attention.o_net.weight", el, _t, (D, D), "linear"),
        norm_ff=stack("encoder.layers.{}.norm_pos_ff.weight", el),
        ff_proj=q8_or("encoder.layers.{}.pos_ff.proj.conv.weight", el, _conv_ffn_w, (F, D, k),
                      "conv_ffn"),
        ff_out=q8_or("encoder.layers.{}.pos_ff.o_net.conv.weight", el, _conv_ffn_w, (D, F, k),
                     "conv_ffn"),
        norm_out=get("encoder.norm_out.weight"),
    )
    dec = dict(
        pos_emb=get("decoder.position_embeddings.weight"),
        norm_self=stack("decoder.layers.{}.norm_self.weight", dl),
        qkv=q8_or("decoder.layers.{}.self_attention.qkv_net.weight", dl, _t, (3 * D, D),
                  "linear"),
        sa_out=q8_or("decoder.layers.{}.self_attention.o_net.weight", dl, _t, (D, D), "linear"),
        norm_xa_q=stack("decoder.layers.{}.norm_xattn_query.weight", dl),
        norm_xa_mem=stack("decoder.layers.{}.norm_xattn_memory.weight", dl),
        xa_q=q8_or("decoder.layers.{}.cross_attention.q_net.weight", dl, _t, (X, D), "linear"),
        xa_kv=q8_or("decoder.layers.{}.cross_attention.kv_net.weight", dl, _t, (2 * X, D),
                    "linear"),
        xa_out=q8_or("decoder.layers.{}.cross_attention.o_net.weight", dl, _t, (D, X),
                     "linear"),
        norm_ff=stack("decoder.layers.{}.norm_pos_ff.weight", dl),
        ff_proj=q8_or("decoder.layers.{}.pos_ff.proj.conv.weight", dl, conv1, (F, D, 1),
                      "conv1"),
        ff_out=q8_or("decoder.layers.{}.pos_ff.o_net.conv.weight", dl, conv1, (D, F, 1),
                     "conv1"),
        norm_out=get("decoder.norm_out.weight"),
    )
    lp = "local_transformer.layers.0"
    lt = dict(
        in_proj_w=q8_or("local_transformer_in_projection.weight", 0, _t, (LT, D), "linear"),
        in_proj_b=get("local_transformer_in_projection.bias"),
        pos_emb=get("local_transformer.position_embeddings.weight"),
        norm_self=get(f"{lp}.norm_self.weight"),
        qkv=q8_or(f"{lp}.self_attention.qkv_net.weight", 0, _t, (3 * LT, LT), "linear"),
        sa_out=q8_or(f"{lp}.self_attention.o_net.weight", 0, _t, (LT, LT), "linear"),
        norm_ff=get(f"{lp}.norm_pos_ff.weight"),
        ff_proj=q8_or(f"{lp}.pos_ff.proj.conv.weight", 0, conv1, (LF, LT, 1), "conv1"),
        ff_out=q8_or(f"{lp}.pos_ff.o_net.conv.weight", 0, conv1, (LT, LF, 1), "conv1"),
        out_proj_w=q8_or("local_transformer_out_projections.{}.weight", c.num_codebooks, _t,
                         (c.vocab_per_cb, LT), "linear"),
        out_proj_b=stack("local_transformer_out_projections.{}.bias", c.num_codebooks),
    )
    arrays = {
        "text_emb": get("text_embedding.weight"),
        "audio_emb": stack("audio_embeddings.{}.weight", c.num_codebooks),
        "baked_context": get("baked_context_embedding.weight").reshape(
            c.num_speakers, c.context_frames, c.d_model),
        "final_proj_w": q8_or("final_proj.weight", 0, _t, (c.num_codebooks * c.vocab_per_cb, D),
                              "linear"),
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
