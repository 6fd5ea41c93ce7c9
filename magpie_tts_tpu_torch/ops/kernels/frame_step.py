"""Kernel A: one decode frame (LT sampling + frame embedding + decoder step).

``frame_step`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/frame_step.py ``frame_step_pallas`` (dense
float32 stream). On CUDA tensors it launches csrc/frame_step.cu (a fixed
sequence of kernels on the current stream, see the source note there) or
raises; on CPU tensors it runs ``frame_step_reference``, the plain
composition the TPU kernel is pinned against: ``sample_frame_codes`` +
``audio_frame_embedding`` + ``decode_step``.

Both update the K/V caches in place (row ``pos`` of every layer).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...config import MagpieConfig
from ...io.magpie_weights import MagpieWeights
from ..attention import attn_scale
from . import build

launches = 0  # kernel launches (one per frame) since the last reset

_PART_CAP = 32  # most split-K partial rows a GEMV may produce


class FrameStepArgs(ctypes.Structure):
    """Mirror of ``struct FrameStepArgs`` in csrc/frame_step.cu."""
    _ptrs = (
        "hidden k_cache v_cache xa_k xa_v "
        "lt_in_w lt_in_b lt_pos lt_norm_self lt_qkv lt_sa_out lt_norm_ff "
        "lt_ff_proj lt_ff_out lt_out_w lt_out_b audio_emb "
        "pos_emb norm_self qkv sa_out norm_xa_q xa_q xa_out norm_ff ff_proj "
        "ff_out norm_out "
        "sampled argmax hidden_out "
        "part x h q attn f xa lt_x lt_h lt_q lt_k lt_v lt_attn lt_f emb_row "
        "emb_acc").split()
    _ints = (
        "d_model d_ffn n_layers max_seq enc_rows d_xa n_heads xa_heads "
        "lt_dim lt_ffn n_cb vocab part_cap "
        "pos enc_len seed top_k forbid_eos audio_bos_id audio_eos_id "
        "gelu_tanh").split()
    _floats = "temperature eps sa_scale xa_scale lt_scale".split()
    _fields_ = ([(n, ctypes.c_void_p) for n in _ptrs] +
                [(n, ctypes.c_int) for n in _ints] +
                [(n, ctypes.c_float) for n in _floats])


def declare(lib: ctypes.CDLL) -> None:
    lib.magpie_frame_step_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.magpie_frame_step_f32.restype = ctypes.c_int


def frame_step_reference(hidden: torch.Tensor, pos: int, xa_k: torch.Tensor,
                         xa_v: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         weights: MagpieWeights, config: MagpieConfig, seed: int,
                         temperature: float, top_k: int, forbid_eos: bool,
                         enc_length: Optional[int] = None):
    """Plain PyTorch frame: LT sampling, mean code embedding, decoder step."""
    from ...models import decoder as decoder_mod
    from ...models import local_transformer as lt_mod
    from ...models.magpie import audio_frame_embedding
    from .. import sampling

    static_mask = sampling.forbidden_token_mask(config.vocab_per_cb, config.audio_bos_id,
                                                device=hidden.device)
    sampled, argmax = lt_mod.sample_frame_codes(hidden, weights, config, seed, temperature,
                                                top_k, forbid_eos, static_mask)
    emb = audio_frame_embedding(sampled, weights, config)
    hidden = decoder_mod.decode_step(emb, pos, xa_k, xa_v, k_cache, v_cache, weights,
                                     config, enc_length=enc_length)
    return sampled, argmax, hidden, k_cache, v_cache


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"frame_step: {name} must be a float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"frame_step: {name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"frame_step: {name} must be contiguous and 16-byte aligned")


def _workspace(config: MagpieConfig, device) -> dict:
    c = config
    n_max = max(3 * c.d_model, c.d_ffn, c.vocab_per_cb, 3 * c.lt_dim, c.lt_ffn_dim, c.d_xa)
    sizes = {"part": _PART_CAP * n_max, "x": c.d_model, "h": c.d_model, "q": c.d_model,
             "attn": c.d_model, "f": c.d_ffn, "xa": c.d_xa, "lt_x": c.lt_dim,
             "lt_h": c.lt_dim, "lt_q": c.lt_dim, "lt_k": c.num_codebooks * c.lt_dim,
             "lt_v": c.num_codebooks * c.lt_dim, "lt_attn": c.lt_dim, "lt_f": c.lt_ffn_dim,
             "emb_row": c.d_model, "emb_acc": c.d_model}
    # 64-float (256 B) granules keep every buffer aligned for float4 access.
    padded = {k: -(-n // 64) * 64 for k, n in sizes.items()}
    ws = torch.empty(sum(padded.values()), dtype=torch.float32, device=device)
    return dict(zip(padded, ws.split(list(padded.values()))))


def weight_tensors(weights: MagpieWeights, config: MagpieConfig) -> dict:
    """{argument name: (tensor, required shape)} of the LT, audio-embedding
    and decoder-layer weights both frame kernels read."""
    c = config
    dec, lt = weights.decoder, weights.lt
    L, D, F = c.dec_layers, c.d_model, c.d_ffn
    LT, LF, V, X = c.lt_dim, c.lt_ffn_dim, c.vocab_per_cb, c.d_xa
    return {
        "lt_in_w": (lt.in_proj_w, (D, LT)), "lt_in_b": (lt.in_proj_b, (LT,)),
        "lt_pos": (lt.pos_emb, (c.lt_max_pos, LT)), "lt_norm_self": (lt.norm_self, (LT,)),
        "lt_qkv": (lt.qkv, (LT, 3 * LT)), "lt_sa_out": (lt.sa_out, (LT, LT)),
        "lt_norm_ff": (lt.norm_ff, (LT,)), "lt_ff_proj": (lt.ff_proj, (LT, LF)),
        "lt_ff_out": (lt.ff_out, (LF, LT)), "lt_out_w": (lt.out_proj_w, (c.num_codebooks, LT, V)),
        "lt_out_b": (lt.out_proj_b, (c.num_codebooks, V)),
        "audio_emb": (weights.audio_emb, (c.num_codebooks, V, D)),
        "norm_self": (dec.norm_self, (L, D)),
        "qkv": (dec.qkv, (L, D, 3 * D)), "sa_out": (dec.sa_out, (L, D, D)),
        "norm_xa_q": (dec.norm_xa_q, (L, D)), "xa_q": (dec.xa_q, (L, D, X)),
        "xa_out": (dec.xa_out, (L, X, D)), "norm_ff": (dec.norm_ff, (L, D)),
        "ff_proj": (dec.ff_proj, (L, D, F)), "ff_out": (dec.ff_out, (L, F, D)),
        "norm_out": (dec.norm_out, (D,)),
    }


def _tensors(hidden, k_cache, v_cache, xa_k, xa_v, weights: MagpieWeights,
             config: MagpieConfig) -> dict:
    """{argument name: (tensor, required shape)} of every tensor the kernel reads."""
    L, S, D = k_cache.shape
    E = xa_k.shape[1]
    X = config.d_xa
    return {
        "hidden": (hidden, (D,)), "k_cache": (k_cache, (L, S, D)),
        "v_cache": (v_cache, (L, S, D)), "xa_k": (xa_k, (L, E, X)), "xa_v": (xa_v, (L, E, X)),
        "pos_emb": (weights.decoder.pos_emb, (config.max_pos, D)),
        **weight_tensors(weights, config),
    }


def _launch(lib, stream: int, hidden, pos, xa_k, xa_v, k_cache, v_cache, weights, config,
            seed, temperature, top_k, forbid_eos, enc_len):
    """Allocate outputs + workspace on hidden's device and call the C entry
    point (arguments already validated)."""
    c = config
    L, S, D = k_cache.shape
    X = c.d_xa
    dev = hidden.device
    sampled = torch.empty(c.num_codebooks, dtype=torch.int32, device=dev)
    argmax = torch.empty(c.num_codebooks, dtype=torch.int32, device=dev)
    hidden_out = torch.empty(D, dtype=torch.float32, device=dev)
    ws = _workspace(c, dev)
    tensors = _tensors(hidden, k_cache, v_cache, xa_k, xa_v, weights, c)
    ptrs = {name: t.data_ptr() for name, (t, _) in tensors.items()}
    ptrs.update({k: v.data_ptr() for k, v in ws.items()})
    ptrs.update(sampled=sampled.data_ptr(), argmax=argmax.data_ptr(),
                hidden_out=hidden_out.data_ptr())
    args = FrameStepArgs(
        **ptrs, d_model=D, d_ffn=c.d_ffn, n_layers=L, max_seq=S, enc_rows=xa_k.shape[1],
        d_xa=X, n_heads=c.dec_sa_heads, xa_heads=c.dec_xa_heads, lt_dim=c.lt_dim,
        lt_ffn=c.lt_ffn_dim, n_cb=c.num_codebooks, vocab=c.vocab_per_cb, part_cap=_PART_CAP,
        pos=int(pos), enc_len=int(enc_len), seed=int(seed),
        top_k=min(int(top_k), c.vocab_per_cb), forbid_eos=int(bool(forbid_eos)),
        audio_bos_id=c.audio_bos_id, audio_eos_id=c.audio_eos_id,
        gelu_tanh=int(c.gelu_tanh), temperature=float(temperature), eps=float(c.eps),
        sa_scale=attn_scale(D // c.dec_sa_heads), xa_scale=attn_scale(X // c.dec_xa_heads),
        lt_scale=attn_scale(c.lt_dim))
    build.check(lib.magpie_frame_step_f32(ctypes.addressof(args), stream), "frame_step")
    return sampled, argmax, hidden_out


def frame_step(hidden: torch.Tensor, pos: int, xa_k: torch.Tensor, xa_v: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor, weights: MagpieWeights,
               config: MagpieConfig, seed: int, temperature: float, top_k: int,
               forbid_eos: bool, enc_length: Optional[int] = None):
    """One full frame: sample 8 codes from ``hidden``, embed them, run the
    decoder at ``pos``. Returns (sampled [8] int32, argmax [8] int32,
    new hidden [d_model], k_cache, v_cache); the caches update in place."""
    global launches
    if hidden.device.type == "cpu":
        return frame_step_reference(hidden, pos, xa_k, xa_v, k_cache, v_cache, weights,
                                    config, seed, temperature, top_k, forbid_eos,
                                    enc_length)
    if hidden.device.type != "cuda":
        raise ValueError(f"frame_step: unsupported device {hidden.device}")
    c = config
    S = k_cache.shape[1]
    E = xa_k.shape[1]
    enc_len = E if enc_length is None else int(enc_length)
    if not (0 <= pos < min(S, c.max_pos) and 1 <= enc_len <= E):
        raise ValueError(f"frame_step: pos {pos} / enc_length {enc_len} out of range")
    if c.vocab_per_cb > 4096 or top_k < 1 or c.num_codebooks > c.lt_max_pos:
        raise ValueError("frame_step: needs vocab_per_cb <= 4096, top_k >= 1 and "
                         "num_codebooks <= lt_max_pos")
    for n in (3 * c.d_model, c.d_ffn, c.d_xa, c.lt_dim, 3 * c.lt_dim, c.lt_ffn_dim,
              c.vocab_per_cb):
        if n % 4:
            raise ValueError(f"frame_step: GEMV width {n} is not a multiple of 4")
    for name, (t, shape) in _tensors(hidden, k_cache, v_cache, xa_k, xa_v, weights,
                                     c).items():
        _check(name, t, shape)
    lib = build.load_library()
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    sampled, argmax, hidden_out = _launch(lib, stream, hidden, pos, xa_k, xa_v, k_cache,
                                          v_cache, weights, c, seed, temperature, top_k,
                                          forbid_eos, enc_len)
    launches += 1
    return sampled, argmax, hidden_out, k_cache, v_cache
