"""Kernel A: one decode frame (LT sampling + frame embedding + decoder step).

``frame_step`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/frame_step.py ``frame_step_pallas`` (dense
float32 stream). On CUDA tensors it launches csrc/frame_step.cu (a fixed
sequence of kernels on the current stream, see the source note there) or
raises; on CPU tensors it runs ``frame_step_reference``, the plain
composition the TPU kernel is pinned against: the split path's two plain
versions, ``lt_sampler.sample_frame_codes_reference`` +
``audio_frame_embedding`` + ``decoder_step.decode_step_reference``.

Both update the K/V caches in place (row ``pos`` of every layer). ``launch``
and the tensor tables here also serve the split path's kernels 4 and 5
(ops/kernels/lt_sampler.py, ops/kernels/decoder_step.py), entry points of
the same source.
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


def declare(lib: ctypes.CDLL, entry: str = "magpie_frame_step_f32") -> None:
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def frame_step_reference(hidden: torch.Tensor, pos: int, xa_k: torch.Tensor,
                         xa_v: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         weights: MagpieWeights, config: MagpieConfig, seed: int,
                         temperature: float, top_k: int, forbid_eos: bool,
                         enc_length: Optional[int] = None):
    """Plain PyTorch frame: LT sampling, mean code embedding, decoder step."""
    from ...models.magpie import audio_frame_embedding
    from .decoder_step import decode_step_reference
    from .lt_sampler import sample_frame_codes_reference

    sampled, argmax = sample_frame_codes_reference(hidden, weights, config, seed, temperature,
                                                   top_k, forbid_eos)
    emb = audio_frame_embedding(sampled, weights, config)
    hidden = decode_step_reference(emb, pos, xa_k, xa_v, k_cache, v_cache, weights, config,
                                   enc_length=enc_length)
    return sampled, argmax, hidden, k_cache, v_cache


def check_tensor(who: str, name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{who}: {name} must be a float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{who}: {name} must be contiguous and 16-byte aligned")


def check_config(who: str, config: MagpieConfig, top_k: int = 1) -> None:
    """What the frame sequences take: vocab <= 4096 (one sampling block),
    top_k >= 1, and GEMV / GEMM widths that are multiples of 4 (float4)."""
    c = config
    if c.vocab_per_cb > 4096 or top_k < 1 or c.num_codebooks > c.lt_max_pos:
        raise ValueError(f"{who}: needs vocab_per_cb <= 4096, top_k >= 1 and "
                         f"num_codebooks <= lt_max_pos")
    for n in (3 * c.d_model, c.d_ffn, c.d_xa, c.lt_dim, 3 * c.lt_dim, c.lt_ffn_dim,
              c.vocab_per_cb):
        if n % 4:
            raise ValueError(f"{who}: GEMV width {n} is not a multiple of 4")


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


def lt_weight_tensors(weights: MagpieWeights, config: MagpieConfig) -> dict:
    """{argument name: (tensor, required shape)} of the LT and audio-embedding
    weights the LT sampling sequence reads."""
    c = config
    lt = weights.lt
    D, LT, LF, V = c.d_model, c.lt_dim, c.lt_ffn_dim, c.vocab_per_cb
    return {
        "lt_in_w": (lt.in_proj_w, (D, LT)), "lt_in_b": (lt.in_proj_b, (LT,)),
        "lt_pos": (lt.pos_emb, (c.lt_max_pos, LT)), "lt_norm_self": (lt.norm_self, (LT,)),
        "lt_qkv": (lt.qkv, (LT, 3 * LT)), "lt_sa_out": (lt.sa_out, (LT, LT)),
        "lt_norm_ff": (lt.norm_ff, (LT,)), "lt_ff_proj": (lt.ff_proj, (LT, LF)),
        "lt_ff_out": (lt.ff_out, (LF, LT)), "lt_out_w": (lt.out_proj_w, (c.num_codebooks, LT, V)),
        "lt_out_b": (lt.out_proj_b, (c.num_codebooks, V)),
        "audio_emb": (weights.audio_emb, (c.num_codebooks, V, D)),
    }


def decoder_weight_tensors(weights: MagpieWeights, config: MagpieConfig) -> dict:
    """{argument name: (tensor, required shape)} of the decoder-layer weights
    the decoder sequence reads."""
    c = config
    dec = weights.decoder
    L, D, F, X = c.dec_layers, c.d_model, c.d_ffn, c.d_xa
    return {
        "norm_self": (dec.norm_self, (L, D)),
        "qkv": (dec.qkv, (L, D, 3 * D)), "sa_out": (dec.sa_out, (L, D, D)),
        "norm_xa_q": (dec.norm_xa_q, (L, D)), "xa_q": (dec.xa_q, (L, D, X)),
        "xa_out": (dec.xa_out, (L, X, D)), "norm_ff": (dec.norm_ff, (L, D)),
        "ff_proj": (dec.ff_proj, (L, D, F)), "ff_out": (dec.ff_out, (L, F, D)),
        "norm_out": (dec.norm_out, (D,)),
    }


def weight_tensors(weights: MagpieWeights, config: MagpieConfig) -> dict:
    """Both tables: what a fused frame reads."""
    return {**lt_weight_tensors(weights, config), **decoder_weight_tensors(weights, config)}


def cache_tensors(k_cache, v_cache, xa_k, xa_v, config: MagpieConfig) -> dict:
    """{argument name: (tensor, required shape)} of one stream's caches
    [L, max_seq, d_model] and cross-attention K/V [L, enc, d_xa]."""
    S, E = k_cache.shape[1], xa_k.shape[1]
    L, D, X = config.dec_layers, config.d_model, config.d_xa
    return {"k_cache": (k_cache, (L, S, D)), "v_cache": (v_cache, (L, S, D)),
            "xa_k": (xa_k, (L, E, X)), "xa_v": (xa_v, (L, E, X))}


def launch(entry: str, tensors: dict, outputs: dict, config: MagpieConfig, device,
           **scalars) -> None:
    """Validate ``tensors`` ({name: (tensor, shape)}), allocate a workspace on
    ``device`` and call the library's ``entry`` with a FrameStepArgs of the
    tensors, the workspace, ``outputs`` ({name: tensor}) and the config's
    dims; ``scalars`` fill the remaining fields (unset pointers are null)."""
    c = config
    for name, (t, shape) in tensors.items():
        check_tensor(entry, name, t, shape)
    lib = build.load_library()
    ptrs = {name: t.data_ptr() for name, (t, _) in tensors.items()}
    ptrs.update({k: v.data_ptr() for k, v in _workspace(c, device).items()})
    ptrs.update({k: v.data_ptr() for k, v in outputs.items()})
    args = FrameStepArgs(
        **ptrs, d_model=c.d_model, d_ffn=c.d_ffn, n_layers=c.dec_layers, d_xa=c.d_xa,
        n_heads=c.dec_sa_heads, xa_heads=c.dec_xa_heads, lt_dim=c.lt_dim, lt_ffn=c.lt_ffn_dim,
        n_cb=c.num_codebooks, vocab=c.vocab_per_cb, part_cap=_PART_CAP,
        audio_bos_id=c.audio_bos_id, audio_eos_id=c.audio_eos_id, gelu_tanh=int(c.gelu_tanh),
        eps=float(c.eps), sa_scale=attn_scale(c.d_model // c.dec_sa_heads),
        xa_scale=attn_scale(c.d_xa // c.dec_xa_heads), lt_scale=attn_scale(c.lt_dim),
        **scalars)
    stream = torch.cuda.current_stream(device).cuda_stream
    build.check(getattr(lib, entry)(ctypes.addressof(args), stream), entry)


def sampling_scalars(config: MagpieConfig, seed: int, temperature: float, top_k: int,
                     forbid_eos: bool) -> dict:
    return dict(seed=int(seed), top_k=min(int(top_k), config.vocab_per_cb),
                forbid_eos=int(bool(forbid_eos)), temperature=float(temperature))


def step_scalars(who: str, config: MagpieConfig, pos: int, k_cache, xa_k,
                 enc_length: Optional[int]) -> dict:
    """pos / enc_len / max_seq / enc_rows of a decoder step, range-checked."""
    S, E = k_cache.shape[1], xa_k.shape[1]
    enc_len = E if enc_length is None else int(enc_length)
    if not (0 <= pos < min(S, config.max_pos) and 1 <= enc_len <= E):
        raise ValueError(f"{who}: pos {pos} / enc_length {enc_len} out of range")
    return dict(pos=int(pos), enc_len=enc_len, max_seq=S, enc_rows=E)


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
    check_config("frame_step", c, top_k)
    scalars = step_scalars("frame_step", c, pos, k_cache, xa_k, enc_length)
    dev = hidden.device
    sampled = torch.empty(c.num_codebooks, dtype=torch.int32, device=dev)
    argmax = torch.empty(c.num_codebooks, dtype=torch.int32, device=dev)
    hidden_out = torch.empty(c.d_model, dtype=torch.float32, device=dev)
    tensors = {"hidden": (hidden, (c.d_model,)),
               "pos_emb": (weights.decoder.pos_emb, (c.max_pos, c.d_model)),
               **cache_tensors(k_cache, v_cache, xa_k, xa_v, c), **weight_tensors(weights, c)}
    launch("magpie_frame_step_f32", tensors,
           dict(sampled=sampled, argmax=argmax, hidden_out=hidden_out), c, dev, **scalars,
           **sampling_scalars(c, seed, temperature, top_k, forbid_eos))
    launches += 1
    return sampled, argmax, hidden_out, k_cache, v_cache
