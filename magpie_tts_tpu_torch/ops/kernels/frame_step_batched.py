"""Kernel C: one decode frame for B slots (batched serving).

``frame_step_batched`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/frame_step_batched.py
``frame_step_batched_pallas`` (dense float32 stream). On CUDA tensors it
launches csrc/frame_step_batched.cu (a fixed sequence of kernels on the
current stream that reads every weight once per frame for all B slots, see
the source note there) or raises; on CPU tensors it runs
``frame_step_batched_reference``: per slot, ``sample_frame_codes`` +
``audio_frame_embedding`` + ``decode_rows``.

Both update the K/V caches ``[B, L, max_seq, d_model]`` in place (row
``write_row`` of every layer and slot).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from ...config import MagpieConfig
from ...io.magpie_weights import MagpieWeights
from ..attention import attn_scale
from . import build
from .frame_step import weight_tensors

launches = 0  # kernel launches (one per frame) since the last reset
_launches_lock = threading.Lock()  # engines on several cards launch from a thread pool

MAX_SLOTS = 64  # the kernel's shared-memory slot tile
_PART_CAP = 32  # most split-K partial rows a GEMM may produce


class FrameStepBatchedArgs(ctypes.Structure):
    """Mirror of ``struct FrameStepBatchedArgs`` in csrc/frame_step_batched.cu."""
    _ptrs = (
        "hidden valid may_continue posemb forbid_eos seeds enc_lengths k_cache v_cache "
        "xa_k xa_v "
        "lt_in_w lt_in_b lt_pos lt_norm_self lt_qkv lt_sa_out lt_norm_ff "
        "lt_ff_proj lt_ff_out lt_out_w lt_out_b audio_emb "
        "norm_self qkv sa_out norm_xa_q xa_q xa_out norm_ff ff_proj ff_out norm_out "
        "sampled argmax hidden_out "
        "part x h q attn f xa lt_x lt_h lt_q lt_k lt_v lt_attn lt_f emb_row emb_acc "
        "new_valid").split()
    _ints = (
        "batch d_model d_ffn n_layers max_seq enc_rows d_xa n_heads xa_heads "
        "lt_dim lt_ffn n_cb vocab part_cap "
        "write_row rows valid_stride posemb_stride top_k audio_bos_id audio_eos_id "
        "gelu_tanh").split()
    _floats = "temperature eps sa_scale xa_scale lt_scale".split()
    _fields_ = ([(n, ctypes.c_void_p) for n in _ptrs] +
                [(n, ctypes.c_int) for n in _ints] +
                [(n, ctypes.c_float) for n in _floats])


def declare(lib: ctypes.CDLL) -> None:
    lib.magpie_frame_step_batched_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.magpie_frame_step_batched_f32.restype = ctypes.c_int


def frame_step_batched_reference(
        hidden: torch.Tensor, write_row: int, valid: torch.Tensor,
        may_continue: torch.Tensor, posemb: torch.Tensor, xa_k: torch.Tensor,
        xa_v: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
        weights: MagpieWeights, config: MagpieConfig, enc_lengths: torch.Tensor,
        seeds: torch.Tensor, temperature: float, top_k: int, forbid_eos: torch.Tensor,
        rows: Optional[int] = None):
    """Plain PyTorch batched frame, one slot at a time. ``rows`` only bounds
    the kernel's attention window; rows past it must hold no valid row, so
    the plain version attends over the whole masked cache."""
    from ...models import decoder as decoder_mod
    from ...models import local_transformer as lt_mod
    from ...models.magpie import audio_frame_embedding
    from .. import sampling

    del rows
    static_mask = sampling.forbidden_token_mask(config.vocab_per_cb, config.audio_bos_id,
                                                device=hidden.device)
    seeds_l, forbid_l = seeds.tolist(), forbid_eos.tolist()
    cont_l, enc_l = may_continue.tolist(), enc_lengths.tolist()
    sampled, argmax, out = [], [], []
    for b in range(hidden.shape[0]):
        s_b, a_b = lt_mod.sample_frame_codes(hidden[b], weights, config, seeds_l[b],
                                             temperature, top_k, bool(forbid_l[b]),
                                             static_mask)
        new_valid = bool(cont_l[b]) and not sampling.frame_has_eos(s_b, a_b,
                                                                   config.audio_eos_id)
        mask = valid[b].to(torch.bool).clone()
        mask[write_row] = new_valid
        emb = audio_frame_embedding(s_b, weights, config)
        out.append(decoder_mod.decode_rows(emb + posemb[b], write_row, mask, xa_k[b], xa_v[b],
                                           k_cache[b], v_cache[b], weights, config,
                                           enc_length=int(enc_l[b])))
        sampled.append(s_b)
        argmax.append(a_b)
    return torch.stack(sampled), torch.stack(argmax), torch.stack(out), k_cache, v_cache


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], dtype=torch.float32,
           broadcast_ok: bool = False) -> None:
    """Device, dtype and shape; contiguous rows, or one row broadcast over the
    leading dim (stride 0) where ``broadcast_ok``."""
    if t.device.type != "cuda" or t.dtype != dtype:
        raise ValueError(f"frame_step_batched: {name} must be a {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"frame_step_batched: {name} has shape {tuple(t.shape)}, "
                         f"want {shape}")
    rows_ok = t.is_contiguous() or (broadcast_ok and t.dim() == 2 and t.stride(0) == 0
                                    and t.stride(1) == 1)
    if not rows_ok or (dtype == torch.float32 and t.data_ptr() % 16):
        raise ValueError(f"frame_step_batched: {name} must be contiguous (float32: 16-byte "
                         f"aligned)")


def _workspace(config: MagpieConfig, B: int, device) -> dict:
    c = config
    n_max = max(3 * c.d_model, c.d_ffn, c.vocab_per_cb, 3 * c.lt_dim, c.lt_ffn_dim, c.d_xa)
    per_slot = {"part": _PART_CAP * n_max, "x": c.d_model, "h": c.d_model, "q": c.d_model,
                "attn": c.d_model, "f": c.d_ffn, "xa": c.d_xa, "lt_x": c.lt_dim,
                "lt_h": c.lt_dim, "lt_q": c.lt_dim, "lt_k": c.num_codebooks * c.lt_dim,
                "lt_v": c.num_codebooks * c.lt_dim, "lt_attn": c.lt_dim, "lt_f": c.lt_ffn_dim,
                "emb_row": c.d_model, "emb_acc": c.d_model}
    # 64-float (256 B) granules keep every buffer aligned for float4 access.
    padded = {k: -(-n * B // 64) * 64 for k, n in per_slot.items()}
    ws = torch.empty(sum(padded.values()), dtype=torch.float32, device=device)
    out = dict(zip(padded, ws.split(list(padded.values()))))
    out["new_valid"] = torch.empty(B, dtype=torch.int32, device=device)
    return out


def _tensors(hidden, valid, may_continue, posemb, forbid_eos, seeds, enc_lengths, k_cache,
             v_cache, xa_k, xa_v, weights: MagpieWeights, config: MagpieConfig) -> dict:
    """{argument name: (tensor, shape, dtype, broadcast_ok)} of every tensor the
    kernel reads."""
    B, L, S, D = k_cache.shape
    E, X = xa_k.shape[2], config.d_xa
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    return {
        "hidden": (hidden, (B, D), f32, False), "valid": (valid, (B, S), b8, True),
        "may_continue": (may_continue, (B,), b8, False), "posemb": (posemb, (B, D), f32, True),
        "forbid_eos": (forbid_eos, (B,), b8, False), "seeds": (seeds, (B,), i32, False),
        "enc_lengths": (enc_lengths, (B,), i32, False),
        "k_cache": (k_cache, (B, L, S, D), f32, False),
        "v_cache": (v_cache, (B, L, S, D), f32, False),
        "xa_k": (xa_k, (B, L, E, X), f32, False), "xa_v": (xa_v, (B, L, E, X), f32, False),
        **{name: (t, shape, f32, False)
           for name, (t, shape) in weight_tensors(weights, config).items()},
    }


def frame_step_batched(hidden: torch.Tensor, write_row: int, valid: torch.Tensor,
                       may_continue: torch.Tensor, posemb: torch.Tensor, xa_k: torch.Tensor,
                       xa_v: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       weights: MagpieWeights, config: MagpieConfig,
                       enc_lengths: torch.Tensor, seeds: torch.Tensor, temperature: float,
                       top_k: int, forbid_eos: torch.Tensor, rows: Optional[int] = None):
    """One full frame for B slots: sample 8 codes per slot, embed them, add
    the slot's position-embedding row, run the decoder at ``write_row``.

    hidden [B, d_model]; valid [B, max_seq] bool over the EXISTING rows (a
    broadcast [S] row is fine; column ``write_row`` is decided here as
    ``may_continue & ~frame_has_eos``); may_continue, forbid_eos [B] bool;
    posemb [B, d_model] rows (broadcast allowed); enc_lengths, seeds [B]
    int32; caches [B, L, max_seq, d_model]; xa_k/xa_v [B, L, enc, d_xa].
    ``rows`` (host int, default max_seq) bounds self-attention to rows
    [0, rows): no valid row may lie past it. No value is read back to the
    host. Returns (sampled [B, 8] int32, argmax [B, 8] int32,
    hidden [B, d_model], k_cache, v_cache); the caches update in place.
    """
    global launches
    if hidden.device.type == "cpu":
        return frame_step_batched_reference(hidden, write_row, valid, may_continue, posemb,
                                            xa_k, xa_v, k_cache, v_cache, weights, config,
                                            enc_lengths, seeds, temperature, top_k, forbid_eos,
                                            rows)
    if hidden.device.type != "cuda":
        raise ValueError(f"frame_step_batched: unsupported device {hidden.device}")
    c = config
    B, L, S, D = k_cache.shape
    rows = S if rows is None else int(rows)
    if not 1 <= B <= MAX_SLOTS:
        raise ValueError(f"frame_step_batched: {B} slots, the kernel takes 1..{MAX_SLOTS}")
    if not (0 <= write_row < rows <= S and S <= c.max_pos):
        raise ValueError(f"frame_step_batched: write_row {write_row} / rows {rows} out of "
                         f"range for max_seq {S}")
    if c.vocab_per_cb > 4096 or top_k < 1 or c.num_codebooks > c.lt_max_pos:
        raise ValueError("frame_step_batched: needs vocab_per_cb <= 4096, top_k >= 1 and "
                         "num_codebooks <= lt_max_pos")
    for n in (3 * c.d_model, c.d_ffn, c.d_xa, c.lt_dim, 3 * c.lt_dim, c.lt_ffn_dim,
              c.vocab_per_cb):
        if n % 4:
            raise ValueError(f"frame_step_batched: GEMM width {n} is not a multiple of 4")
    tensors = _tensors(hidden, valid, may_continue, posemb, forbid_eos, seeds, enc_lengths,
                       k_cache, v_cache, xa_k, xa_v, weights, c)
    for name, (t, shape, dtype, broadcast_ok) in tensors.items():
        _check(name, t, shape, dtype, broadcast_ok)
    lib = build.load_library()
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    dev = hidden.device
    sampled = torch.empty(B, c.num_codebooks, dtype=torch.int32, device=dev)
    argmax = torch.empty(B, c.num_codebooks, dtype=torch.int32, device=dev)
    hidden_out = torch.empty(B, D, dtype=torch.float32, device=dev)
    ptrs = {name: t.data_ptr() for name, (t, *_) in tensors.items()}
    ptrs.update({k: v.data_ptr() for k, v in _workspace(c, B, dev).items()})
    ptrs.update(sampled=sampled.data_ptr(), argmax=argmax.data_ptr(),
                hidden_out=hidden_out.data_ptr())
    X = c.d_xa
    args = FrameStepBatchedArgs(
        **ptrs, batch=B, d_model=D, d_ffn=c.d_ffn, n_layers=L, max_seq=S,
        enc_rows=xa_k.shape[2], d_xa=X, n_heads=c.dec_sa_heads, xa_heads=c.dec_xa_heads,
        lt_dim=c.lt_dim, lt_ffn=c.lt_ffn_dim, n_cb=c.num_codebooks, vocab=c.vocab_per_cb,
        part_cap=_PART_CAP, write_row=int(write_row), rows=rows,
        valid_stride=valid.stride(0), posemb_stride=posemb.stride(0),
        top_k=min(int(top_k), c.vocab_per_cb), audio_bos_id=c.audio_bos_id,
        audio_eos_id=c.audio_eos_id, gelu_tanh=int(c.gelu_tanh),
        temperature=float(temperature), eps=float(c.eps),
        sa_scale=attn_scale(D // c.dec_sa_heads), xa_scale=attn_scale(X // c.dec_xa_heads),
        lt_scale=attn_scale(c.lt_dim))
    with torch.cuda.device(dev):  # the launch goes to the caches' card
        err = lib.magpie_frame_step_batched_f32(ctypes.addressof(args), stream)
    build.check(err, "frame_step_batched")
    with _launches_lock:
        launches += 1
    return sampled, argmax, hidden_out, k_cache, v_cache
