"""Kernel C: one decode frame for B slots (batched serving).

``frame_step_batched`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/frame_step_batched.py
``frame_step_batched_pallas`` with its three weight streams (``stream``:
None, an Int8DecoderStream or a Q8DecoderStream, as for kernel A). On CUDA
tensors it
launches csrc/frame_step_batched.cu (a fixed sequence of kernels on the
current stream that reads every weight once per frame for all B slots, see
the source note there) or raises; on CPU tensors it runs
``frame_step_batched_reference``: the split path's plain versions,
``lt_sampler_batched.sample_frame_codes_batched_reference`` +
``audio_frame_embedding`` + posemb + ``decoder_step_batched.
decode_step_batched_reference`` with the new row's validity decided between.

Both update the K/V caches ``[B, L, max_seq, d_model]`` in place (row
``write_row`` of every layer and slot). ``launch`` and the tensor tables here
also serve the split path's kernels 7 and 8, entry points of the same source.
As for kernel A, the hidden rows' dtype (float32 or bfloat16) picks the entry
point and every weight, cache and row must have it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from ...config import MagpieConfig
from ...io.magpie_weights import MagpieWeights
from ..attention import attn_scale
from . import batched_gemm, build, decode_attention
from .frame_step import (DTYPES, MODES, check_config, compute_dtype, count_dtype,
                         decoder_weight_tensors, entry_name, lt_weight_tensors, stream_mode,
                         stream_tensors)

launches = 0  # kernel launches (one per frame) since the last reset
mode_launches = dict.fromkeys(MODES, 0)  # the same, by weight stream
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype
_launches_lock = threading.Lock()  # engines on several cards launch from a thread pool

MAX_SLOTS = 64  # the GEMM's slot tiles: 4 m16 tiles
_PART_CAP = batched_gemm.PART_CAP  # most split-K partial rows a GEMM may produce


class FrameStepBatchedArgs(ctypes.Structure):
    """Mirror of ``struct FrameStepBatchedArgs`` in csrc/frame_step_batched.cu."""
    _ptrs = (
        "hidden valid may_continue posemb forbid_eos seeds enc_lengths k_cache v_cache "
        "xa_k xa_v "
        "lt_in_w lt_in_b lt_pos lt_norm_self lt_qkv lt_sa_out lt_norm_ff "
        "lt_ff_proj lt_ff_out lt_out_w lt_out_b audio_emb "
        "norm_self qkv sa_out norm_xa_q xa_q xa_out norm_ff ff_proj ff_out norm_out "
        "qkv_q qkv_s sa_out_q sa_out_s ff_proj_q ff_proj_s ff_out_q ff_out_s "
        "sampled argmax hidden_out "
        "part x h q attn f xa lt_x lt_h lt_q lt_k lt_v lt_attn lt_f emb_row emb_acc "
        "new_valid att_sc att_po att_tk").split()
    _ints = (
        "batch d_model d_ffn n_layers max_seq enc_rows d_xa n_heads xa_heads "
        "lt_dim lt_ffn n_cb vocab "
        "write_row rows valid_stride posemb_stride top_k audio_bos_id audio_eos_id "
        "gelu_tanh stream_mode sa_chunk xa_chunk lt_chunk n_gemm_plans").split()
    _floats = "temperature eps sa_scale xa_scale lt_scale".split()
    _fields_ = ([(n, ctypes.c_void_p) for n in _ptrs] +
                [(n, ctypes.c_int) for n in _ints] +
                [(n, ctypes.c_float) for n in _floats] +
                [("gemm_plans", batched_gemm.GemmPlanC * batched_gemm.MAX_PLANS)])


def declare(lib: ctypes.CDLL, base: str = "magpie_frame_step_batched") -> None:
    for suffix in DTYPES.values():
        fn = getattr(lib, f"{base}_{suffix}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def frame_step_batched_reference(
        hidden: torch.Tensor, write_row: int, valid: torch.Tensor,
        may_continue: torch.Tensor, posemb: torch.Tensor, xa_k: torch.Tensor,
        xa_v: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
        weights: MagpieWeights, config: MagpieConfig, enc_lengths: torch.Tensor,
        seeds: torch.Tensor, temperature: float, top_k: int, forbid_eos: torch.Tensor,
        rows: Optional[int] = None, stream=None):
    """Plain PyTorch batched frame, one slot at a time. ``rows`` only bounds
    the kernel's attention window; rows past it must hold no valid row, so
    the plain version attends over the whole masked cache."""
    from ...models.magpie import audio_frame_embedding
    from .decoder_step_batched import decode_step_batched_reference
    from .lt_sampler_batched import sample_frame_codes_batched_reference

    sampled, argmax = sample_frame_codes_batched_reference(hidden, weights, config, seeds,
                                                           temperature, top_k, forbid_eos)
    eos = config.audio_eos_id
    new_valid = may_continue & ~((sampled == eos) | (argmax == eos)).any(-1)
    mask = valid.to(torch.bool).clone()
    mask[:, write_row] = new_valid
    x_pe = audio_frame_embedding(sampled, weights, config) + posemb
    out = decode_step_batched_reference(x_pe, write_row, mask, xa_k, xa_v, k_cache, v_cache,
                                        weights, config, enc_lengths, rows, stream)
    return sampled, argmax, out, k_cache, v_cache


def check_tensor(who: str, name: str, t: torch.Tensor, shape: Tuple[int, ...],
                 dtype=torch.float32, broadcast_ok: bool = False) -> None:
    """Device, dtype and shape; contiguous rows, or one row broadcast over the
    leading dim (stride 0) where ``broadcast_ok``."""
    if t.device.type != "cuda" or t.dtype != dtype:
        raise ValueError(f"{who}: {name} must be a {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, want {shape}")
    rows_ok = t.is_contiguous() or (broadcast_ok and t.dim() == 2 and t.stride(0) == 0
                                    and t.stride(1) == 1)
    if not rows_ok or (dtype in DTYPES and t.data_ptr() % 16):
        raise ValueError(f"{who}: {name} must be contiguous (float: 16-byte aligned)")


def check_batch(who: str, B: int) -> None:
    if not 1 <= B <= MAX_SLOTS:
        raise ValueError(f"{who}: {B} slots, the kernel takes 1..{MAX_SLOTS}")


def check_rows(who: str, config: MagpieConfig, write_row: int, rows: Optional[int],
               S: int) -> int:
    """The attention bound (default max_seq), range-checked with the write row."""
    rows = S if rows is None else int(rows)
    if not (0 <= write_row < rows <= S and S <= config.max_pos):
        raise ValueError(f"{who}: write_row {write_row} / rows {rows} out of range for "
                         f"max_seq {S}")
    return rows


def _workspace(config: MagpieConfig, B: int, device, rows: int, enc_rows: int) -> dict:
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
    out.update(decode_attention.frame_workspace(config, B, rows, enc_rows, device))
    return out


def sampler_tensors(hidden, forbid_eos, seeds, weights: MagpieWeights,
                    config: MagpieConfig) -> dict:
    """{argument name: (tensor, shape, dtype, broadcast_ok)} of what the LT
    sampling sequence reads for B slots, in the hidden rows' dtype."""
    B, D = hidden.shape[0], config.d_model
    dt = hidden.dtype
    return {"hidden": (hidden, (B, D), dt, False),
            "forbid_eos": (forbid_eos, (B,), torch.bool, False),
            "seeds": (seeds, (B,), torch.int32, False),
            **{name: (t, shape, dt, False)
               for name, (t, shape) in lt_weight_tensors(weights, config).items()}}


def decoder_tensors(valid, enc_lengths, k_cache, v_cache, xa_k, xa_v, weights: MagpieWeights,
                    config: MagpieConfig, stream=None, dtype=torch.float32) -> dict:
    """{argument name: (tensor, shape, dtype, broadcast_ok)} of what the
    decoder sequence reads for B slots (besides its input rows and the
    quantized ``stream``'s tensors), in the compute ``dtype``."""
    B, L, S, D = k_cache.shape
    E, X = xa_k.shape[2], config.d_xa
    dt = dtype
    return {"valid": (valid, (B, S), torch.bool, True),
            "enc_lengths": (enc_lengths, (B,), torch.int32, False),
            "k_cache": (k_cache, (B, L, S, D), dt, False),
            "v_cache": (v_cache, (B, L, S, D), dt, False),
            "xa_k": (xa_k, (B, L, E, X), dt, False), "xa_v": (xa_v, (B, L, E, X), dt, False),
            **{name: (t, shape, dt, False)
               for name, (t, shape) in decoder_weight_tensors(weights, config, stream).items()}}


def launch(entry: str, B: int, tensors: dict, outputs: dict, config: MagpieConfig, device,
           stream=None, **scalars) -> None:
    """Validate ``tensors`` ({name: (tensor, shape, dtype, broadcast_ok)}) and
    the weight ``stream``, allocate a B-slot workspace on ``device`` and call
    the library's ``entry`` on that card with a FrameStepBatchedArgs of the
    tensors, the stream's tensors and mode, the workspace, ``outputs``
    ({name: tensor}) and the config's dims; ``scalars`` fill the remaining
    fields (unset pointers are null)."""
    c = config
    for name, (t, shape, dtype, broadcast_ok) in tensors.items():
        check_tensor(entry, name, t, shape, dtype, broadcast_ok)
    quantized = stream_tensors(entry, stream, c)
    batched_gemm.check_widths(entry, c, tensors["hidden"][2], stream_mode(stream))
    lib = build.load_library()
    ptrs = {name: t.data_ptr() for name, (t, *_) in tensors.items()}
    ptrs.update({name: t.data_ptr() for name, t in quantized.items()})
    # self-attention covers rows [0, rows), cross-attention enc_rows rows
    rows, enc_rows = scalars.get("rows", 1), scalars.get("enc_rows", 1)
    ptrs.update({k: v.data_ptr() for k, v in _workspace(c, B, device, rows, enc_rows).items()})
    ptrs.update({k: v.data_ptr() for k, v in outputs.items()})
    plans, n_plans = batched_gemm.plan_table(c)
    args = FrameStepBatchedArgs(
        **ptrs, batch=B, d_model=c.d_model, d_ffn=c.d_ffn, n_layers=c.dec_layers,
        d_xa=c.d_xa, n_heads=c.dec_sa_heads, xa_heads=c.dec_xa_heads, lt_dim=c.lt_dim,
        lt_ffn=c.lt_ffn_dim, n_cb=c.num_codebooks, vocab=c.vocab_per_cb,
        audio_bos_id=c.audio_bos_id, audio_eos_id=c.audio_eos_id, gelu_tanh=int(c.gelu_tanh),
        eps=float(c.eps), sa_scale=attn_scale(c.d_model // c.dec_sa_heads),
        xa_scale=attn_scale(c.d_xa // c.dec_xa_heads), lt_scale=attn_scale(c.lt_dim),
        stream_mode=stream_mode(stream), **decode_attention.frame_chunks(c, rows, enc_rows),
        gemm_plans=plans, n_gemm_plans=n_plans, **scalars)
    cuda_stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):  # the launch goes to the caches' card
        err = getattr(lib, entry)(ctypes.addressof(args), cuda_stream)
    build.check(err, entry)


def frame_step_batched(hidden: torch.Tensor, write_row: int, valid: torch.Tensor,
                       may_continue: torch.Tensor, posemb: torch.Tensor, xa_k: torch.Tensor,
                       xa_v: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       weights: MagpieWeights, config: MagpieConfig,
                       enc_lengths: torch.Tensor, seeds: torch.Tensor, temperature: float,
                       top_k: int, forbid_eos: torch.Tensor, rows: Optional[int] = None,
                       stream=None):
    """One full frame for B slots: sample 8 codes per slot, embed them, add
    the slot's position-embedding row, run the decoder at ``write_row``.

    hidden [B, d_model]; valid [B, max_seq] bool over the EXISTING rows (a
    broadcast [S] row is fine; column ``write_row`` is decided here as
    ``may_continue & ~frame_has_eos``); may_continue, forbid_eos [B] bool;
    posemb [B, d_model] rows (broadcast allowed); enc_lengths, seeds [B]
    int32; caches [B, L, max_seq, d_model]; xa_k/xa_v [B, L, enc, d_xa].
    ``rows`` (host int, default max_seq) bounds self-attention to rows
    [0, rows): no valid row may lie past it. ``stream`` supplies the four
    streamed decoder matrices when given. No value is read back to the
    host. Returns (sampled [B, 8] int32, argmax [B, 8] int32,
    hidden [B, d_model], k_cache, v_cache); the caches update in place.
    """
    global launches
    if hidden.device.type == "cpu":
        return frame_step_batched_reference(hidden, write_row, valid, may_continue, posemb,
                                            xa_k, xa_v, k_cache, v_cache, weights, config,
                                            enc_lengths, seeds, temperature, top_k, forbid_eos,
                                            rows, stream)
    if hidden.device.type != "cuda":
        raise ValueError(f"frame_step_batched: unsupported device {hidden.device}")
    c = config
    dtype = compute_dtype("frame_step_batched", hidden)
    B, S = k_cache.shape[0], k_cache.shape[2]
    check_batch("frame_step_batched", B)
    rows = check_rows("frame_step_batched", c, write_row, rows, S)
    check_config("frame_step_batched", c, top_k)
    dev = hidden.device
    sampled = torch.empty(B, c.num_codebooks, dtype=torch.int32, device=dev)
    argmax = torch.empty(B, c.num_codebooks, dtype=torch.int32, device=dev)
    hidden_out = torch.empty(B, c.d_model, dtype=dtype, device=dev)
    tensors = {**sampler_tensors(hidden, forbid_eos, seeds, weights, c),
               **decoder_tensors(valid, enc_lengths, k_cache, v_cache, xa_k, xa_v, weights, c,
                                 stream, dtype),
               "may_continue": (may_continue, (B,), torch.bool, False),
               "posemb": (posemb, (B, c.d_model), dtype, True)}
    launch(entry_name("magpie_frame_step_batched", dtype), B, tensors,
           dict(sampled=sampled, argmax=argmax, hidden_out=hidden_out), c, dev, stream,
           max_seq=S, enc_rows=xa_k.shape[2], write_row=int(write_row), rows=rows,
           valid_stride=valid.stride(0), posemb_stride=posemb.stride(0),
           top_k=min(int(top_k), c.vocab_per_cb), temperature=float(temperature))
    with _launches_lock:
        launches += 1
        mode_launches[MODES[stream_mode(stream)]] += 1
        count_dtype(dtype_launches, dtype)
    return sampled, argmax, hidden_out, k_cache, v_cache
