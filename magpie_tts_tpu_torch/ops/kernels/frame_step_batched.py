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

One launch takes at most ``MAX_SLOTS`` slots; kernels C, 7 and 8 run any
B >= 1 as the slot groups of ``slot_groups``, one launch (on the CPU, one
plain call) a group, each group's rows sliced from the caller's tensors
(``slot_group``) and its outputs written into rows of one [B, ...] output.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import torch

from ...config import MagpieConfig
from ...io.magpie_weights import MagpieWeights
from ..attention import attn_scale
from . import batched_gemm, build, decode_attention
from .frame_step import (DTYPES, MODES, check_config, compute_dtype, count_dtype,
                         decoder_weight_tensors, entry_name, lt_weight_tensors, stream_mode,
                         stream_tensors)

# Device launches since the last reset: one a slot group, so a frame of B
# slots adds len(slot_groups(B)).
launches = 0
mode_launches = dict.fromkeys(MODES, 0)  # the same, by weight stream
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype
_launches_lock = threading.Lock()  # engines on several cards launch from a thread pool

MAX_SLOTS = 64  # slots a launch: the GEMM's slot tiles, 4 m16 tiles
_PART_CAP = batched_gemm.PART_CAP  # most split-K partial rows a GEMM may produce

# The arguments and outputs of kernels C, 7 and 8 that hold one row a slot on
# their leading dim: a slot group takes its rows of these and nothing else.
# Named, never found by shape: at B = 12 the weights [L, K, N] lead with 12.
SLOT_TENSORS = frozenset((
    "hidden", "x_pe", "valid", "may_continue", "posemb", "seeds", "forbid_eos",
    "enc_lengths", "xa_k", "xa_v", "k_cache", "v_cache", "sampled", "argmax", "hidden_out"))


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
    """The slots of one launch: 1..MAX_SLOTS."""
    if not 1 <= B <= MAX_SLOTS:
        raise ValueError(f"{who}: {B} slots, a launch takes 1..{MAX_SLOTS}")


def slot_groups(B: int) -> List[Tuple[int, int]]:
    """The slot groups a frame of B >= 1 slots runs as: ordered, contiguous
    (start, stop) ranges that cover 0..B-1, each of at most ``MAX_SLOTS``
    (read here, at call time). Greedy: every group but the last holds
    MAX_SLOTS slots (96 -> 64 + 32, 129 -> 64 + 64 + 1), so the groups start
    at multiples of MAX_SLOTS and hold ceil(B / 16) m16 slot tiles in all,
    the fewest.

    Exact: a group's launch gives each of its slots what one launch of all B
    would (csrc/frame_step_batched.cu: the split-K plan and the mma K order do
    not depend on B, an mma row depends on its own slot's row alone, the
    partials are reduced in a fixed order); seeds, forbid_eos and the masks
    are per slot, and every group takes the shared write row and attention
    bound unchanged."""
    if B < 1:
        raise ValueError(f"{B} slots: a frame takes at least 1")
    return [(a, min(a + MAX_SLOTS, B)) for a in range(0, B, MAX_SLOTS)]


def slot_group(tensors: dict, start: int, stop: int) -> dict:
    """``tensors`` ({name: value}) for slots [start, stop): the SLOT_TENSORS
    sliced on their leading dim, everything else as it is. A slice is a
    view: in-place cache writes land in the caller's cache, a leading-dim
    slice of a contiguous tensor is contiguous, and a stride-0 broadcast
    row stays one."""
    return {k: v[start:stop] if k in SLOT_TENSORS else v for k, v in tensors.items()}


def run_groups(groups: List[Tuple[int, int]], per_slot: dict, out: dict, plain, kernel) -> None:
    """Run a frame as its slot ``groups`` (``slot_groups``), each on its rows
    of ``per_slot`` and of ``out`` ({name: [B, ...] output}, written in
    place) as ``slot_group`` gives them; a lone group takes both dicts as
    they are. On CPU tensors ``plain(**rows)`` returns the group's outputs
    in ``out``'s order, copied into its rows; on the card ``kernel(rows,
    out_rows, n)`` launches the group's n slots and counts the launch."""
    cpu = next(iter(out.values())).device.type == "cpu"
    for a, b in groups:
        g, o = ((per_slot, out) if len(groups) == 1
                else (slot_group(per_slot, a, b), slot_group(out, a, b)))
        if cpu:
            for t, r in zip(o.values(), plain(**g)):
                t.copy_(r)
        else:
            kernel(g, o, b - a)


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
    ({name: tensor}, contiguous, 16-byte aligned) and the config's dims;
    ``scalars`` fill the remaining fields (unset pointers are null)."""
    c = config
    check_batch(entry, B)
    for name, (t, shape, dtype, broadcast_ok) in tensors.items():
        check_tensor(entry, name, t, shape, dtype, broadcast_ok)
    for name, t in outputs.items():
        if t.device.type != "cuda" or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{entry}: output {name} must be a contiguous 16-byte aligned "
                             f"CUDA tensor")
    quantized = stream_tensors(entry, stream, c)
    batched_gemm.check_widths(entry, c, tensors["hidden"][2], stream_mode(stream))
    lib = build.load_library()
    ptrs = {name: t.data_ptr() for name, (t, *_) in tensors.items()}
    ptrs.update({name: t.data_ptr() for name, t in quantized.items()})
    # self-attention covers rows [0, rows), cross-attention enc_rows rows
    rows, enc_rows = scalars.get("rows", 1), scalars.get("enc_rows", 1)
    # The workspace stays referenced until the kernels are enqueued: freed
    # earlier, its memory could go at once to another host thread launching
    # on this card's stream (a mesh with a repeated device), and both
    # launches would share it.
    ws = _workspace(c, B, device, rows, enc_rows)
    ptrs.update({k: v.data_ptr() for k, v in ws.items()})
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
    streamed decoder matrices when given. Any B >= 1: one launch a slot group
    (``slot_groups``). No value is read back to the host. Returns (sampled
    [B, 8] int32, argmax [B, 8] int32, hidden [B, d_model], k_cache,
    v_cache); the caches update in place.
    """
    c = config
    dev = hidden.device
    B, S = k_cache.shape[0], k_cache.shape[2]
    groups = slot_groups(B)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"frame_step_batched: unsupported device {dev}")
    per_slot = dict(hidden=hidden, valid=valid, may_continue=may_continue, posemb=posemb,
                    xa_k=xa_k, xa_v=xa_v, k_cache=k_cache, v_cache=v_cache,
                    enc_lengths=enc_lengths, seeds=seeds, forbid_eos=forbid_eos)
    out = dict(sampled=torch.empty(B, c.num_codebooks, dtype=torch.int32, device=dev),
               argmax=torch.empty(B, c.num_codebooks, dtype=torch.int32, device=dev),
               hidden_out=torch.empty(B, c.d_model, dtype=hidden.dtype, device=dev))
    if dev.type == "cuda":
        dtype = compute_dtype("frame_step_batched", hidden)
        rows = check_rows("frame_step_batched", c, write_row, rows, S)
        check_config("frame_step_batched", c, top_k)
        entry = entry_name("magpie_frame_step_batched", dtype)

    def plain(**g):
        return frame_step_batched_reference(
            weights=weights, config=c, write_row=write_row, temperature=temperature,
            top_k=top_k, rows=rows, stream=stream, **g)[:3]

    def kernel(g, o, n):
        global launches
        tensors = {**sampler_tensors(g["hidden"], g["forbid_eos"], g["seeds"], weights, c),
                   **decoder_tensors(g["valid"], g["enc_lengths"], g["k_cache"], g["v_cache"],
                                     g["xa_k"], g["xa_v"], weights, c, stream, dtype),
                   "may_continue": (g["may_continue"], (n,), torch.bool, False),
                   "posemb": (g["posemb"], (n, c.d_model), dtype, True)}
        launch(entry, n, tensors, o, c, dev, stream,
               max_seq=S, enc_rows=xa_k.shape[2], write_row=int(write_row), rows=rows,
               valid_stride=valid.stride(0), posemb_stride=posemb.stride(0),
               top_k=min(int(top_k), c.vocab_per_cb), temperature=float(temperature))
        with _launches_lock:
            launches += 1
            mode_launches[MODES[stream_mode(stream)]] += 1
            count_dtype(dtype_launches, dtype)

    run_groups(groups, per_slot, out, plain, kernel)
    return out["sampled"], out["argmax"], out["hidden_out"], k_cache, v_cache
