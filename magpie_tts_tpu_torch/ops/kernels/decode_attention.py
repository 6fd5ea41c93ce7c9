"""The single-query attention of the frame kernels (A, 5, C, 8), alone.

Every decoder step of kernels A, 5, C and 8 attends to its cache rows and
its encoder rows through csrc/frame_kernels.cuh ``attend``: the rows of a
(slot, head) split into chunks of ``plan_attention(rows, d_head).chunk`` rows,
a block each, in two launches (scores; then the softmax over all the rows,
each chunk's rounded probabilities times its V rows, and the chunk partials
summed in chunk order by the last block of the (slot, head)). The frame
entry points take the plan from their wrappers; ``decode_attention`` launches
one such attention alone (the ``magpie_decode_attention_f32`` / ``_bf16``
entry points of csrc/frame_step_batched.cu), for the card tests and for the
attention family's timing: the frame kernels are what the main path runs.

On CPU tensors ``decode_attention`` runs ``decode_attention_reference``, the
plain attention; ``chunked_attention_model`` is a CPU model of the two
launches' arithmetic (the chunks, the fixed-order sums, the probabilities
rounded to T after normalising), held against both in the CPU tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from ..precision import matmul_f32
from . import build
from .build import DTYPES, count_dtype

ENTRY = "magpie_decode_attention"
launches = 0  # kernel launches since the last reset
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype

# csrc/frame_kernels.cuh: threads of a block, the chunk's bounds, the widest
# head, and a chunk's bytes of K in float32 (16 KB: 64 rows of a 64-wide head,
# 5 chunks at 300 rows and 10 at 640; 32 rows measured slower in both dtypes
# at B = 8 and 32 on an H100, PERF.md).
THREADS = 128
CHUNK_MIN, CHUNK_MAX = 16, 64
MAX_D_HEAD = 256
CHUNK_BYTES = 16384
NEG = -1e30


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    chunk: int    # rows a block attends
    chunks: int   # blocks of a (slot, head) at the launch's rows

    def bounds(self, rows: int):
        """[(first row, end row)] of each chunk of ``rows`` rows."""
        return [(r, min(rows, r + self.chunk)) for r in range(0, rows, self.chunk)]


@functools.lru_cache(maxsize=None)
def plan_attention(rows: int, d_head: int) -> AttnPlan:
    """The chunks of an attention over ``rows`` rows of heads ``d_head``
    wide: CHUNK_BYTES of float32 K a chunk, 16 to 64 rows. The chunk is a
    function of d_head alone: never of B, the dtype or the weight stream, and
    not of ``rows`` either, so an attention bounded to ``rows`` gives the bits
    of one over all max_seq rows (the rows past the bound are masked: they
    add exact zeros in the same order)."""
    if rows < 1 or not 1 <= d_head <= MAX_D_HEAD:
        raise ValueError(f"attention plan: rows {rows}, d_head {d_head} out of range")
    chunk = min(CHUNK_MAX, max(CHUNK_MIN, CHUNK_BYTES // (4 * d_head)))
    return AttnPlan(chunk=chunk, chunks=-(-rows // chunk))


def group_sums_floats(d_head: int, dtype: torch.dtype) -> int:
    """Floats of a block's group sums ([row groups, d_head] in shared
    memory, sized for 1024)."""
    ve = 16 // (4 if dtype == torch.float32 else 2)
    lanes = min(32, d_head // ve)
    return THREADS // lanes * d_head


# Static shared memory of the two kernels, the larger: q (MAX_D_HEAD floats)
# for the scores; the reduction slots, a chunk's probabilities, the group sums
# (1024 floats) and the ticket flag for the second.
SMEM_BYTES = max(4 * MAX_D_HEAD, 4 * (32 + CHUNK_MAX + THREADS * 8) + 4)


def workspace_sizes(B: int, heads: int, rows: int, d_head: int) -> dict:
    """{buffer: elements} of one attention: scores [B, heads, rows] and
    partial outputs [B, heads, chunks, d_head] (float32), one int32 ticket a
    (slot, head)."""
    plan = plan_attention(rows, d_head)
    return {"sc": B * heads * rows, "po": B * heads * plan.chunks * d_head, "tk": B * heads}


def frame_workspace_sizes(config, B: int, rows: int, enc_rows: int) -> dict:
    """The largest workspace of a frame's three attentions: self-attention
    over ``rows`` cache rows, cross-attention over ``enc_rows`` encoder rows,
    the LT's over its num_codebooks rows."""
    c = config
    kinds = [(c.dec_sa_heads, rows, c.d_model // c.dec_sa_heads),
             (c.dec_xa_heads, enc_rows, c.d_xa // c.dec_xa_heads),
             (1, c.num_codebooks, c.lt_dim)]
    sizes = [workspace_sizes(B, *k) for k in kinds]
    return {key: max(s[key] for s in sizes) for key in sizes[0]}


def frame_chunks(config, rows: int, enc_rows: int) -> dict:
    """The chunk fields of a frame entry point's arguments."""
    c = config
    return dict(sa_chunk=plan_attention(rows, c.d_model // c.dec_sa_heads).chunk,
                xa_chunk=plan_attention(enc_rows, c.d_xa // c.dec_xa_heads).chunk,
                lt_chunk=plan_attention(c.num_codebooks, c.lt_dim).chunk)


def frame_workspace(config, B: int, rows: int, enc_rows: int, device) -> dict:
    """{att_sc, att_po, att_tk} tensors of a frame on ``device``."""
    sz = frame_workspace_sizes(config, B, rows, enc_rows)
    return {"att_sc": torch.empty(sz["sc"], dtype=torch.float32, device=device),
            "att_po": torch.empty(sz["po"], dtype=torch.float32, device=device),
            "att_tk": torch.empty(sz["tk"], dtype=torch.int32, device=device)}


class AttentionArgs(ctypes.Structure):
    """Mirror of ``struct AttentionArgs`` in csrc/frame_step_batched.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 "q k v rows_dev valid new_valid out sc po tk".split()] +
                [("slot_stride", ctypes.c_longlong)] +
                [(n, ctypes.c_int) for n in
                 ("sq nq row_stride rows valid_stride write_row heads d_head batch "
                  "chunk").split()] +
                [("scale", ctypes.c_float)])


def declare(lib: ctypes.CDLL) -> None:
    for suffix in DTYPES.values():
        fn = getattr(lib, f"{ENTRY}_{suffix}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _masks(B, rows, valid, write_row, new_valid, n_rows):
    """[B, rows] bool: row r counts for slot b (rows past n_rows[b] never)."""
    out = torch.ones(B, rows, dtype=torch.bool) if valid is None else valid[:, :rows].clone()
    if valid is not None and new_valid is not None and write_row < rows:
        out[:, write_row] = new_valid != 0
    out &= torch.arange(rows)[None, :] < torch.tensor(n_rows)[:, None]
    return out


def _slot_rows(B: int, rows: int, rows_dev) -> list:
    if rows_dev is None:
        return [rows] * B
    return [min(max(int(n), 1), rows) for n in rows_dev.tolist()]


def _inputs(q, k, v, heads, rows, rows_dev, valid, write_row, new_valid):
    """Host copies of the kernel's inputs, q summed over its partials and
    rounded to T: (q [B, heads, d_head] float32, K / V [B, rows, W] float32,
    row counts, masks [B, rows])."""
    dt = k.dtype
    if q.dim() == 3:                      # [Sq, B, Nq] partials, summed in order
        acc = q[0].float().clone()
        for s in range(1, q.shape[0]):
            acc = acc + q[s].float()
        q = acc
    B, W = k.shape[0], k.shape[2]
    d_head = W // heads
    qr = q.float().to(dt).float()[:, :heads * d_head].reshape(B, heads, d_head).cpu()
    kk, vv = k[:, :rows].float().cpu(), v[:, :rows].float().cpu()
    valid_c = None if valid is None else valid.cpu()
    nv = None if new_valid is None else new_valid.cpu()
    n_rows = _slot_rows(B, rows, rows_dev)
    return qr, kk, vv, n_rows, _masks(B, rows, valid_c, write_row, nv, n_rows)


def decode_attention_reference(q, k, v, heads: int, scale: float, rows: Optional[int] = None,
                               rows_dev=None, valid=None, write_row: int = 0,
                               new_valid=None) -> torch.Tensor:
    """Plain attention, slot by slot: scores (rnd(q) . K) * scale in float32
    over the slot's rows [0, n_rows), masked rows -1e30, probabilities
    exp(s - max) / sum rounded to T, times V in float32, rounded to T.
    Returns out [B, heads * d_head] float32 (values in T), on q's device."""
    dt, dev = k.dtype, q.device
    rows = k.shape[1] if rows is None else int(rows)
    qr, kk, vv, n_rows, mask = _inputs(q, k, v, heads, rows, rows_dev, valid, write_row,
                                       new_valid)
    B, d_head = qr.shape[0], qr.shape[2]
    out = torch.zeros(B, heads * d_head, dtype=torch.float32)
    for b in range(B):
        n = n_rows[b]
        kh = kk[b, :n].reshape(n, heads, d_head).transpose(0, 1)
        vh = vv[b, :n].reshape(n, heads, d_head).transpose(0, 1)
        s = matmul_f32(qr[b][:, None, :], kh.transpose(-1, -2))[:, 0] * scale
        s = torch.where(mask[b, :n][None, :], s, torch.full_like(s, NEG))
        e = torch.exp(s - s.max(-1, keepdim=True).values)
        p = (e / e.sum(-1, keepdim=True)).to(dt).float()
        out[b] = matmul_f32(p[:, None, :], vh)[:, 0].to(dt).float().reshape(-1)
    return out.to(dev)


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim left to right in float32 (a fixed order)."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def block_sum_order(x: torch.Tensor) -> torch.Tensor:
    """common.cuh block_sum over THREADS threads of a strided float32 loop
    (thread t sums x[t], x[t + THREADS], ...): each warp's butterfly, then
    the warps in order. x: [..., n]."""
    n = x.shape[-1]
    pad = -(-n // THREADS) * THREADS
    xs = torch.zeros(*x.shape[:-1], pad, dtype=torch.float32)
    xs[..., :n] = x
    per_thread = _ordered_sum(xs.reshape(*x.shape[:-1], pad // THREADS, THREADS)
                              .transpose(-1, -2))           # [..., THREADS]
    w = per_thread.reshape(*x.shape[:-1], THREADS // 32, 32)
    for o in (16, 8, 4, 2, 1):                              # butterfly: lane + lane ^ o
        idx = torch.arange(32) ^ o
        w = w + w[..., idx]
    return _ordered_sum(w[..., 0])


def chunked_attention_model(q, k, v, heads: int, scale: float, rows: Optional[int] = None,
                            rows_dev=None, valid=None, write_row: int = 0, new_valid=None,
                            chunk: Optional[int] = None, return_probs: bool = False):
    """A CPU model of the two launches: per (slot, head), the scores in
    float32 (as plain); the max and the sum of exp(s - max) over all the slot's rows in
    block_sum's order; each chunk's probabilities rnd(exp(s - m) / sum) and
    its float32 partial of p . V; the partials summed in chunk order and
    rounded to T. ``chunk`` defaults to the plan's. Returns out [B, heads *
    d_head] (and the probabilities [B, heads, rows] with ``return_probs``)."""
    dt, dev = k.dtype, q.device
    rows = k.shape[1] if rows is None else int(rows)
    qr, kk, vv, n_rows, mask = _inputs(q, k, v, heads, rows, rows_dev, valid, write_row,
                                       new_valid)
    B, d_head = qr.shape[0], qr.shape[2]
    chunk = plan_attention(rows, d_head).chunk if chunk is None else chunk
    out = torch.zeros(B, heads * d_head, dtype=torch.float32)
    probs = torch.zeros(B, heads, rows, dtype=torch.float32)
    for b in range(B):
        n = n_rows[b]
        kh = kk[b, :n].reshape(n, heads, d_head).transpose(0, 1)
        vh = vv[b, :n].reshape(n, heads, d_head).transpose(0, 1)
        s = matmul_f32(qr[b][:, None, :], kh.transpose(-1, -2))[:, 0] * scale
        s = torch.where(mask[b, :n][None, :], s, torch.full_like(s, NEG))
        m = s.max(-1, keepdim=True).values
        e = torch.exp(s - m)
        total = block_sum_order(e)[:, None]
        p = (e / total).to(dt).float()
        probs[b, :, :n] = p
        parts = [(p[:, r0:r1, None] * vh[:, r0:r1]).sum(1, dtype=torch.float32)
                 for r0, r1 in AttnPlan(chunk, 0).bounds(n)]
        o = parts[0]
        for part in parts[1:]:
            o = o + part
        out[b] = o.to(dt).float().reshape(-1)
    return (out.to(dev), probs) if return_probs else out.to(dev)


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{ENTRY}: {name} must be a {ndim}-d {dtype} CUDA tensor, "
                         f"got {t.dim()}-d {t.dtype} on {t.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                     scale: float, rows: Optional[int] = None,
                     rows_dev: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None, write_row: int = 0,
                     new_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One attention of the frame kernels for B slots.

    q: [B, heads * d_head] float32 rows or [Sq, B, heads * d_head] float32
    partials (summed, then rounded to T); k / v: [B, S, W] in T (float32 or
    bfloat16; rows contiguous, any slot stride: a layer of a [B, L, S, W]
    cache is fine), W = heads * d_head; rows [0, rows) attended (default S),
    or each slot's min(max(rows_dev[b], 1), rows) with ``rows_dev`` [B] int32;
    ``valid`` [B, S] bool (row stride 0 broadcasts one row) masks rows, row
    ``write_row`` taken from ``new_valid`` [B] int32 when given. Returns out
    [B, W] float32 (values in T).
    """
    global launches
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, heads, scale, rows, rows_dev, valid,
                                          write_row, new_valid)
    dtype = k.dtype
    if dtype not in DTYPES:
        raise ValueError(f"{ENTRY}: compute dtype {dtype} is not one the kernels take")
    _check(k, "k", dtype, 3)
    _check(v, "v", dtype, 3)
    B, S, W = k.shape
    if tuple(v.shape) != (B, S, W) or v.stride() != k.stride():
        raise ValueError(f"{ENTRY}: v must have k's shape and strides")
    if k.stride(2) != 1 or k.stride(1) != W or W % heads:
        raise ValueError(f"{ENTRY}: k / v rows must be contiguous, W a multiple of heads")
    rows = S if rows is None else int(rows)
    if not 1 <= rows <= S or not 1 <= B <= 64:
        raise ValueError(f"{ENTRY}: rows {rows} of {S}, B {B} out of range (B <= 64 a "
                         f"launch; the frame wrappers run more as slot groups)")
    sq = 1 if q.dim() == 2 else q.shape[0]
    _check(q, "q", torch.float32, q.dim())
    if tuple(q.shape[-2:]) != (B, W) or not q.is_contiguous():
        raise ValueError(f"{ENTRY}: q must be a contiguous [(Sq,) {B}, {W}] float32 tensor")
    d_head = W // heads
    plan = plan_attention(rows, d_head)
    ws = workspace_sizes(B, heads, rows, d_head)
    dev = k.device
    out = torch.empty(B, W, dtype=torch.float32, device=dev)
    sc = torch.empty(ws["sc"], dtype=torch.float32, device=dev)
    po = torch.empty(ws["po"], dtype=torch.float32, device=dev)
    tk = torch.empty(ws["tk"], dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    if valid is not None:
        _check(valid, "valid", torch.bool, 2)
    for name, t in (("rows_dev", rows_dev), ("new_valid", new_valid)):
        if t is not None:
            _check(t, name, torch.int32, 1)
    args = AttentionArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), rows_dev=ptr(rows_dev),
        valid=ptr(valid), new_valid=ptr(new_valid), out=out.data_ptr(), sc=sc.data_ptr(),
        po=po.data_ptr(), tk=tk.data_ptr(), slot_stride=k.stride(0), sq=sq, nq=W,
        row_stride=W, rows=rows, valid_stride=0 if valid is None else valid.stride(0),
        write_row=int(write_row), heads=heads, d_head=d_head, batch=B, chunk=plan.chunk,
        scale=float(scale))
    lib = build.load_library()
    entry = f"{ENTRY}_{DTYPES[dtype]}"
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(ctypes.addressof(args),
                                  torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, entry)
    launches += 1
    count_dtype(dtype_launches, dtype)
    return out
