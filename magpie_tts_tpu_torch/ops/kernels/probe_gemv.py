"""Kernels 11-13: the low-bit GEMV probes (scripts/probe_int4.py).

``gemv(x, w, fmt)`` replaces the TPU probes ``probe_native_int4``,
``probe_packed_int8`` and ``probe_bf16``: x [8, K] bf16 @ W [K, N], every
weight widened to float, summed in float32, out [8, N] float32. On CUDA
tensors it launches csrc/probe_gemv.cu or raises; on CPU tensors it runs
``gemv_reference``: unpack, then ``x.float() @ w.float()``.

The weight formats (``FORMATS``) and their storage:

- ``native_int4``: uint8 [K, N / 2], two consecutive columns a byte, the
  even column in the low nibble (a ``jnp.int4`` array's element order);
- ``packed_int8``: int8 [K / 2, N], the probe's packing: byte [r, c] holds
  ``w[r, c] & 15`` low and ``w[r + K / 2, c] & 15`` high;
- ``bf16``: bf16 [K, N].

A nibble n is the signed value ``(n ^ 8) - 8``.

All three kernels split K across the card in one kernel body:
``plan_gemv(fmt, K, N)`` gives the column tile, the K split and the
cluster (the CTAs of a tile, one a split, meet in rank 0's shared memory and
are summed there in rank order); a ``packed_int8`` split reads byte rows
that hold two ranges of K (``GemvPlan.bounds``); ``split_model`` is a CPU
model of the sum order. ``gemv_stamps`` runs one launch with per-block
phase stamps (``read_phases``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import build

FORMATS = ("native_int4", "packed_int8", "bf16")
M = 8  # rows of x, as the probe has them
launches = 0  # kernel launches since the last reset
format_launches = dict.fromkeys(FORMATS, 0)  # the same, by weight format
# csrc/probe_gemv.cu: output columns a CTA, K rows of an mma step, the
# largest cluster (the most splits a launch takes), the plan's most splits
# and fewest K rows a CTA, phase stamps a block, the C format codes of the
# split entry point.
TILE = 64
STEP = 16
MAX_CLUSTER = 8
PLAN_SPLITS = 4
MIN_ROWS = 128
PACKED_MIN_ROWS = 256  # packed_int8: its own fewest K rows a CTA and fewest splits
PACKED_MIN_SPLITS = 2
STAMPS = 5
STAMP_NAMES = ("start", "landed", "products", "partials", "end")
_FMT_CODE = {"native_int4": 0, "packed_int8": 1, "bf16": 2}


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    tile: int     # output columns a CTA
    tiles: int    # column tiles: N / tile
    splits: int   # K splits: CTAs of a tile's cluster
    kchunk: int   # K rows a CTA
    packed: bool = False  # packed_int8: a CTA's byte rows hold two ranges of K

    @property
    def cluster(self) -> int:
        return self.splits

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits

    def bounds(self):
        """The K rows of each split, in rank order: (first row, end row), or
        for packed_int8 ((first, end) of the low nibbles' rows, (first, end)
        of the high nibbles', the same plus K / 2)."""
        if not self.packed:
            return [(r * self.kchunk, (r + 1) * self.kchunk) for r in range(self.splits)]
        h, half = self.kchunk // 2, self.splits * self.kchunk // 2
        return [((r * h, (r + 1) * h), (half + r * h, half + (r + 1) * h))
                for r in range(self.splits)]

    def steps(self, K: int) -> int:
        """mma steps a split must divide: of K rows, or of packed byte rows."""
        return (K // 2 if self.packed else K) // STEP


def _check_shape(K: int, N: int) -> None:
    if not (256 <= K <= 1024 and K % 256 == 0 and N >= TILE and N % TILE == 0):
        raise ValueError(f"probe_gemv: K {K} must be a multiple of 256 in [256, 1024] and N "
                         f"{N} a multiple of {TILE}")


@functools.lru_cache(maxsize=None)
def plan_gemv(fmt: str, K: int, N: int) -> GemvPlan:
    """The launch plan of a format at (K, N): N / TILE column tiles x the
    most splits of K, at most PLAN_SPLITS, that leave a CTA MIN_ROWS rows
    (csrc/probe_gemv.cu plan_splits: 2 at K 256, 4 at K 512 to 1024); for
    packed_int8 PACKED_MIN_ROWS rows, and at least PACKED_MIN_SPLITS (2 at
    K 256 and 512, 3 at 768, 4 at 1024). K is a multiple of 256, so they are
    whole mma steps, of packed byte rows too. The rules are what sweeps of
    every split measured fastest on an H100 (PERF.md §6). A
    function of the format and the shapes alone, so the sum order, and the
    bits, are fixed by them."""
    _check_shape(K, N)
    if fmt not in FORMATS:
        raise ValueError(f"probe_gemv: unknown format {fmt!r}, want one of {FORMATS}")
    if fmt == "packed_int8":
        splits = min(PLAN_SPLITS, max(PACKED_MIN_SPLITS, K // PACKED_MIN_ROWS))
    else:
        splits = min(PLAN_SPLITS, K // MIN_ROWS)
    return GemvPlan(tile=TILE, tiles=N // TILE, splits=splits, kchunk=K // splits,
                    packed=fmt == "packed_int8")


def declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fmt in FORMATS:
        fn = getattr(lib, f"magpie_probe_gemv_{fmt}")
        fn.argtypes = [p, p, p, i, i, p]
        fn.restype = ctypes.c_int
    lib.magpie_probe_gemv_split.argtypes = [i, p, p, p, i, i, i, p, p]
    lib.magpie_probe_gemv_split.restype = ctypes.c_int


def pack_native_int4(w: np.ndarray) -> np.ndarray:
    """int weights in [-8, 8) [K, N] -> uint8 [K, N / 2] (low nibble = even column)."""
    w = np.asarray(w, np.int64)
    return (((w[:, 1::2] & 15) << 4) | (w[:, 0::2] & 15)).astype(np.uint8)


def pack_int8(w: np.ndarray) -> np.ndarray:
    """int weights in [-8, 8) [K, N] -> int8 [K / 2, N] (rows r and r + K / 2
    in the low and high nibble; scripts/probe_int4.py probe_packed_int8)."""
    w = np.asarray(w, np.int64)
    half = w.shape[0] // 2
    return (((w[half:] & 15) << 4) | (w[:half] & 15)).astype(np.uint8).view(np.int8)


def _nibbles(p: torch.Tensor):
    p = p.to(torch.int32)
    return ((p & 15) ^ 8) - 8, (((p >> 4) & 15) ^ 8) - 8


def unpack(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """The stored weight as [K, N] values (int32 for the nibble formats)."""
    if fmt == "native_int4":
        lo, hi = _nibbles(w)
        return torch.stack((lo, hi), dim=-1).reshape(w.shape[0], 2 * w.shape[1])
    if fmt == "packed_int8":
        lo, hi = _nibbles(w)
        return torch.cat((lo, hi), dim=0)
    if fmt == "bf16":
        return w
    raise ValueError(f"probe_gemv: unknown format {fmt!r}, want one of {FORMATS}")


def gemv_reference(x: torch.Tensor, w: torch.Tensor, fmt: str) -> torch.Tensor:
    """Plain version: unpack, widen, ``x.float() @ w.float()``."""
    return x.float() @ unpack(w, fmt).float()


def dims(w: torch.Tensor, fmt: str):
    """(K, N, storage dtype) of a stored weight."""
    if fmt == "native_int4":
        return w.shape[0], 2 * w.shape[1], torch.uint8
    if fmt == "packed_int8":
        return 2 * w.shape[0], w.shape[1], torch.int8
    if fmt == "bf16":
        return w.shape[0], w.shape[1], torch.bfloat16
    raise ValueError(f"probe_gemv: unknown format {fmt!r}, want one of {FORMATS}")


def split_model(x: torch.Tensor, w: torch.Tensor, fmt: str, plan=None) -> torch.Tensor:
    """A CPU model of kernels 11-13's sum order: each split's float32
    partial of x[:, rows] @ W[rows] over its rows (``plan.bounds()``), 16
    rows (one mma) at a time summed exactly and rounded to float32, the steps
    added in order (packed_int8: a byte-row step's low-nibble rows, then its
    high-nibble rows, step by step); then the splits added in rank order.
    The tensor cores' rounding inside an mma is not modelled (within 1e-5 of
    the largest value in bf16; exact for integer weights and small-integer
    x, where every sum is an integer below 2^24). ``plan`` defaults to the
    format's."""
    xf, wf = x.double().cpu(), unpack(w, fmt).double().cpu()
    K, N = wf.shape
    plan = plan_gemv(fmt, K, N) if plan is None else plan
    out = None
    for ranges in plan.bounds():
        ranges = ranges if plan.packed else (ranges,)
        part = torch.zeros(xf.shape[0], N, dtype=torch.float32)
        for step in range(0, ranges[0][1] - ranges[0][0], STEP):
            for k0, _ in ranges:
                k = k0 + step
                part = part + (xf[:, k:k + STEP] @ wf[k:k + STEP]).float()
        out = part if out is None else out + part
    return out.to(x.device)


def _check_inputs(x: torch.Tensor, w: torch.Tensor, fmt: str):
    """(K, N) of a launch's inputs on a card, or ValueError."""
    if x.device.type != "cuda":
        raise ValueError(f"probe_gemv: unsupported device {x.device}")
    if w.dim() != 2:
        raise ValueError(f"probe_gemv: w must be 2-D, got shape {tuple(w.shape)}")
    K, N, wdt = dims(w, fmt)
    if x.dtype != torch.bfloat16 or tuple(x.shape) != (M, K) or not x.is_contiguous():
        raise ValueError(f"probe_gemv: x must be a contiguous bf16 [{M}, {K}] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if (w.dtype != wdt or w.device != x.device or not w.is_contiguous()
            or w.data_ptr() % 16):
        raise ValueError(f"probe_gemv: a {fmt} weight must be a contiguous, 16-byte aligned "
                         f"{wdt} tensor on {x.device}, got {w.dtype} on {w.device}")
    _check_shape(K, N)
    return K, N


def gemv(x: torch.Tensor, w: torch.Tensor, fmt: str, splits=None, stamps=None) -> torch.Tensor:
    """x [8, K] bf16, w in ``fmt``'s storage -> x @ W [8, N] float32.
    ``splits``, a K split other than the plan's (a divisor of the plan's mma
    steps, K / 16 or for packed_int8 K / 32, at most 8: for sweeps and
    tests); ``stamps``, a zeroed int64 [splits * N / 64, STAMPS] tensor for
    the phase stamps."""
    global launches
    if x.device.type == "cpu":
        return gemv_reference(x, w, fmt)
    K, N = _check_inputs(x, w, fmt)
    if x.data_ptr() % 16:
        # the kernels copy x by 16-byte cp.async: a view at an unaligned
        # offset goes to a fresh (aligned) buffer on the card first
        x = x.clone()
    plan = plan_gemv(fmt, K, N)
    split_entry = splits is not None or stamps is not None
    splits = plan.splits if splits is None else int(splits)
    if not (1 <= splits <= MAX_CLUSTER and plan.steps(K) % splits == 0):
        raise ValueError(f"probe_gemv: splits {splits} must divide the {plan.steps(K)} mma "
                         f"steps of {fmt} at K {K} and be at most {MAX_CLUSTER}")
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != x.device
                               or tuple(stamps.shape) != (plan.tiles * splits, STAMPS)
                               or not stamps.is_contiguous()):
        raise ValueError(f"probe_gemv: stamps must be a contiguous int64 "
                         f"[{plan.tiles * splits}, {STAMPS}] tensor on {x.device}")
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    lib = build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if not split_entry:
            err = getattr(lib, f"magpie_probe_gemv_{fmt}")(x.data_ptr(), w.data_ptr(),
                                                           out.data_ptr(), K, N, stream)
        else:
            err = lib.magpie_probe_gemv_split(
                _FMT_CODE[fmt], x.data_ptr(), w.data_ptr(), out.data_ptr(), K, N, splits,
                None if stamps is None else stamps.data_ptr(), stream)
    build.check(err, f"probe_gemv[{fmt}]")
    launches += 1
    format_launches[fmt] += 1
    return out


def gemv_stamps(x: torch.Tensor, w: torch.Tensor, fmt: str, splits=None):
    """One launch of kernels 11-13 on a card with phase stamps: (out, int64
    [CTAs, STAMPS] %globaltimer ns: start, all weights and x landed,
    products summed, the other ranks' partials landed in rank 0 (the other
    ranks: theirs pushed), end)."""
    K, N = _check_inputs(x, w, fmt)
    plan = plan_gemv(fmt, K, N)
    stamps = torch.zeros(plan.tiles * (plan.splits if splits is None else int(splits)), STAMPS,
                         dtype=torch.int64, device=x.device)
    return gemv(x, w, fmt, splits=splits, stamps=stamps), stamps


def read_phases(stamps: torch.Tensor, names=STAMP_NAMES) -> dict:
    """us from the first CTA's start to the last CTA's reaching each stamp
    (``names``: the stamps' phases), and the median CTA's us from its own
    start."""
    t = stamps.cpu().double()
    t0 = float(t[:, 0].min())
    res = {}
    for i, name in enumerate(names):
        res[f"{name}_last_us"] = (float(t[:, i].max()) - t0) / 1e3
        res[f"{name}_median_us"] = float((t[:, i] - t[:, 0]).median()) / 1e3
    res["ctas"] = int(t.shape[0])
    return res
