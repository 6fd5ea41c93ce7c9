"""Kernel B: fused HalfSnake -> causal dilated Conv1d (+ bias, + residual).

``snake_causal_conv`` replaces the TPU kernels
magpie_tts_tpu/ops/pallas_kernels/codec_conv.py ``snake_causal_conv`` and
``snake_causal_conv_packed`` (one unpacked kernel serves every channel
count). On CUDA tensors it launches csrc/codec_conv.cu or raises; on CPU
tensors it runs ``snake_causal_conv_reference`` (plain ``half_snake`` +
``causal_conv1d`` with the residual, from models/codec.py). Both run in
float32 or bfloat16, x's dtype; every other tensor must have it, and any
other dtype raises.

``plan_conv`` is the kernel's launch plan (its tiles, their padding, shared
memory and grid), computed here from the shapes so that the CPU tests can
check it; the kernel refuses a plan it does not take. ``conv_plans`` lists
every plan the kernel takes with the cost model's rank, and
``snake_causal_conv_planned`` launches one of them:
scripts/conv_plan_sweep.py times each against the pick.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from . import build
from .build import DTYPES, count_dtype

launches = 0  # kernel launches since the last reset
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype


# The kernels' shapes (csrc/conv_mma.cuh): 8 warps of 32 rows each, a ring
# of 3 weight slices, the n8 tiles a warp may hold per dtype (the
# instantiated counts), the window's row pad, an H100 block's and SM's
# shared memory.
THREADS, WARPS, WARP_ROWS, STAGES = 256, 8, 32, 3
WARP_NTS = {torch.float32: (1, 2, 4), torch.bfloat16: (1, 2, 4, 7, 8)}
ELT = {torch.float32: 4, torch.bfloat16: 2}
A_PAD = {torch.float32: 4, torch.bfloat16: 8}
MAX_SMEM, SM_SMEM = 232448, 233472
N_SMS = 132  # an H100 SXM's SMs
TILES_M = (256, 128, 64, 32)
# The plan's cost model, in cycles of one SM (4 schedulers): a step's
# barrier and latency chain, a chunk's window load, instructions a warp
# issues per copy of the weight ring and per activated (or copied) window
# element. Fitted by hand to the per-plan times that
# scripts/conv_plan_sweep.py measures on an H100 (it prints, per class,
# the pick's time beside the best plan's); it ranks plans, nothing else
# reads it.
_C_STEP, _C_CHUNK, _C_FILL, _C_ACT, _C_COPY = 250.0, 1500.0, 12.0, 40.0, 8.0


def declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix in DTYPES.values():
        fn = getattr(lib, f"magpie_snake_conv_{suffix}")
        fn.argtypes = [p, p, p, p, i, i, ctypes.c_float, p, p, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int


def window_stride(cols: int, dtype: torch.dtype) -> int:
    """A window row's stride in elements: cols up to a multiple of 16 plus
    the pad that makes it an odd multiple of 16 bytes (ldmatrix's 8 rows in
    8 bank groups)."""
    return -(-cols // 16) * 16 + A_PAD[dtype]


def ring_stride(tile_n: int) -> int:
    """A weight slice's row stride: 8 mod 16 elements (conflict-free B loads)."""
    return tile_n if tile_n % 16 == 8 else tile_n + 8


def chunk_width(c_in: int, dtype: torch.dtype) -> int:
    """Input channels per chunk: C_in split evenly into the fewest chunks of
    at most 128 channels in bf16, 64 in float32 (whose wider slices would
    leave one block an SM), each a whole number of mma steps (16 / 8
    channels), so that little of K is zero padding; wide chunks mean fewer
    ring steps, each with more products behind its barrier. A function of
    C_in and the dtype alone."""
    most, step = (128, 16) if dtype == torch.bfloat16 else (64, 8)
    chunks = -(-c_in // most)
    return -(-(-(-c_in // chunks)) // step) * step


def smem_bytes(tile_m: int, tile_n: int, k: int, dilation: int, dtype: torch.dtype,
               kc: int) -> int:
    """The window of one chunk (tile_m + halo rows x kc channels) and the
    ring of STAGES [kc x tile_n] weight slices, in the operand type."""
    return ELT[dtype] * ((tile_m + (k - 1) * dilation) * window_stride(kc, dtype)
                         + STAGES * kc * ring_stride(tile_n))


def k_order(c_in: int, k: int, dtype: torch.dtype) -> Tuple[Tuple[int, int], ...]:
    """The kernel's K order, (first input channel of the chunk, tap) per
    ring step: chunk by chunk, tap by tap inside a chunk. It depends on C_in,
    k and the dtype only, never on T, the tiles or N, so a row's value does
    not depend on where its tile starts."""
    kc = chunk_width(c_in, dtype)
    return tuple((c0, tap) for c0 in range(0, c_in, kc) for tap in range(k))


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    tile_m: int   # time rows per block: 32 x the warps stacked over rows
    tile_n: int   # output channels per block: the other warps x their n8 tiles x 8
    kc: int       # input channels per chunk (chunk_width: with k, the K order)
    grid: Tuple[int, int, int]  # (time tiles, output-channel tiles, N)
    smem: int     # dynamic shared memory bytes

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _copy_bytes(c_out: int, elt: int) -> int:
    """The widest cp.async the weight rows allow (pick_vec, for an aligned
    tensor); ``elt``: plain loads."""
    return next((b for b in (16, 8, 4) if (c_out * elt) % b == 0), elt)


def conv_plans(n: int, T: int, c_in: int, c_out: int, k: int, dilation: int,
               dtype: torch.dtype, n_sms: int = N_SMS,
               act: bool = True) -> Tuple[Tuple[float, ConvPlan], ...]:
    """Every plan the kernel takes for one conv (tile_m rows by warps
    stacked over rows; tile_n = the other warps side by side x n8 tiles
    each; no whole warp column of padding; the shared memory fits), each
    with its cost: the busiest SM's cycles, its blocks' issued instructions
    (products, weight copies, window) plus each wave's exposed latency (a
    ring step's barrier and chain, a chunk's window load)."""
    plans = []
    kc = chunk_width(c_in, dtype)
    halo = (k - 1) * dilation
    chunks = -(-c_in // kc)
    steps = chunks * k
    elt = ELT[dtype]
    copy = _copy_bytes(c_out, elt)
    for tile_m in TILES_M:
        warps_n = WARPS // (tile_m // WARP_ROWS)
        for nt in WARP_NTS[dtype]:
            tile_n = warps_n * nt * 8
            if tile_n >= c_out + warps_n * 8:  # a whole warp column of padding
                continue
            smem = smem_bytes(tile_m, tile_n, k, dilation, dtype, kc)
            if smem > MAX_SMEM:
                continue
            grid = (-(-T // tile_m), -(-c_out // tile_n), n)
            blocks = grid[0] * grid[1] * grid[2]
            per_sm = max(1, min(2, SM_SMEM // (smem + 1024)))
            if dtype == torch.float32:  # per k8: A split, then per n8 tile B split + 6 mma
                ks_instr = (kc // 8) * (2 + 24 + nt * 14)
            else:                       # per k16: 2 A ldmatrix, per n8 tile 1 + 2 mma
                ks_instr = (kc // 16) * (2 + nt * 3)
            copies = kc * tile_n * elt / copy / THREADS
            fill = copies * _C_FILL * (3 if copy < 4 else 1)
            window = -(-(tile_m + halo) * kc // THREADS) * (_C_ACT if act else _C_COPY)
            issue = (steps * (ks_instr + fill) + chunks * window) * WARPS / 4
            latency = steps * _C_STEP + chunks * _C_CHUNK
            cost = (-(-blocks // n_sms)) * issue + (-(-blocks // (n_sms * per_sm))) * latency
            plans.append((cost, ConvPlan(tile_m, tile_n, kc, grid, smem)))
    return tuple(plans)


@functools.lru_cache(maxsize=4096)
def plan_conv(n: int, T: int, c_in: int, c_out: int, k: int, dilation: int,
              dtype: torch.dtype, n_sms: int = N_SMS, act: bool = True) -> ConvPlan:
    """The launch plan for one conv: of ``conv_plans``, those that give every
    SM a block where the shapes allow it (else all), and of those the least
    costly. Smaller tiles fill more SMs and reuse each weight slice and
    window over fewer products; the plan picks per class and T."""
    plans = conv_plans(n, T, c_in, c_out, k, dilation, dtype, n_sms, act)
    if not plans:
        raise ValueError(f"snake_causal_conv: no tile fits k {k}, dilation {dilation}")
    filling = [cp for cp in plans if cp[1].blocks >= n_sms]
    return min(filling or plans, key=lambda cp: cp[0])[1]


def snake_causal_conv_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                alpha: Optional[torch.Tensor], dilation: int = 1,
                                leaky_slope: float = 0.01,
                                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernel; x: [N, T, C_in] or [T, C_in]."""
    from ...models.codec import causal_conv1d, half_snake

    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
        residual = None if residual is None else residual[None]
    h = x if alpha is None else half_snake(x, alpha, leaky_slope)
    out = causal_conv1d(h, w, b, dilation, residual)
    return out[0] if squeeze else out


_SMS = {}


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if t.device.type != "cuda" or t.dtype != dtype:
        raise ValueError(f"snake_causal_conv: {name} must be a {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"snake_causal_conv: {name} has shape {tuple(t.shape)}, "
                         f"want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"snake_causal_conv: {name} must be contiguous")


def snake_causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      alpha: Optional[torch.Tensor], dilation: int = 1,
                      leaky_slope: float = 0.01,
                      residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(optional HalfSnake) -> causal dilated conv + bias (+ residual).

    x: [N, T, C_in] or [T, C_in]; w: [k, C_in, C_out] (WIO); b: [C_out];
    alpha: [n_snake] Snake coefficients of the first n_snake channels, None =
    no activation; residual: shaped like the output. Returns [.., T, C_out].
    """
    return snake_causal_conv_planned(x, w, b, alpha, dilation, leaky_slope, residual)


def snake_causal_conv_planned(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                              alpha: Optional[torch.Tensor], dilation: int = 1,
                              leaky_slope: float = 0.01,
                              residual: Optional[torch.Tensor] = None,
                              plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """``snake_causal_conv`` launched with ``plan`` (one of ``conv_plans``;
    None: ``plan_conv``'s). A row's value does not depend on the plan."""
    global launches
    if x.device.type == "cpu":
        return snake_causal_conv_reference(x, w, b, alpha, dilation, leaky_slope, residual)
    if x.device.type != "cuda":
        raise ValueError(f"snake_causal_conv: unsupported device {x.device}")
    squeeze = x.dim() == 2
    x3 = x[None] if squeeze else x
    if x3.dim() != 3:
        raise ValueError(f"snake_causal_conv: x must be [N, T, C] or [T, C], got {tuple(x.shape)}")
    n, T, c_in = x3.shape
    if w.dim() != 3 or w.shape[1] != c_in:
        raise ValueError(f"snake_causal_conv: w {tuple(w.shape)} does not match C_in {c_in}")
    k, _, c_out = w.shape
    if dilation < 1 or (k - 1) * dilation > 512:
        raise ValueError(f"snake_causal_conv: unsupported dilation {dilation} for k {k}")
    dtype = x.dtype
    if dtype not in DTYPES:
        raise ValueError(f"snake_causal_conv: dtype {dtype} is not one the kernel takes "
                         f"(float32, bfloat16)")
    _check("x", x3, (n, T, c_in), dtype)
    _check("w", w, (k, c_in, c_out), dtype)
    _check("b", b, (c_out,), dtype)
    if alpha is not None:
        if alpha.dim() != 1 or alpha.shape[0] > c_in:
            raise ValueError(f"snake_causal_conv: alpha {tuple(alpha.shape)} vs C_in {c_in}")
        _check("alpha", alpha, tuple(alpha.shape), dtype)
    res3 = None
    if residual is not None:
        res3 = residual[None] if squeeze else residual
        _check("residual", res3, (n, T, c_out), dtype)
    out = torch.empty(n, T, c_out, dtype=dtype, device=x.device)
    if T > 0 and n > 0:
        if plan is None:
            plan = plan_conv(n, T, c_in, c_out, k, dilation, dtype, _sms(x.device),
                             act=alpha is not None)
        lib = build.load_library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"magpie_snake_conv_{DTYPES[dtype]}")(
            x3.data_ptr(), w.data_ptr(), b.data_ptr(),
            None if alpha is None else alpha.data_ptr(),
            0 if alpha is None else alpha.shape[0], int(alpha is not None),
            float(leaky_slope), None if res3 is None else res3.data_ptr(), out.data_ptr(),
            n, T, c_in, c_out, k, dilation, plan.tile_m, plan.tile_n, plan.kc, plan.smem,
            stream)
        build.check(err, "snake_causal_conv")
        launches += 1
        count_dtype(dtype_launches, dtype)
    return out[0] if squeeze else out
