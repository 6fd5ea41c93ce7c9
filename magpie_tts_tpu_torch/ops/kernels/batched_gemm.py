"""The batched split-K GEMM of kernels C, 7 and 8, alone.

Every matrix product of the batched frame sequence (the decoder's qkv,
sa_out, xa_q, xa_out, ff_proj, ff_out and the LT's six) runs
csrc/frame_step_batched.cu ``gemm_mma_kernel`` on the tensor cores: block
(column tile, split) with one n8 tile a warp, the weights through a cp.async
ring (int8 / Q8_0 stages dequantized in shared memory), X rows rounded to T
as m16 tiles of slots, bf16 on ``mma.m16n8k16``, float32 as split TF32 on
``mma.m16n8k8``, each mma summed from zero and carried by float adds. The
partials ``part[(s * B + b) * N + n]`` are reduced by the next kernel.

``plan_gemm`` is the launch plan (rows of K a block, the split count), a
function of K, N and the partial cap alone; the frame wrappers pass the plan
of every product of the sequence (``plan_table``) and the kernel refuses a
product it has no plan for. ``batched_gemm`` launches one product alone (the
``magpie_batched_gemm_f32`` / ``_bf16`` entry points), for the card tests and
the GEMM family's timing; on CPU tensors it runs ``batched_gemm_reference``.
``split_tf32_products`` is a CPU model of the float32 path's products.
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

ENTRY = "magpie_batched_gemm"
MODES = ("dense", "int8", "q8")
launches = 0  # kernel launches since the last reset
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype

# csrc/frame_step_batched.cu: threads (8 warps), columns a block (one n8 tile
# a warp), weight rows a ring stage (one Q8_0 block), ring stages, the most
# rows of K a block, the blocks a product aims at (2 per SM on 132 SMs), the
# most partial rows (the workspace's), the most plans a frame passes, an H100
# block's shared memory.
THREADS, TILE_N, KT, STAGES = 256, 64, 32, 4
KCHUNK_MAX = 256
TARGET_BLOCKS = 264
PART_CAP = 32
MAX_PLANS = 16
MAX_SMEM = 232448
ELT = {torch.float32: 4, torch.bfloat16: 2}


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    kchunk: int   # rows of K a block
    splits: int   # partial rows: ceil(K / kchunk)
    tiles: int    # column tiles: ceil(N / TILE_N)

    @property
    def blocks(self) -> int:
        return self.splits * self.tiles

    def bounds(self, K: int):
        """[(first row, end row)] of each split of K."""
        return [(k, min(K, k + self.kchunk)) for k in range(0, K, self.kchunk)]


@functools.lru_cache(maxsize=None)
def plan_gemm(K: int, N: int, part_cap: int = PART_CAP) -> GemmPlan:
    """The split of K for an [., K] @ [K, N] product: enough splits that the
    column tiles times the splits reach TARGET_BLOCKS, at most ``part_cap``
    and one a ring stage, each split a whole number of stages (KT rows) and
    at most KCHUNK_MAX rows (the X tile's shared memory). A function of K, N
    and the cap alone: never of B, the dtype or the weight stream."""
    if K < 1 or N < 1 or part_cap < 1:
        raise ValueError(f"gemm plan: K {K}, N {N}, cap {part_cap}")
    tiles = -(-N // TILE_N)
    splits = max(1, min(-(-TARGET_BLOCKS // tiles), part_cap, -(-K // KT)))
    kchunk = -(-(-(-K // splits)) // KT) * KT
    kchunk = min(kchunk, KCHUNK_MAX)
    splits = -(-K // kchunk)
    if splits > part_cap:
        raise ValueError(f"gemm plan: K {K} needs {splits} splits of at most {KCHUNK_MAX} rows, "
                         f"over the cap {part_cap}")
    return GemmPlan(kchunk=kchunk, splits=splits, tiles=tiles)


def m_tiles(B: int) -> int:
    return -(-B // 16)


def window_stride(cols: int, dtype: torch.dtype) -> int:
    """The X tile's row stride (conv_mma.cuh window_stride)."""
    return -(-cols // 16) * 16 + (4 if dtype == torch.float32 else 8)


def gemm_smem(dtype: torch.dtype, mode: str, B: int, kchunk: int) -> int:
    """Dynamic shared memory of one block (csrc gemm_smem): the X tile of
    16 * m_tiles(B) rows, then the dense ring, or the raw int8 ring with its
    Q8_0 scale rows and one dequantized stage."""
    elt, sw = ELT[dtype], TILE_N + 8
    x = 16 * m_tiles(B) * window_stride(kchunk, dtype) * elt
    if mode == "dense":
        return x + STAGES * KT * sw * elt
    return x + STAGES * KT * TILE_N + STAGES * TILE_N * 4 + KT * sw * elt


def frame_products(config) -> dict:
    """{name: (K, N)} of the batched frame sequence's matrix products."""
    c = config
    D, F, X, LT, LF, V = c.d_model, c.d_ffn, c.d_xa, c.lt_dim, c.lt_ffn_dim, c.vocab_per_cb
    return {"qkv": (D, 3 * D), "sa_out": (D, D), "xa_q": (D, X), "xa_out": (X, D),
            "ff_proj": (D, F), "ff_out": (F, D), "lt_in": (D, LT), "lt_qkv": (LT, 3 * LT),
            "lt_sa_out": (LT, LT), "lt_ff_proj": (LT, LF), "lt_ff_out": (LF, LT),
            "lt_out": (LT, V)}


def plan_table(config):
    """The GemmPlan array of a frame's arguments: (K, N, kchunk) of each
    distinct product, and its length."""
    shapes = sorted(set(frame_products(config).values()))
    if len(shapes) > MAX_PLANS:
        raise ValueError(f"{len(shapes)} product shapes, the arguments hold {MAX_PLANS}")
    table = (GemmPlanC * MAX_PLANS)()
    for i, (K, N) in enumerate(shapes):
        table[i] = GemmPlanC(K, N, plan_gemm(K, N).kchunk)
    return table, len(shapes)


class GemmPlanC(ctypes.Structure):
    """Mirror of ``struct GemmPlan`` in csrc/frame_step_batched.cu."""
    _fields_ = [("K", ctypes.c_int), ("N", ctypes.c_int), ("kchunk", ctypes.c_int)]


class GemmArgs(ctypes.Structure):
    """Mirror of ``struct GemmArgs`` in csrc/frame_step_batched.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in "x w q s part".split()] +
                [(n, ctypes.c_int) for n in "x_t batch k n kchunk mode".split()])


def declare(lib: ctypes.CDLL) -> None:
    for suffix in DTYPES.values():
        fn = getattr(lib, f"{ENTRY}_{suffix}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def check_widths(who: str, config, dtype: torch.dtype, stream_mode: int) -> None:
    """What the batched GEMM takes: every product's N a whole number of
    16-byte copies (8 columns in bf16, 4 in float32, 16 for the int8 values
    of a stream) and a multiple of 8, K a multiple of 4, and a plan within
    the partial cap."""
    streamed = {"qkv", "sa_out", "ff_proj", "ff_out"}
    for name, (K, N) in frame_products(config).items():
        elt = 1 if stream_mode and name in streamed else ELT[dtype]
        if (N * elt) % 16 or N % 8 or K % 4:
            raise ValueError(f"{who}: product {name} [{K}, {N}] is not one the batched GEMM "
                             f"takes (N * {elt} bytes % 16, N % 8, K % 4)")
        plan_gemm(K, N)


def weight_values(w: Optional[torch.Tensor], q: Optional[torch.Tensor],
                  s: Optional[torch.Tensor], mode: str, dtype: torch.dtype) -> torch.Tensor:
    """The [K, N] weight values the products use, float32: dense T values;
    int8 values (their column scale waits for the reducer); or each int8
    value times its Q8_0 block scale, rounded to T (load_w4)."""
    if mode == "dense":
        return w.float()
    qf = q.float()
    if mode == "int8":
        return qf
    return (s.repeat_interleave(32, dim=0) * qf).to(dtype).float()


def batched_gemm_reference(x: torch.Tensor, K: int, N: int, dtype: torch.dtype,
                           w=None, q=None, s=None, mode: str = "dense") -> torch.Tensor:
    """Plain partials [S, B, N] float32: split s is rnd(x[:, rows of s]) @
    W[rows of s] summed in float32 (``matmul_f32``), the splits of
    ``plan_gemm(K, N)``."""
    wv = weight_values(w, q, s, mode, dtype)
    xr = x.float().to(dtype).float()
    plan = plan_gemm(K, N)
    return torch.stack([matmul_f32(xr[:, k0:k1], wv[k0:k1]) for k0, k1 in plan.bounds(K)])


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero (cvt.rna.tf32.f32)."""
    bits = v.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def split_tf32(v: torch.Tensor):
    """v = hi + lo, both TF32 (conv_mma.cuh split_tf32)."""
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def split_tf32_products(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A CPU model of the float32 kernel's products x [B, K] @ w [K, N]:
    each operand split into TF32 hi + lo, the product lo*hi + hi*lo + hi*hi
    (the lo*lo term dropped), summed in float64 (the tensor cores' sums are
    not modelled). What it shows is the error of the split itself."""
    xh, xl = split_tf32(x.float())
    wh, wl = split_tf32(w.float())
    d = lambda a, b: a.double() @ b.double()
    return d(xl, wh) + d(xh, wl) + d(xh, wh)


def batched_gemm(x: torch.Tensor, K: int, N: int, w: Optional[torch.Tensor] = None,
                 q: Optional[torch.Tensor] = None, s: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One product of the batched frame sequence: x [B, K] (float32 rows, or
    rows in the compute dtype) @ a [K, N] weight: dense ``w`` in the compute
    dtype, or int8 ``q`` with float32 column scales ``s`` [N] (int8 stream:
    not applied here, as in the frame, where the reducer applies them) or
    Q8_0 block scales ``s`` [K / 32, N]. Returns the partials [S, B, N]
    float32 of ``plan_gemm(K, N)``."""
    global launches
    mode = "dense" if w is not None else ("int8" if s is not None and s.dim() == 1 else "q8")
    dtype = dtype or (w.dtype if w is not None else torch.float32)
    if x.device.type == "cpu":
        return batched_gemm_reference(x, K, N, dtype, w, q, s, mode)
    if dtype not in DTYPES:
        raise ValueError(f"{ENTRY}: compute dtype {dtype} is not one the kernels take")
    B = x.shape[0]
    if not 1 <= B <= 64 or tuple(x.shape) != (B, K) or x.dtype not in (torch.float32, dtype):
        raise ValueError(f"{ENTRY}: x must be [B <= 64, {K}] float32 or {dtype} (a launch's "
                         f"slots; the frame wrappers run more as slot groups)")
    weight = w if mode == "dense" else q
    for t in (x, weight, s):
        if t is not None and (t.device.type != "cuda" or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"{ENTRY}: operands must be contiguous 16-byte aligned CUDA tensors")
    plan = plan_gemm(K, N)
    part = torch.empty(plan.splits, B, N, dtype=torch.float32, device=x.device)
    x_t = int(x.dtype == dtype and dtype != torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()
    args = GemmArgs(x=x.data_ptr(), w=ptr(w), q=ptr(q), s=ptr(s), part=part.data_ptr(),
                    x_t=x_t, batch=B, k=K, n=N, kchunk=plan.kchunk, mode=MODES.index(mode))
    lib = build.load_library()
    entry = f"{ENTRY}_{DTYPES[dtype]}"
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(ctypes.addressof(args),
                                  torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, entry)
    launches += 1
    count_dtype(dtype_launches, dtype)
    return part
