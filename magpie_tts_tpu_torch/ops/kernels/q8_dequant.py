"""Kernel 10: the Q8_0 dequant of a block-stored weight (``--serve-q8``).

``dequantize`` replaces the TPU's in-kernel Q8_0 dequant tile
(tests/test_pallas_kernels.py ``test_q8_in_kernel_dequant_tile_bitexact``,
``repeat(s, 32, in-axis) * q``), as ``Q8Blocks.materialize`` runs it once per
program for every block-stored tensor. On CUDA tensors it launches
csrc/q8_dequant.cu, which writes the loader's layout directly (one block a
64 x 64 (a, b) tile for all Kk: 16-byte loads of the tile's rows, a
transpose through shared memory, 16-byte stores along a; ``tiled_model``
is a CPU model of its loops), or raises; on CPU tensors it runs
``dequantize_reference``: the f32 product, a reshape to the GGUF shape and
the loader's transform. Both are
bit-identical to the dense load of the same file, in float32 or, rounded to
nearest even, in bfloat16 (the kernel writes bf16 directly).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from . import build
from .build import DTYPES, count_dtype

launches = 0  # kernel launches since the last reset
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by output dtype
QK = 32
# csrc/q8_dequant.cu: a tile's a rows and b columns, its threads, the bytes
# of a load, the loads a thread issues together.
TILE_A, TILE_B, THREADS, LOAD_BYTES, LOADS = 64, 64, 256, 16, 4


def declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix in DTYPES.values():
        fn = getattr(lib, f"magpie_q8_dequant_{suffix}")
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int


def _dims(torch_shape, transform: str) -> Tuple[int, int, int]:
    """(A, B, Kk) of the GGUF tensor [out, in(, k)]: every transform maps
    [A, B, Kk] to [Kk, B, A], with the unit Kk dropped for linear / conv1."""
    if transform == "linear" and len(torch_shape) == 2:
        return torch_shape[0], torch_shape[1], 1
    if transform == "conv1" and len(torch_shape) == 3 and torch_shape[2] == 1:
        return torch_shape[0], torch_shape[1], 1
    if transform == "conv_ffn" and len(torch_shape) == 3:
        return tuple(torch_shape)
    raise ValueError(f"q8 dequant: transform {transform!r} does not fit shape {torch_shape}")


def out_shape(lead, torch_shape, transform: str) -> Tuple[int, ...]:
    A, B, Kk = _dims(torch_shape, transform)
    return (*lead, *((Kk,) if transform == "conv_ffn" else ()), B, A)


def dequantize_reference(q: torch.Tensor, s: torch.Tensor, torch_shape,
                         transform: str, dtype=torch.float32) -> torch.Tensor:
    """Plain version: ``s * q`` in f32, the GGUF shape, the loader's layout,
    then ``dtype``."""
    _dims(torch_shape, transform)
    w = (s.float() * q.float()).reshape(*q.shape[:-2], *torch_shape)
    if transform == "linear":
        w = w.transpose(-1, -2)
    elif transform == "conv1":
        w = w[..., 0].transpose(-1, -2)
    else:
        w = w.transpose(-1, -3)
    return w.contiguous().to(dtype)


def tiled_model(q: torch.Tensor, s: torch.Tensor, torch_shape, transform: str,
                dtype=torch.float32):
    """A CPU model of the kernel's tiling, for the tests: every block
    (b tile, a tile, lead slice) reads its rows' source runs (16 bytes where
    every row is whole 16-byte runs, else bytes) as the kernel's loop deals
    them to its threads, dequantizes them into its [a][b * Kk + kk] tile and
    writes the Kk output runs along a (16 bytes of ``dtype``, else one value).
    Returns (out, the times each source byte was read, the times each output
    element was written); ``out`` holds NaN where nothing was written."""
    A, B, Kk = _dims(torch_shape, transform)
    G = math.prod(q.shape[:-2])
    qf = q.reshape(G, A * B * Kk).numpy()
    sf = s.reshape(G, -1).numpy()
    out = np.full((G, Kk * B * A), np.nan, dtype=np.float32)
    reads = np.zeros(A * B * Kk, dtype=np.int32)
    writes = np.zeros(Kk * B * A, dtype=np.int32)
    vb = LOAD_BYTES if (B * Kk) % LOAD_BYTES == 0 else 1
    elt = torch.tensor([], dtype=dtype).element_size()
    ve = 16 // elt if A % (16 // elt) == 0 else 1
    tid = np.arange(THREADS)
    for a0 in range(0, A, TILE_A):
        for b0 in range(0, B, TILE_B):
            na, nb = min(TILE_A, A - a0), min(TILE_B, B - b0)
            tile = np.full((G, TILE_A, TILE_B * Kk), np.nan, dtype=np.float32)
            per_row = TILE_B * Kk // vb
            total = TILE_A * per_row
            step = (LOADS if vb == LOAD_BYTES else 1) * THREADS
            for v0 in range(0, total, step):      # each thread's loads, in flight together
                for u in range(step // THREADS):
                    v = v0 + u * THREADS + tid
                    r, j0 = v // per_row, (v % per_row) * vb
                    ok = (v < total) & (r < na) & (j0 < nb * Kk)
                    r, j0 = r[ok], j0[ok]
                    i0 = ((a0 + r) * B + b0) * Kk + j0
                    scale = sf[:, i0 // QK]           # one scale a load
                    for e in range(vb):
                        np.add.at(reads, i0 + e, 1)
                        tile[:, r, j0 + e] = scale * qf[:, i0 + e].astype(np.float32)
            runs = TILE_A // ve
            for u0 in range(0, Kk * TILE_B * runs, THREADS):
                u = u0 + tid
                run, rest = u % runs, u // runs
                bb, kk = rest % TILE_B, rest // TILE_B
                a = run * ve
                ok = (u < Kk * TILE_B * runs) & (bb < nb) & (a < na)
                a, bb, kk = a[ok], bb[ok], kk[ok]
                for e in range(ve):
                    o = (kk * B + b0 + bb) * A + a0 + a + e
                    np.add.at(writes, o, 1)
                    out[:, o] = tile[:, a + e, bb * Kk + kk]
    lead = tuple(q.shape[:-2])
    res = torch.from_numpy(out).reshape(out_shape(lead, torch_shape, transform))
    return res.to(dtype), reads, writes


def dequantize(q: torch.Tensor, s: torch.Tensor, torch_shape, transform: str,
               dtype=torch.float32) -> torch.Tensor:
    """q [*lead, n_blocks, 32] int8 and s [*lead, n_blocks, 1] f32 (one
    f16-valued scale per block, GGUF order) -> the ``dtype`` (float32 or
    bfloat16) tensor of the loader's ``transform`` of ``torch_shape``, for
    every lead index."""
    global launches
    if q.device.type == "cpu":
        return dequantize_reference(q, s, torch_shape, transform, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"q8 dequant: unsupported device {q.device}")
    if dtype not in DTYPES:
        raise ValueError(f"q8 dequant: dtype {dtype} is not one the kernel writes "
                         f"(float32, bfloat16)")
    A, B, Kk = _dims(torch_shape, transform)
    lead = tuple(q.shape[:-2])
    n_blocks = A * B * Kk // QK
    if A * B * Kk % QK or tuple(q.shape) != (*lead, n_blocks, QK):
        raise ValueError(f"q8 dequant: q has shape {tuple(q.shape)}, want {(*lead, n_blocks, QK)}")
    if q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError(f"q8 dequant: q must be a contiguous int8 tensor, got {q.dtype}")
    if (s.device != q.device or s.dtype != torch.float32 or not s.is_contiguous()
            or tuple(s.shape) != (*lead, n_blocks, 1)):
        raise ValueError(f"q8 dequant: s must be a contiguous float32 {(*lead, n_blocks, 1)} "
                         f"tensor on {q.device}, got {s.dtype} {tuple(s.shape)} on {s.device}")
    out = torch.empty(out_shape(lead, torch_shape, transform), dtype=dtype, device=q.device)
    lib = build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = getattr(lib, f"magpie_q8_dequant_{DTYPES[dtype]}")(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), math.prod(lead), A, B, Kk, stream)
    build.check(err, "q8_dequant")
    launches += 1
    count_dtype(dtype_launches, dtype)
    return out
