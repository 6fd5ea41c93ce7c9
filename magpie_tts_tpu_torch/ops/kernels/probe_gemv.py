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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

FORMATS = ("native_int4", "packed_int8", "bf16")
M = 8  # rows of x, as the probe has them
launches = 0  # kernel launches since the last reset
format_launches = dict.fromkeys(FORMATS, 0)  # the same, by weight format


def declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fmt in FORMATS:
        fn = getattr(lib, f"magpie_probe_gemv_{fmt}")
        fn.argtypes = [p, p, p, i, i, p]
        fn.restype = ctypes.c_int


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


def _dims(w: torch.Tensor, fmt: str):
    """(K, N, storage dtype) of a stored weight."""
    if fmt == "native_int4":
        return w.shape[0], 2 * w.shape[1], torch.uint8
    if fmt == "packed_int8":
        return 2 * w.shape[0], w.shape[1], torch.int8
    if fmt == "bf16":
        return w.shape[0], w.shape[1], torch.bfloat16
    raise ValueError(f"probe_gemv: unknown format {fmt!r}, want one of {FORMATS}")


def gemv(x: torch.Tensor, w: torch.Tensor, fmt: str) -> torch.Tensor:
    """x [8, K] bf16, w in ``fmt``'s storage -> x @ W [8, N] float32."""
    global launches
    if x.device.type == "cpu":
        return gemv_reference(x, w, fmt)
    if x.device.type != "cuda":
        raise ValueError(f"probe_gemv: unsupported device {x.device}")
    if w.dim() != 2:
        raise ValueError(f"probe_gemv: w must be 2-D, got shape {tuple(w.shape)}")
    K, N, wdt = _dims(w, fmt)
    if x.dtype != torch.bfloat16 or tuple(x.shape) != (M, K) or not x.is_contiguous():
        raise ValueError(f"probe_gemv: x must be a contiguous bf16 [{M}, {K}] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if (w.dtype != wdt or w.device != x.device or not w.is_contiguous()
            or w.data_ptr() % 16):
        raise ValueError(f"probe_gemv: a {fmt} weight must be a contiguous, 16-byte aligned "
                         f"{wdt} tensor on {x.device}, got {w.dtype} on {w.device}")
    if not (256 <= K <= 1024 and K % 256 == 0 and N >= 64 and N % 64 == 0):
        raise ValueError(f"probe_gemv: K {K} must be a multiple of 256 in [256, 1024] and N "
                         f"{N} a multiple of 64")
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    lib = build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = getattr(lib, f"magpie_probe_gemv_{fmt}")(x.data_ptr(), w.data_ptr(),
                                                       out.data_ptr(), K, N, stream)
    build.check(err, f"probe_gemv[{fmt}]")
    launches += 1
    format_launches[fmt] += 1
    return out
