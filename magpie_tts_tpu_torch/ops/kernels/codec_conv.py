"""Kernel B: fused HalfSnake -> causal dilated Conv1d (+ bias, + residual).

``snake_causal_conv`` replaces the TPU kernels
magpie_tts_tpu/ops/pallas_kernels/codec_conv.py ``snake_causal_conv`` and
``snake_causal_conv_packed`` (one unpacked kernel serves every channel
count). On CUDA tensors it launches csrc/codec_conv.cu or raises; on CPU
tensors it runs ``snake_causal_conv_reference`` (plain ``half_snake`` +
``causal_conv1d`` with the residual, from models/codec.py). Both run in
float32 or bfloat16, x's dtype; every other tensor must have it, and any
other dtype raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .build import DTYPES, count_dtype

launches = 0  # kernel launches since the last reset
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype


def declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix in DTYPES.values():
        fn = getattr(lib, f"magpie_snake_conv_{suffix}")
        fn.argtypes = [p, p, p, p, i, i, ctypes.c_float, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int


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
    if T > 0:
        lib = build.load_library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"magpie_snake_conv_{DTYPES[dtype]}")(
            x3.data_ptr(), w.data_ptr(), b.data_ptr(),
            None if alpha is None else alpha.data_ptr(),
            0 if alpha is None else alpha.shape[0], int(alpha is not None),
            float(leaky_slope), None if res3 is None else res3.data_ptr(), out.data_ptr(),
            n, T, c_in, c_out, k, dilation, stream)
        build.check(err, "snake_causal_conv")
        launches += 1
        count_dtype(dtype_launches, dtype)
    return out[0] if squeeze else out
