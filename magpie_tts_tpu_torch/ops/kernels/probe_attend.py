"""Kernels 14 and 18: the attend probes (scripts/opt_int8_attend_probe.py,
scripts/opt_attend_probe.py).

``attend(q, k, v, sk, sv, rows, iters, mode)`` replaces the TPU probes'
``build(mode, rows, iters)``: per slot, one bf16 query row attends with
12 heads of 64 columns over the first ``rows`` rows of its K / V cache, and
the result is summed over ``iters`` repeats in float32. On CUDA tensors it
zeroes the output and launches csrc/probe_attend.cu ``iters`` times, each
launch adding one attend (``attend_accumulate``); on CPU tensors it runs
``attend_reference``.

Modes (``MODES``): ``bf16`` (kernel 14's baseline, which is kernel 18's
``tr``) and ``tr`` on bf16 K / V, a block per (head, slot); ``cur``, the same
function with a block per slot scoring all heads from whole rows; ``i8mixed``
(int8 K / V, s_k folded into the scores, s_v into the probabilities) and
``i8cast`` (int8 K / V dequantized to bf16 before either dot), a block per
(head, slot). The rounding points are the Pallas kernels' (see the source).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MODES = ("bf16", "tr", "cur", "i8mixed", "i8cast")
INT8_MODES = ("i8mixed", "i8cast")
DH = 64  # columns per head
INV = 1.0 / 8.0  # 1 / sqrt(64), exact in float32
launches = 0  # kernel launches since the last reset
mode_launches = dict.fromkeys(MODES, 0)  # the same, by mode
_ENTRY = {"bf16": "tr", "tr": "tr", "cur": "cur", "i8mixed": "i8mixed", "i8cast": "i8cast"}


def declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("tr", "cur"):
        fn = getattr(lib, f"magpie_probe_attend_{name}")
        fn.argtypes = [p, p, p, p, i, i, i, i, f, p]
        fn.restype = ctypes.c_int
    for name in INT8_MODES:
        fn = getattr(lib, f"magpie_probe_attend_{name}")
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]
        fn.restype = ctypes.c_int


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"probe_attend: unknown mode {mode!r}, want one of {MODES}")


def attend_once_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sk, sv,
                          rows: int, mode: str) -> torch.Tensor:
    """Plain version of one attend: q [G, D] bf16; k, v [G, S, D] (int8 for
    the i8 modes, bf16 else); sk, sv [G, S] float32 -> [G, D] float32."""
    _check_mode(mode)
    G, S, D = k.shape
    H = D // DH
    qh = q.float().view(G, H, DH)
    kb, vb = k[:, :rows].float(), v[:, :rows].float()
    if mode == "i8cast":
        kb = (kb * sk[:, :rows, None]).to(torch.bfloat16).float()
        vb = (vb * sv[:, :rows, None]).to(torch.bfloat16).float()
    scores = torch.einsum("ghd,grhd->ghr", qh, kb.view(G, rows, H, DH))
    if mode == "i8mixed":
        scores = scores * (sk[:, None, :rows] * INV)
    else:
        scores = scores * INV
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = p / p.sum(dim=-1, keepdim=True)
    if mode == "i8mixed":
        probs = probs * sv[:, None, :rows]
    pw = probs.to(torch.bfloat16).float()
    return torch.einsum("ghr,grhd->ghd", pw, vb.view(G, rows, H, DH)).reshape(G, D)


def attend_reference(q, k, v, sk, sv, rows: int, iters: int, mode: str) -> torch.Tensor:
    """Plain version: ``iters`` attends added in order in float32."""
    one = attend_once_reference(q, k, v, sk, sv, rows, mode)
    out = torch.zeros_like(one)
    for _ in range(iters):
        out = out + one
    return out


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"probe_attend: {name} must be a contiguous, 16-byte aligned {dtype} "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def attend_accumulate(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sk, sv, rows: int, mode: str) -> torch.Tensor:
    """One launch: out [G, D] float32 += the attend of q over rows [0, rows)
    (in place; on CPU tensors, the plain version's)."""
    global launches
    _check_mode(mode)
    if q.device.type == "cpu":
        return out.add_(attend_once_reference(q, k, v, sk, sv, rows, mode))
    if q.device.type != "cuda":
        raise ValueError(f"probe_attend: unsupported device {q.device}")
    G, S, D = k.shape
    kv = torch.int8 if mode in INT8_MODES else torch.bfloat16
    dev = q.device
    _check("q", q, (G, D), torch.bfloat16, dev)
    _check("k", k, (G, S, D), kv, dev)
    _check("v", v, (G, S, D), kv, dev)
    _check("out", out, (G, D), torch.float32, dev)
    if mode in INT8_MODES:
        _check("sk", sk, (G, S), torch.float32, dev)
        _check("sv", sv, (G, S), torch.float32, dev)
    if D % DH or not 1 <= int(rows) <= S or (mode == "cur" and D % 256):
        raise ValueError(f"probe_attend: D {D} must be a multiple of {DH} (cur: 256) and rows "
                         f"{rows} in [1, {S}]")
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = getattr(lib, f"magpie_probe_attend_{_ENTRY[mode]}")
    scales = (sk.data_ptr(), sv.data_ptr()) if mode in INT8_MODES else ()
    with torch.cuda.device(dev):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, out.data_ptr(), G, S, D,
                    int(rows), INV, stream)
    build.check(err, f"probe_attend[{mode}]")
    launches += 1
    mode_launches[mode] += 1
    return out


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sk, sv, rows: int, iters: int,
           mode: str) -> torch.Tensor:
    """The sum over ``iters`` of the attend of q [G, D] bf16 over rows
    [0, rows) of k, v [G, S, D] (bf16; int8 with per-row scales sk, sv
    [G, S] float32 in the i8 modes) -> [G, D] float32."""
    if q.device.type == "cpu":
        return attend_reference(q, k, v, sk, sv, rows, iters, mode)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for _ in range(iters):
        attend_accumulate(out, q, k, v, sk, sv, rows, mode)
    return out
