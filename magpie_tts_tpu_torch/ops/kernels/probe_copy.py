"""Kernels 15-17: the launch-cost copy probes (scripts/opt_slope_probe.py
``probe_minimal`` / ``probe_constblk``, scripts/opt_launch_probe.py
``minimal_probe``).

``copy(x, grid_n, consts=(), slab=None)`` is one launch of
csrc/probe_copy.cu at ``grid_n`` blocks on CUDA tensors (or raises), of
``copy_reference`` on CPU tensors. It returns ``(out, cs)``:

- ``out = x + (grid_n - 1)`` in bf16 (with ``slab``, ``x + slab[-1, 0, 0]``),
  what the TPU kernel's last grid step writes; chained launches round to bf16
  every time, as the TPU chain does;
- ``cs`` [grid_n] int32: block i's XOR of the 32-bit words it read (its
  share of x and of every constant block in ``consts``, words
  ``[i * n // grid_n, (i + 1) * n // grid_n)``, and slab i), so that no read
  can be dropped.

``consts`` are the const-block variant's weights (bf16, read in full on every
call); ``slab`` [grid_n, ...] bf16 is the streamed variant's weight (block i
reads slab i).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import build

VARIANTS = ("minimal", "constblk", "streamed")
MAX_CONST = 16
launches = 0  # kernel launches since the last reset
variant_launches = dict.fromkeys(VARIANTS, 0)  # the same, by variant


def declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.magpie_probe_copy.argtypes = [p, p, p, ll, i, p]
    lib.magpie_probe_copy_const.argtypes = [p, p, p, ll, i, p, p, i, p]
    lib.magpie_probe_copy_streamed.argtypes = [p, p, p, ll, i, p, ll, p]
    for fn in (lib.magpie_probe_copy, lib.magpie_probe_copy_const,
               lib.magpie_probe_copy_streamed):
        fn.restype = ctypes.c_int


def words(t: torch.Tensor) -> torch.Tensor:
    """A contiguous bf16 tensor of an even size as its flat int32 words."""
    return t.reshape(-1).view(torch.int32)


def xor_reduce(w: torch.Tensor) -> torch.Tensor:
    """XOR of a 1-D int32 tensor as a 0-d int32 tensor (no host read)."""
    while w.numel() > 1:
        if w.numel() % 2:
            w = torch.cat((w, w.new_zeros(1)))
        w = w[0::2] ^ w[1::2]
    return w.reshape(()) if w.numel() else torch.zeros((), dtype=torch.int32, device=w.device)


def _variant(consts, slab) -> str:
    return "streamed" if slab is not None else "constblk" if consts else "minimal"


def copy_reference(x: torch.Tensor, grid_n: int, consts: Sequence[torch.Tensor] = (),
                   slab: Optional[torch.Tensor] = None):
    """Plain version: (x + add rounded to bf16, the per-block XOR partials)."""
    g = int(grid_n)
    add = slab.reshape(g, -1)[g - 1, 0].float() if slab is not None else float(g - 1)
    out = (x.float() + add).to(torch.bfloat16)
    parts = []
    for i in range(g):
        acc = torch.zeros((), dtype=torch.int32, device=x.device)
        for t in (x, *consts):
            w = words(t)
            n = w.numel()
            acc = acc ^ xor_reduce(w[i * n // g:(i + 1) * n // g])
        if slab is not None:
            acc = acc ^ xor_reduce(words(slab[i]))
        parts.append(acc)
    return out, torch.stack(parts)


def _check_bf16(name: str, t: torch.Tensor, device) -> None:
    if (t.dtype != torch.bfloat16 or t.device != device or not t.is_contiguous()
            or t.numel() % 2 or t.numel() == 0 or t.data_ptr() % 16):
        raise ValueError(f"probe_copy: {name} must be a contiguous, 16-byte aligned bf16 tensor "
                         f"of an even size on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def copy(x: torch.Tensor, grid_n: int, consts: Sequence[torch.Tensor] = (),
         slab: Optional[torch.Tensor] = None):
    """One launch at ``grid_n`` blocks: (x + (grid_n - 1) or + slab[-1, 0, 0]
    in bf16, the [grid_n] int32 XOR partials of what each block read)."""
    global launches
    if x.device.type == "cpu":
        return copy_reference(x, grid_n, consts, slab)
    if x.device.type != "cuda":
        raise ValueError(f"probe_copy: unsupported device {x.device}")
    g = int(grid_n)
    if not 1 <= g <= 65535:
        raise ValueError(f"probe_copy: grid_n {g} out of range 1..65535")
    if consts and slab is not None:
        raise ValueError("probe_copy: the const-block and streamed variants are separate")
    dev = x.device
    _check_bf16("x", x, dev)
    for j, t in enumerate(consts):
        _check_bf16(f"consts[{j}]", t, dev)
    if len(consts) > MAX_CONST:
        raise ValueError(f"probe_copy: at most {MAX_CONST} constant blocks, got {len(consts)}")
    if slab is not None:
        _check_bf16("slab", slab, dev)
        if slab.shape[0] != g or (slab.numel() // g) % 2:
            raise ValueError(f"probe_copy: slab {tuple(slab.shape)} must have grid_n = {g} "
                             f"slabs of an even size")
    out = torch.empty_like(x)
    cs = torch.empty(g, dtype=torch.int32, device=dev)
    n = x.numel() // 2
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if slab is not None:
            err = lib.magpie_probe_copy_streamed(x.data_ptr(), out.data_ptr(), cs.data_ptr(), n,
                                                 g, slab.data_ptr(), slab.numel() // g // 2,
                                                 stream)
        elif consts:
            ptrs = (ctypes.c_void_p * len(consts))(*[t.data_ptr() for t in consts])
            counts = (ctypes.c_longlong * len(consts))(*[t.numel() // 2 for t in consts])
            err = lib.magpie_probe_copy_const(x.data_ptr(), out.data_ptr(), cs.data_ptr(), n, g,
                                              ptrs, counts, len(consts), stream)
        else:
            err = lib.magpie_probe_copy(x.data_ptr(), out.data_ptr(), cs.data_ptr(), n, g,
                                        stream)
    variant = _variant(consts, slab)
    build.check(err, f"probe_copy[{variant}]")
    launches += 1
    variant_launches[variant] += 1
    return out, cs
