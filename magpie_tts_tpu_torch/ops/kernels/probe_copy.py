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
call); ``slab`` [grid_n, ...] bf16 is the streamed variant's weight (step i
reads slab i).

The CUDA grid is not ``grid_n``: ``plan_copy`` gives each TPU grid step a
thread-block cluster of CTAs by the bytes the step reads; each CTA reads a
contiguous share of its step's x and of the run of its other segments
(``cta_reads``) and rank 0 XORs the CTAs' words in rank order
(``cluster_model``, the CPU model of the kernel's checksums).
``copy(..., ctas=, stamps=)`` takes another count of CTAs a step (sweeps)
and per-CTA phase stamps (``copy_stamps``, ``read_phases``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch

from . import build, probe_gemv

VARIANTS = ("minimal", "constblk", "streamed")
MAX_CONST = 16
launches = 0  # kernel launches since the last reset
variant_launches = dict.fromkeys(VARIANTS, 0)  # the same, by variant
# csrc/probe_copy.cu: threads a CTA, the most bytes a CTA of a step reads
# under the plan, the plan's most CTAs a step, the most a launch takes, phase
# stamps a CTA.
THREADS = 256
CTA_BYTES = 32768
MAX_CTAS = 8
MAX_CLUSTER = 16
STAMPS = 5
STAMP_NAMES = ("start", "x", "read", "partials", "end")


@dataclasses.dataclass(frozen=True)
class CopyPlan:
    grid_n: int      # TPU grid steps: clusters
    ctas: int        # CTAs a step: the cluster
    step_words: int  # 32-bit words a step reads at most (the plan's input)

    @property
    def blocks(self) -> int:
        return self.grid_n * self.ctas


def plan_copy(variant: str, grid_n: int, x_words: int, const_words: Sequence[int] = (),
              slab_words: int = 0) -> CopyPlan:
    """The launch plan of a variant: each TPU grid step a cluster of the
    fewest CTAs that read at most CTA_BYTES each, at most MAX_CTAS
    (csrc/probe_copy.cu plan_ctas). A step reads its share of x and of every
    constant block (``ceil(words / grid_n)`` at most) and its slab
    (``slab_words``, one step's). A function of the variant and the sizes
    alone; the checksums' bits do not depend on it (XOR is exact)."""
    g = int(grid_n)
    if variant not in VARIANTS:
        raise ValueError(f"probe_copy: unknown variant {variant!r}, want one of {VARIANTS}")
    if (variant == "constblk") != bool(const_words) or (variant == "streamed") != bool(slab_words):
        raise ValueError(f"probe_copy: {variant} does not take these sizes (constant blocks "
                         f"{list(const_words)}, slab {slab_words})")
    step = -(-x_words // g) + sum(-(-w // g) for w in const_words) + slab_words
    ctas = min(MAX_CTAS, max(1, -(-step * 4 // CTA_BYTES)))
    return CopyPlan(grid_n=g, ctas=ctas, step_words=step)


def _step_share(n: int, grid_n: int, step: int, slab: bool):
    """(lo, hi) words of a segment that TPU grid step ``step`` reads."""
    return (step * n, (step + 1) * n) if slab else (step * n // grid_n, (step + 1) * n // grid_n)


def cta_reads(seg_words: Sequence[int], grid_n: int, step: int, ctas: int, rank: int,
              slab: bool = False):
    """The words that CTA ``rank`` of TPU grid step ``step`` reads of each
    segment (x, then the constant blocks or the slab, of ``seg_words`` words
    each; the slab's: one step's), as a list of (first, end) ranges a segment.

    x: its contiguous share of the step's 16-byte vectors, or, when the step's
    share does not start and end on a vector, of its words. The others: the
    step's shares of their aligned vectors, one after another, make a run;
    the CTA reads the run's ``rank``-th ``ctas``-th. Rank 0 also reads the
    (< 4) words of each of them before its first vector and after its last."""
    lo, hi = _step_share(seg_words[0], grid_n, step, False)
    if (lo | hi) % 4:
        m = hi - lo
        first, end = lo + rank * m // ctas, lo + (rank + 1) * m // ctas
    else:
        nv = (hi - lo) // 4
        first, end = lo + 4 * (rank * nv // ctas), lo + 4 * ((rank + 1) * nv // ctas)
    reads = [[(first, end)] if end > first else []]
    shares = []
    for j, n in enumerate(seg_words[1:], 1):
        lo, hi = _step_share(n, grid_n, step, slab and j == len(seg_words) - 1)
        up, down = -(-lo // 4) * 4, hi // 4 * 4
        shares.append((lo, hi, up, max(0, down - up) // 4))
    total = sum(nv for *_, nv in shares)
    w0, w1 = rank * total // ctas, (rank + 1) * total // ctas
    off = 0
    for lo, hi, up, nv in shares:
        a, b = max(w0, off), min(w1, off + nv)
        ranges = [(up + 4 * (a - off), up + 4 * (b - off))] if b > a else []
        if rank == 0:
            head, tail = min(up, hi), max(hi // 4 * 4, min(up, hi))
            ranges += [r for r in ((lo, head), (tail, hi)) if r[1] > r[0]]
        reads.append(ranges)
        off += nv
    return reads


def declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.magpie_probe_copy.argtypes = [p, p, p, ll, i, p]
    lib.magpie_probe_copy_const.argtypes = [p, p, p, ll, i, p, p, i, p]
    lib.magpie_probe_copy_streamed.argtypes = [p, p, p, ll, i, p, ll, p]
    lib.magpie_probe_copy_ctas.argtypes = [p, p, p, ll, i, p, p, i, p, ll, i, p, p]
    for fn in (lib.magpie_probe_copy, lib.magpie_probe_copy_const,
               lib.magpie_probe_copy_streamed, lib.magpie_probe_copy_ctas):
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


def plan_for(x: torch.Tensor, grid_n: int, consts: Sequence[torch.Tensor] = (),
             slab: Optional[torch.Tensor] = None) -> CopyPlan:
    """``plan_copy`` of a call's tensors."""
    g = int(grid_n)
    return plan_copy(_variant(consts, slab), g, x.numel() // 2, [t.numel() // 2 for t in consts],
                     0 if slab is None else slab.numel() // g // 2)


def cluster_model(x: torch.Tensor, grid_n: int, consts: Sequence[torch.Tensor] = (),
                  slab: Optional[torch.Tensor] = None, ctas: Optional[int] = None):
    """A CPU model of the kernel's checksums: each CTA's XOR of the words it
    reads (``cta_reads``), then rank 0's XOR of the CTAs' words in rank
    order; ``ctas`` defaults to the plan's. [grid_n] int32."""
    g = int(grid_n)
    segs = [words(t).cpu() for t in (x, *consts, *(() if slab is None else (slab,)))]
    sizes = [w.numel() for w in segs]
    if slab is not None:
        sizes[-1] //= g
    c = plan_for(x, g, consts, slab).ctas if ctas is None else int(ctas)
    parts = []
    for i in range(g):
        total = torch.zeros((), dtype=torch.int32)
        for r in range(c):  # rank 0 XORs its own word, then ranks 1 .. c - 1 in order
            acc = torch.zeros((), dtype=torch.int32)
            for w, ranges in zip(segs, cta_reads(sizes, g, i, c, r, slab is not None)):
                for a, b in ranges:
                    acc = acc ^ xor_reduce(w[a:b])
            total = total ^ acc
        parts.append(total)
    return torch.stack(parts).to(x.device)


def _check_bf16(name: str, t: torch.Tensor, device) -> None:
    if (t.dtype != torch.bfloat16 or t.device != device or not t.is_contiguous()
            or t.numel() % 2 or t.numel() == 0 or t.data_ptr() % 16):
        raise ValueError(f"probe_copy: {name} must be a contiguous, 16-byte aligned bf16 tensor "
                         f"of an even size on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def copy(x: torch.Tensor, grid_n: int, consts: Sequence[torch.Tensor] = (),
         slab: Optional[torch.Tensor] = None, ctas: Optional[int] = None,
         stamps: Optional[torch.Tensor] = None):
    """One launch at ``grid_n`` TPU grid steps: (x + (grid_n - 1) or +
    slab[-1, 0, 0] in bf16, the [grid_n] int32 XOR of what each step read).
    ``ctas``: CTAs a step other than the plan's (1 to MAX_CLUSTER, for
    sweeps); ``stamps``: a zeroed int64 [grid_n * ctas, STAMPS] tensor for
    the phase stamps."""
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
    plan = plan_for(x, g, consts, slab)
    c = plan.ctas if ctas is None else int(ctas)
    if not 1 <= c <= MAX_CLUSTER:
        raise ValueError(f"probe_copy: ctas {c} out of range 1..{MAX_CLUSTER}")
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != dev
                               or tuple(stamps.shape) != (g * c, STAMPS)
                               or not stamps.is_contiguous()):
        raise ValueError(f"probe_copy: stamps must be a contiguous int64 [{g * c}, {STAMPS}] "
                         f"tensor on {dev}")
    out = torch.empty_like(x)
    cs = torch.empty(g, dtype=torch.int32, device=dev)
    n = x.numel() // 2
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if ctas is not None or stamps is not None:
            ptrs = (ctypes.c_void_p * max(1, len(consts)))(*[t.data_ptr() for t in consts])
            counts = (ctypes.c_longlong * max(1, len(consts)))(*[t.numel() // 2 for t in consts])
            err = lib.magpie_probe_copy_ctas(
                x.data_ptr(), out.data_ptr(), cs.data_ptr(), n, g, ptrs, counts, len(consts),
                None if slab is None else slab.data_ptr(),
                0 if slab is None else slab.numel() // g // 2, c,
                None if stamps is None else stamps.data_ptr(), stream)
        elif slab is not None:
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


def copy_stamps(x: torch.Tensor, grid_n: int, consts: Sequence[torch.Tensor] = (),
                slab: Optional[torch.Tensor] = None, ctas: Optional[int] = None):
    """One launch on a card with phase stamps: (out, cs, int64 [CTAs,
    STAMPS] %globaltimer ns: start, its share of x stored, reads XORed, the
    other ranks' words landed in rank 0 (the other ranks: theirs pushed),
    end)."""
    if x.device.type != "cuda":
        raise ValueError(f"probe_copy: stamps need a card, got {x.device}")
    c = plan_for(x, grid_n, consts, slab).ctas if ctas is None else int(ctas)
    stamps = torch.zeros(int(grid_n) * c, STAMPS, dtype=torch.int64, device=x.device)
    out, cs = copy(x, grid_n, consts, slab, ctas=c, stamps=stamps)
    return out, cs, stamps


def read_phases(stamps: torch.Tensor) -> dict:
    """``probe_gemv.read_phases`` of the copy's stamps."""
    return probe_gemv.read_phases(stamps, STAMP_NAMES)
