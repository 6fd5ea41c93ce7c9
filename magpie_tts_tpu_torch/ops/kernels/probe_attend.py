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
``tr``) and ``tr`` on bf16 K / V, reading a head's 64-wide slice of each row;
``cur``, the same function reading whole rows and scoring all heads of a row
at once; ``i8mixed`` (int8 K / V, s_k folded into the scores, s_v into the
probabilities) and ``i8cast`` (int8 K / V dequantized to bf16 before either
dot), head slices. The rounding points are the Pallas kernels' (see the
source).

Every mode is one launch whose rows are split across the card, in chunks
from ``plan_attend`` (a function of the mode and the head width, never of
the slot count). The head-slice modes (tr, bf16, i8mixed, i8cast) give each
(slot, head) a cluster of 8 CTAs that deal the chunks round robin and meet
in distributed shared memory; ``cur`` gives each (slot, chunk) a block of one
cooperative launch, meeting at two grid barriers through a workspace.
``chunked_model`` is a CPU model of that arithmetic (each block's max and
sum, merged in a fixed order; probabilities rounded after normalising; P V
partials summed in order), held against ``attend_once_reference`` and the
Pallas probes in the CPU tests and against the kernel on the card.
``attend_stamps`` runs one launch with phase stamps (``read_phases``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build

MODES = ("bf16", "tr", "cur", "i8mixed", "i8cast")
INT8_MODES = ("i8mixed", "i8cast")
DH = 64  # columns per head
INV = 1.0 / 8.0  # 1 / sqrt(64), exact in float32
launches = 0  # kernel launches since the last reset
mode_launches = dict.fromkeys(MODES, 0)  # the same, by mode
_ENTRY = {"bf16": "tr", "tr": "tr", "cur": "cur", "i8mixed": "i8mixed", "i8cast": "i8cast"}
# csrc/probe_attend.cu: K bytes of a head-slice chunk (16 bf16, 32 int8 rows
# of a 64-wide head), CTAs of a head-slice cluster, rows of a cur chunk, the
# widest cur row, phase stamps a block.
SLICE_CHUNK_BYTES = 2048
CLUSTER = 8
SLICE_WARPS = 4
CUR_CHUNK = 16
CUR_MAX_D = 1024
STAMPS = 7
STAMP_NAMES = ("start", "k_first", "scored", "partials", "past_barrier", "pv_partial", "end")


@dataclasses.dataclass(frozen=True)
class AttendPlan:
    chunk: int     # rows a chunk
    cluster: int   # CTAs of a (slot, head) dealing the chunks round robin; 0: a block a
                   # (slot, chunk), all heads (cur)

    def chunks(self, rows: int) -> int:
        return -(-int(rows) // self.chunk)

    def bounds(self, rows: int):
        """[(first row, end row)] of each chunk of ``rows`` rows."""
        return [(r, min(rows, r + self.chunk)) for r in range(0, rows, self.chunk)]

    def groups(self, rows: int):
        """The rows each block of a (slot, head) holds, in the order their P V
        partials are summed: a CTA's chunks (rank j: chunks j, j + 8, ...),
        or one chunk a block in cur. Lists of row indices."""
        b = self.bounds(rows)
        held = [b[j::self.cluster] for j in range(self.cluster)] if self.cluster else \
            [[r] for r in b]
        return [[r for r0, r1 in grp for r in range(r0, r1)] for grp in held]

    def partials(self, rows: int):
        """The rows of each (max, sum) partial of a (slot, head), in merge
        order: warp w of CTA j (its local rows w * 32 + lane + 128 k) at 4 j +
        w, or one chunk a block in cur."""
        if not self.cluster:
            return self.groups(rows)
        return [[r for i, r in enumerate(grp) if (i // 32) % SLICE_WARPS == w]
                for grp in self.groups(rows) for w in range(SLICE_WARPS)]

    def blocks(self, G: int, H: int, rows: int) -> int:
        """Blocks of one launch: G x H clusters, or G x chunks in cur."""
        return G * H * self.cluster if self.cluster else G * self.chunks(rows)


@functools.lru_cache(maxsize=None)
def plan_attend(mode: str, d_head: int = DH) -> AttendPlan:
    """The chunks of a mode: SLICE_CHUNK_BYTES of K a head-slice chunk (16
    rows in bf16, 32 in int8 at d_head 64) over a cluster of CLUSTER CTAs,
    CUR_CHUNK whole rows a cur block. A function of the mode and d_head
    alone: never of G or rows, so a slot's blocks, and its bits, are the
    same whatever the other slots are."""
    _check_mode(mode)
    if mode == "cur":
        return AttendPlan(chunk=CUR_CHUNK, cluster=0)
    elt = 1 if mode in INT8_MODES else 2
    return AttendPlan(chunk=SLICE_CHUNK_BYTES // (d_head * elt), cluster=CLUSTER)


def workspace_words(G: int, D: int, rows: int) -> int:
    """float32 words of one cur launch's workspace (csrc/probe_attend.cu
    Work): scores [G, H, rows], chunk partials (max, sum) [G, H, nc, 2] and
    P V partials [G, nc, D]."""
    H, nc = D // DH, plan_attend("cur").chunks(rows)
    return G * (H * rows + H * nc * 2 + nc * D)


def combine(plan: AttendPlan, parts: list) -> torch.Tensor:
    """The sum of a (slot, head)'s P V partials in the kernel's order: the
    cluster's 8 in rank order; cur's nc chunks in 8 runs of ceil(nc / 8),
    each in chunk order, the runs' sums then by a butterfly (xor 4, 2, 1)."""
    if plan.cluster:
        out = torch.zeros_like(parts[0])
        for x in parts:
            out = out + x
        return out
    per = -(-len(parts) // 8)
    runs = []
    for p in range(8):
        acc = torch.zeros_like(parts[0])
        for x in parts[p * per:(p + 1) * per]:
            acc = acc + x
        runs.append(acc)
    for o in (4, 2, 1):
        runs = [runs[i] + runs[i ^ o] for i in range(8)]
    return runs[0]


_barrier_words = {}  # device index -> cur's grid-barrier int32 word (zeroed once)


def _barrier_word(device: torch.device) -> torch.Tensor:
    """The device's barrier word: every launch leaves it as it found it
    (csrc/probe_attend.cu grid_sync), so it is zeroed once and kept."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    word = _barrier_words.get(idx)
    if word is None:
        word = _barrier_words[idx] = torch.zeros(1, dtype=torch.int32, device=device)
    return word


def declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.magpie_probe_attend_tr.argtypes = [p, p, p, p, i, i, i, i, f, i, p, p]
    lib.magpie_probe_attend_cur.argtypes = [p, p, p, p, i, i, i, i, f, i, p, p, p, p]
    for name in INT8_MODES:
        getattr(lib, f"magpie_probe_attend_{name}").argtypes = [p, p, p, p, p, p, i, i, i, i, f,
                                                                i, p, p]
    for name in ("tr", "cur", *INT8_MODES):
        getattr(lib, f"magpie_probe_attend_{name}").restype = ctypes.c_int


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


def chunked_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sk, sv, rows: int,
                  mode: str, plan=None) -> torch.Tensor:
    """A CPU model of one launch's arithmetic, slot by slot (as the kernel's
    blocks are): per head, the float32 scores (as plain); each partial's max
    m_j and sum l_j of exp(s - m_j) over its rows (``plan.partials``); the
    max m and the sum l = sum_j l_j exp(m_j - m) over the partials in order;
    the probabilities rnd_bf16(exp(s - m) / l) (i8mixed: of the product with
    s_v); each block's float32 partial of P V (``plan.groups``); the
    partials summed in the kernel's order (``combine``).
    ``plan`` defaults to the mode's. Returns [G, D] float32 (the attend, not
    yet added to anything)."""
    _check_mode(mode)
    G, S, D = k.shape
    H = D // DH
    plan = plan_attend(mode) if plan is None else plan
    parts = [torch.tensor(p) for p in plan.partials(rows) if p]
    groups = [torch.tensor(g) for g in plan.groups(rows) if g]
    out = torch.zeros(G, D)
    for b in range(G):
        qh = q[b].float().cpu().view(H, DH)
        kb, vb = k[b, :rows].float().cpu(), v[b, :rows].float().cpu()
        if mode in INT8_MODES:
            skr, svr = sk[b, :rows].float().cpu(), sv[b, :rows].float().cpu()
        if mode == "i8cast":
            kb = (kb * skr[:, None]).to(torch.bfloat16).float()
            vb = (vb * svr[:, None]).to(torch.bfloat16).float()
        kh, vh = kb.view(rows, H, DH), vb.view(rows, H, DH)
        scores = torch.einsum("hd,rhd->hr", qh, kh)
        scores = scores * (skr[None, :] * INV) if mode == "i8mixed" else scores * INV
        m_j = [scores[:, idx].amax(-1) for idx in parts]
        l_j = [torch.exp(scores[:, idx] - m[:, None]).sum(-1) for idx, m in zip(parts, m_j)]
        m = torch.stack(m_j, -1).amax(-1)
        total = torch.zeros(H)
        for mi, li in zip(m_j, l_j):
            total = total + li * torch.exp(mi - m)
        probs = torch.exp(scores - m[:, None]) / total[:, None]
        if mode == "i8mixed":
            probs = probs * svr[None, :]
        pw = probs.to(torch.bfloat16).float()
        out[b] = combine(plan, [torch.einsum("hr,rhd->hd", pw[:, idx], vh[idx])
                                for idx in groups]).reshape(D)
    return out.to(q.device)


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
                      sk, sv, rows: int, mode: str, stamps=None) -> torch.Tensor:
    """One launch: out [G, D] float32 += the attend of q over rows [0, rows)
    (in place; on CPU tensors, the plain version's). ``stamps``: None, or a
    zeroed int64 [blocks, STAMPS] tensor for the phase stamps."""
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
    if D % DH or not 1 <= int(rows) <= S or (mode == "cur" and (D % 256 or D > CUR_MAX_D)):
        raise ValueError(f"probe_attend: D {D} must be a multiple of {DH} (cur: of 256, at most "
                         f"{CUR_MAX_D}) and rows {rows} in [1, {S}]")
    if stamps is not None:
        _check("stamps", stamps, (plan_attend(mode).blocks(G, D // DH, rows), STAMPS),
               torch.int64, dev)
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = getattr(lib, f"magpie_probe_attend_{_ENTRY[mode]}")
    scales = (sk.data_ptr(), sv.data_ptr()) if mode in INT8_MODES else ()
    extra = ()
    if mode == "cur":
        # held until the launch is enqueued (the caching allocator may hand
        # it out again once this frame drops it: stream order keeps that safe)
        ws = torch.empty(workspace_words(G, D, rows), dtype=torch.float32, device=dev)
        extra = (ws.data_ptr(), _barrier_word(dev).data_ptr())
    with torch.cuda.device(dev):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, out.data_ptr(), G, S, D,
                    int(rows), INV, plan_attend(mode).chunk, *extra,
                    None if stamps is None else stamps.data_ptr(), stream)
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


def attend_stamps(q, k, v, sk, sv, rows: int, mode: str) -> torch.Tensor:
    """One launch on a card with phase stamps: int64 [blocks, STAMPS]
    %globaltimer ns (csrc/probe_attend.cu: start, first K rows landed, rows
    scored, partials ready, past the barrier, P V partial ready, end; a cur
    block that took no item keeps zeros). Adds to nothing: its output is
    dropped."""
    G, _, D = k.shape
    stamps = torch.zeros(plan_attend(mode).blocks(G, D // DH, rows), STAMPS, dtype=torch.int64,
                         device=q.device)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    attend_accumulate(out, q, k, v, sk, sv, rows, mode, stamps=stamps)
    return stamps


def read_phases(stamps: torch.Tensor) -> dict:
    """us from the first block's start to the last block's reaching each
    stamp, and the median block's us from its own start (blocks that took no
    item dropped)."""
    t = stamps.cpu().double()
    t = t[t[:, 0] > 0]
    t0 = float(t[:, 0].min())
    res = {}
    for i, name in enumerate(STAMP_NAMES):
        res[f"{name}_last_us"] = (float(t[:, i].max()) - t0) / 1e3
        res[f"{name}_median_us"] = float((t[:, i] - t[:, 0]).median()) / 1e3
    res["blocks"] = int(t.shape[0])
    return res
