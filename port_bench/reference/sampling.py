"""The sampling rule the served codes follow, written out plainly: JAX's
threefry key chain on the host, a counter-based Gumbel draw per
(frame seed, codebook, column), exact top-k membership, Gumbel-max.

A frozen restatement of the rule, kept with the benchmark so that the check
shares no code with the program it judges. A request's key is
``fold_in(prng_key(seed), request_id)`` in the serving engine and
``fold_in(prng_key(seed), chunk)`` per streamed chunk; every frame splits the
carried key into (next key, subkey) and samples with the subkey's folded
seed; codebook ``c`` hashes ``seed + c * 747796405``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
MIX_A = -2048144789 & M32
MIX_B = -1028477379 & M32
GOLDEN = -1640531527 & M32
PHASE_C = 747796405
U_LO = float(np.float32(1e-10))
U_HI = float(np.float32(1.0 - 1e-7))
NEG = -1e30


def _rotl(x, r):
    return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))) & np.uint32(M32)


def threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, elementwise on uint32 arrays."""
    k0, k1 = np.asarray(k0, np.uint32), np.asarray(k1, np.uint32)
    x0, x1 = np.asarray(x0, np.uint32), np.asarray(x1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rot[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key_of(seed: int) -> Tuple[np.ndarray, np.ndarray]:
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32")
    return np.uint32(0), np.uint32(seed & M32)


def fold_in(key, data: int):
    return threefry(key[0], key[1], np.uint32(0), np.uint32(data & M32))


def frame_seeds(keys: np.ndarray, n: int) -> np.ndarray:
    """keys [R, 2] uint32 -> int32 seeds [R, n] of frames 0..n-1."""
    k0, k1 = keys[:, 0].astype(np.uint32), keys[:, 1].astype(np.uint32)
    zero, one = np.zeros_like(k0), np.ones_like(k0)
    out = np.empty((keys.shape[0], n), np.int32)
    with np.errstate(over="ignore"):
        for j in range(n):
            s0, s1 = threefry(k0, k1, zero, one)
            out[:, j] = (s0 ^ s1).view(np.int32)
            k0, k1 = threefry(k0, k1, zero, zero)
    return out


def request_key(seed: int, request_id: int) -> np.ndarray:
    """``fold_in(prng_key(seed), request_id)`` as uint32 [2]."""
    return request_keys([seed], [request_id])[0]


def request_keys(seeds, request_ids) -> np.ndarray:
    """``request_key`` of many at once: uint32 [R, 2]."""
    for s in seeds:
        key_of(int(s))
    lo = np.array([int(s) & M32 for s in seeds], np.uint32)
    data = np.array([int(r) & M32 for r in request_ids], np.uint32)
    with np.errstate(over="ignore"):
        k0, k1 = threefry(np.zeros_like(lo), lo, np.zeros_like(data), data)
    return np.stack([k0, k1], axis=1)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    x = x & M32
    return torch.where(x >= 2**31, x - 2**32, x)


def gumbel(frame_seed: torch.Tensor, n_cb: int, vocab: int) -> torch.Tensor:
    """frame_seed [...] int64 -> Gumbel noise [..., n_cb, vocab] float64."""
    cb = torch.arange(n_cb, device=frame_seed.device, dtype=torch.int64)
    base = _wrap(frame_seed[..., None] + cb * PHASE_C)[..., None]
    cols = torch.arange(vocab, device=frame_seed.device, dtype=torch.int64)
    x = _wrap(base + cols * GOLDEN)
    x = x ^ ((x & M32) >> 16)
    x = _wrap(x * MIX_A)
    x = x ^ ((x & M32) >> 13)
    x = _wrap(x * MIX_B)
    x = x ^ ((x & M32) >> 16)
    u = ((_wrap(x) & M32) >> 8).to(torch.float64) * (1.0 / (1 << 24))
    u = u.clamp(U_LO, U_HI)
    return -torch.log(-torch.log(u))


def _masked(logits: torch.Tensor, frame_index: torch.Tensor, eos_id: int, bos_id: int,
            min_frames: int) -> torch.Tensor:
    """The logits the rule ranks: the forbidden specials out, EOS out early."""
    m = logits.double().clone()
    ids = torch.arange(m.shape[-1], device=m.device)
    forbidden = (ids == bos_id) | ((ids >= bos_id + 2) & (ids <= bos_id + 7))
    m[..., forbidden] = NEG
    m[frame_index < min_frames, :, eos_id] += NEG
    return m


def min_perturbation(m: torch.Tensor, g: torch.Tensor, s: torch.Tensor, temperature: float,
                     top_k: int, steps: int = 60) -> torch.Tensor:
    """The least eps such that logits within +-eps of ``m`` [P, V] make the
    rule (top-k of the logits, then the largest ``p / T + g``) choose code
    ``s`` [P]: how far the logits the code was drawn from must lie from
    ``m``. 0 where the rule already chooses ``s``; continuous in ``m``.

    Feasible at eps when: at most k - 1 codes lie more than 2 eps above s;
    every code that beats s even lowered by eps (a threat) can be kept out
    of the top-k, i.e. s and k - 1 codes that can be set harmless sit above
    the highest threat lowered by eps. Bisected, as feasibility grows with eps.
    """
    P, V = m.shape
    T = float(temperature)
    m_s = m.gather(1, s[:, None])
    g_s = g.gather(1, s[:, None])
    others = torch.ones_like(m, dtype=torch.bool)
    others.scatter_(1, s[:, None], False)
    beat = m - m_s + T * (g - g_s)          # > 2 eps: a threat however it is set
    lo = torch.zeros(P, 1, dtype=m.dtype, device=m.device)
    hi = (beat.masked_fill(~others, -torch.inf).amax(1, keepdim=True).clamp(min=0) / 2
          + (m.amax(1, keepdim=True) - m_s).clamp(min=0) / 2 + 1.0)
    for _ in range(steps):
        eps = (lo + hi) / 2
        above = ((m - m_s > 2 * eps) & others).sum(1, keepdim=True)
        threat = (beat > 2 * eps) & others
        top_threat = (m - eps).masked_fill(~threat, -torch.inf).amax(1, keepdim=True)
        harmless_top = torch.minimum(m + eps, m_s + eps + T * (g_s - g))
        room = ((harmless_top > top_threat) & others & ~threat).sum(1, keepdim=True)
        ok = (above <= top_k - 1) & ((m_s + eps > top_threat) & (room >= top_k - 1)
                                     | torch.isinf(top_threat))
        hi = torch.where(ok, eps, hi)
        lo = torch.where(ok, lo, eps)
    return hi[:, 0]


def token_gaps(logits: torch.Tensor, codes: torch.Tensor, frame_seed: torch.Tensor,
               frame_index: torch.Tensor, temperature: float, top_k: int, *,
               eos_id: int, bos_id: int, min_frames: int, choose=None) -> torch.Tensor:
    """Per frame, how far the reference's logits [F, C, V] must move (in
    logits, at most) for the sampling rule to serve what was served: the
    largest over the frame's codebooks of ``min_perturbation`` of the served
    code and, past ``min_frames``, half of EOS's lead over every other logit
    (the frame would have ended). ``choose`` [F, C] judges another side's
    choice in place of ``codes`` (the control's first code; the EOS lead is
    then left out, being the served sequence's). Returns gaps [F]."""
    F_, C, V = logits.shape
    m = _masked(logits, frame_index, eos_id, bos_id, min_frames)
    g = gumbel(frame_seed.to(torch.int64), C, V)
    kth = m.topk(min(top_k, V), dim=-1).values[..., -1:]
    z = torch.where(m >= kth, m / temperature + g, torch.full_like(m, -torch.inf))
    served = (codes if choose is None else choose).long()
    gap = torch.zeros(F_, C, dtype=m.dtype, device=m.device)
    off = served != z.argmax(-1)
    if bool(off.any()):
        gap[off] = min_perturbation(m[off], g[off], served[off], temperature, top_k)
    if choose is None:
        other = m.clone()
        other[..., eos_id] = NEG
        lead = ((m[..., eos_id] - other.amax(-1)) / 2).clamp(min=0)
        gap = torch.maximum(gap, torch.where((frame_index < min_frames)[:, None],
                                             torch.zeros_like(lead), lead))
    return gap.amax(-1)


def end_gap(logits: torch.Tensor, frame_seed: torch.Tensor, frame_index: int,
            temperature: float, top_k: int, *, eos_id: int, bos_id: int,
            min_frames: int) -> float:
    """How far the reference's logits [C, V] of the frame an utterance ended
    on must move (in logits, at most) for the rule to end it there: in some
    codebook, the rule draws EOS (``min_perturbation`` of EOS) or EOS leads
    every other logit (half its shortfall). 0 where the reference ends the
    frame too; before ``min_frames``, where EOS is out, about 1e30."""
    idx = torch.tensor([frame_index], device=logits.device)
    m = _masked(logits[None], idx, eos_id, bos_id, min_frames)[0]
    g = gumbel(frame_seed.reshape(1).to(torch.int64), m.shape[0], m.shape[1])[0]
    eos = torch.full((m.shape[0],), eos_id, dtype=torch.long, device=m.device)
    kth = m.topk(min(top_k, m.shape[-1]), dim=-1).values[..., -1:]
    z = torch.where(m >= kth, m / temperature + g, torch.full_like(m, -torch.inf))
    draw = torch.zeros(m.shape[0], dtype=m.dtype, device=m.device)
    off = z.argmax(-1) != eos_id
    if bool(off.any()):
        draw[off] = min_perturbation(m[off], g[off], eos[off], temperature, top_k)
    other = m.clone()
    other[:, eos_id] = NEG
    lead = ((other.amax(-1) - m[:, eos_id]) / 2).clamp(min=0)
    return float(torch.minimum(draw, lead).min())


def rule_ends(logits: torch.Tensor, frame_seed: torch.Tensor, frame_index: int,
              temperature: float, top_k: int, *, eos_id: int, bos_id: int,
              min_frames: int) -> bool:
    """Whether the rule, under ``logits`` [C, V], ends the frame: EOS drawn
    or leading in some codebook."""
    idx = torch.tensor([frame_index], device=logits.device)
    kw = dict(eos_id=eos_id, bos_id=bos_id, min_frames=min_frames)
    drawn = rule_choice(logits[None], frame_seed.reshape(1), idx, temperature, top_k, **kw)[0]
    lead = _masked(logits[None], idx, **kw)[0].argmax(-1)
    return bool(((drawn == eos_id) | (lead == eos_id)).any())


def rule_choice(logits: torch.Tensor, frame_seed: torch.Tensor, frame_index: torch.Tensor,
                temperature: float, top_k: int, *, eos_id: int, bos_id: int,
                min_frames: int) -> torch.Tensor:
    """The code the rule picks at each (frame, codebook) under ``logits``."""
    m = _masked(logits, frame_index, eos_id, bos_id, min_frames)
    kth = m.topk(min(top_k, m.shape[-1]), dim=-1).values[..., -1:]
    z = m / temperature + gumbel(frame_seed.to(torch.int64), m.shape[1], m.shape[2])
    return torch.where(m >= kth, z, torch.full_like(z, -torch.inf)).argmax(-1)
