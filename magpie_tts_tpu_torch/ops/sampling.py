"""Deterministic sampling (magpie_tts_tpu/ops/sampling.py) in torch int32 math,
plus a host-side numpy threefry2x32 that reproduces JAX's key chain.

The JAX package draws every frame's noise from an int32 seed derived from a
``jax.random`` key; the port derives the same seeds on the host with
``prng_key`` / ``split`` / ``fold_in`` / ``seed_from_key`` below (JAX's
partitionable threefry, the default since jax 0.5), so ``--seed N`` samples
the same codes in both packages.

Integer hashing runs in int64 and wraps to 32 bits explicitly, so the
two's-complement results equal JAX's int32 wraparound on every device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

NEG_INF = -1e30
GREEDY_TEMP_THRESHOLD = 0.01

_M32 = 0xFFFFFFFF
# The JAX package's int32 literals, verbatim (the hash is defined by these
# values; note -1028477379 is 0xC2B2AE3D).
_MIX_A = -2048144789 & _M32
_MIX_B = -1028477379 & _M32
_GOLDEN = -1640531527 & _M32
_PHASE_C = 747796405
# jnp.clip(u, 1e-10, 1.0 - 1e-7) rounds both bounds to float32.
_U_LO = float(np.float32(1e-10))
_U_HI = float(np.float32(1.0 - 1e-7))


# ---------------------------------------------------------------- threefry

def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Random123; jax.random's block cipher), on
    ints or elementwise on uint32 arrays (which wrap, so the masks are no-ops)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: (0, seed mod 2^32)."""
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32")
    return 0, seed & _M32


def split(key: Tuple[int, int]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``jax.random.split(key)`` (2 keys): key i = threefry(key, (0, i))."""
    return threefry2x32(*key, 0, 0), threefry2x32(*key, 0, 1)


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)``: threefry(key, PRNGKey(data))."""
    return threefry2x32(*key, 0, data & _M32)


def seed_from_key(key: Tuple[int, int]) -> int:
    """Canonical int32 seed of a key: both words XORed, as two's complement."""
    folded = key[0] ^ key[1]
    return folded - (1 << 32) if folded >= 1 << 31 else folded


def frame_seeds(key: Tuple[int, int], n: int) -> list:
    """Seeds of decode frames 0..n-1: each frame splits the carried key into
    (next key, subkey) and samples with ``seed_from_key(subkey)``."""
    seeds = []
    for _ in range(n):
        key, sub = split(key)
        seeds.append(seed_from_key(sub))
    return seeds


def frame_seeds_batch(keys: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``frame_seeds`` of B keys at once: keys [B, 2] uint32 -> (seeds [n, B]
    int32 of frames 0..n-1, the keys [B, 2] after those n splits)."""
    k0, k1 = keys[:, 0].astype(np.uint32), keys[:, 1].astype(np.uint32)
    zero, one = np.zeros_like(k0), np.ones_like(k0)
    seeds = np.empty((n, keys.shape[0]), np.int32)
    for j in range(n):
        s0, s1 = threefry2x32(k0, k1, zero, one)
        seeds[j] = (s0 ^ s1).view(np.int32)
        k0, k1 = threefry2x32(k0, k1, zero, zero)
    return seeds, np.stack([k0, k1], axis=1)


# ------------------------------------------------------ int32 hash + noise

def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> its low 32 bits as two's-complement, kept in int64."""
    x = x & _M32
    return torch.where(x >= 2**31, x - 2**32, x)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 values held in int64."""
    return (x & _M32) >> s


def phase_seed(seed, phase) -> torch.Tensor:
    """Per-codebook-phase seed derivation (int32 wraparound)."""
    return _wrap32(torch.as_tensor(seed, dtype=torch.int64) + int(phase) * _PHASE_C)


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int32 values (held in int64)."""
    x = x ^ _srl(x, 16)
    x = _wrap32(x * _MIX_A)
    x = x ^ _srl(x, 13)
    x = _wrap32(x * _MIX_B)
    x = x ^ _srl(x, 16)
    return _wrap32(x)


def uniform_from_seed(base_seed, cols: torch.Tensor) -> torch.Tensor:
    """The hash's top 24 bits as an exact float32 uniform, clipped to
    [1e-10, 1 - 1e-7]. ``base_seed`` broadcasts against ``cols``."""
    base = torch.as_tensor(base_seed, dtype=torch.int64, device=cols.device)
    h = _fmix32(_wrap32(base + cols.to(torch.int64) * _GOLDEN))
    u = _srl(h, 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp(u, _U_LO, _U_HI)


def gumbel_from_seed(base_seed, cols: torch.Tensor) -> torch.Tensor:
    """Counter-based Gumbel(0,1) noise ``-log(-log(u))``, float32.

    The uniforms equal the JAX package's bit for bit; the two ``log``s are
    each backend's float32 log (within an ulp of each other)."""
    u = uniform_from_seed(base_seed, cols)
    return -torch.log(-torch.log(u))


def exact_topk_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """EXACT top-k membership over the last axis: 32-pass integer bisection
    for the k-th largest value on the monotone int key of the float bits;
    entries tying the k-th value bit-for-bit are all admitted."""
    bits = logits.float().contiguous().view(torch.int32).to(torch.int64)
    keys = torch.where(bits >= 0, bits, -2**31 - bits)
    lo = keys.amin(dim=-1, keepdim=True)
    hi = keys.amax(dim=-1, keepdim=True) + 1
    for _ in range(32):
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        cnt = (keys >= mid).sum(dim=-1, keepdim=True)
        ok = cnt >= k
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return keys >= lo


def radix_topk_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """EXACT top-k membership by the kernels' radix select (csrc/common.cuh
    ``block_kth_key``): the k-th largest monotone key, found 8 bits at a time
    from the top (a 256-bin histogram of the keys that share the prefix so
    far, the bin that holds the k-th), then ``keys >= it``. One value, so the
    same set as ``exact_topk_mask``'s bisection; k > n admits every entry."""
    bits = logits.float().contiguous().view(torch.int32).to(torch.int64)
    keys = torch.where(bits >= 0, bits, -2**31 - bits)
    u = keys + 2**31                                  # the unsigned order of the keys
    k = min(int(k), logits.shape[-1])
    lead = logits.shape[:-1]
    prefix = torch.zeros(*lead, 1, dtype=torch.int64)
    mask = 0
    rest = torch.full((*lead, 1), k, dtype=torch.int64)
    bins = torch.arange(256, dtype=torch.int64)
    for shift in (24, 16, 8, 0):
        digit = (u >> shift) & 255
        match = (u & mask) == prefix
        hist = ((digit[..., None] == bins) & match[..., None]).sum(-2)       # [..., 256]
        at_or_above = hist.flip(-1).cumsum(-1).flip(-1)                     # count(digit >= d)
        top = 255 - (at_or_above >= rest).flip(-1).int().argmax(-1, keepdim=True)
        rest = rest - (at_or_above.gather(-1, top) - hist.gather(-1, top))
        prefix = prefix | (top << shift)
        mask |= 255 << shift
    return keys >= prefix - 2**31


def forbidden_token_mask(vocab_size: int, audio_bos_id: int = 2016,
                         device=None) -> torch.Tensor:
    """Additive float32 mask [vocab] for the always-forbidden specials
    (AUDIO_BOS and BOS+2..BOS+7; EOS is masked separately)."""
    ids = torch.arange(vocab_size, device=device)
    forbidden = (ids == audio_bos_id) | ((ids >= audio_bos_id + 2) & (ids <= audio_bos_id + 7))
    return torch.where(forbidden, NEG_INF, 0.0).to(torch.float32)


def mask_logits(logits: torch.Tensor, static_mask: torch.Tensor,
                forbid_eos: bool, audio_eos_id: int) -> torch.Tensor:
    """Apply the forbidden-token mask; mask EOS too while ``forbid_eos``."""
    logits = logits.float() + static_mask
    if forbid_eos:
        logits = logits.clone()
        logits[..., audio_eos_id] += NEG_INF
    return logits


def sample_top_k_deterministic(seed, phase, logits: torch.Tensor,
                               temperature: float, top_k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sampled_id, argmax_id) int32 from masked logits [vocab]: exact top-k
    membership + Gumbel-max with ``gumbel_from_seed`` noise; greedy (pure
    argmax, lowest index on ties) when temperature < 0.01."""
    argmax_id = torch.argmax(logits, dim=-1).to(torch.int32)
    temp = torch.tensor(temperature, dtype=torch.float32)
    if temp < GREEDY_TEMP_THRESHOLD:
        return argmax_id, argmax_id
    k = min(top_k, logits.shape[-1])
    in_topk = exact_topk_mask(logits, k)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    gumbel = gumbel_from_seed(phase_seed(seed, phase).to(logits.device), cols)
    safe_temp = torch.clamp(temp, min=GREEDY_TEMP_THRESHOLD).to(logits.device)
    z = torch.where(in_topk, logits / safe_temp + gumbel,
                    torch.full_like(logits, NEG_INF))
    return torch.argmax(z, dim=-1).to(torch.int32), argmax_id


def frame_has_eos(sampled: torch.Tensor, argmax: torch.Tensor, audio_eos_id: int) -> bool:
    """EOS if ANY codebook produced EOS in either the sampled or argmax codes
    (reference ``argmax_or_multinomial_any``)."""
    return bool(((sampled == audio_eos_id) | (argmax == audio_eos_id)).any())
