"""Kernel 4 as one persistent launch a frame, and kernel 7 and kernel C's LT
part (frame_sequence.cuh lt_phases), on the card.

Each test needs a CUDA device and skips without one; the file imports neither
jax nor the JAX package:
    MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_lt_persistent_cuda.py -q -m cuda

At 357M width in both dtypes: kernel 4 (B = 1) and kernel 7 (B = 1, 3, 8,
13, 32, 64) against their plain versions at temperatures 0 and 0.7, EOS
forbidden in some slots (codes exact in float32; in bf16 a code may differ
only at a near-tie of the plain scores, the smoke's rule); kernel 4's codes
equal to kernel A's on the same hidden row (the split path's codes are the
fused path's) and equal over grids; kernel C's codes equal to kernel 7's on
the same rows; kernel 4's phase stamps against its plan; 200 frames
replayed from one CUDA graph; a launch the card refuses raises and leaves
no error behind. The small config's kernels against plain at every B.
"""

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.config import MagpieConfig
from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts
from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
from magpie_tts_tpu_torch.runtime import engine as engine_mod

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
SLOTS = (1, 3, 8, 13, 32, 64)
TOP_K = 80
# The tiny config of tests/test_torch_cuda.py.
SMALL = MagpieConfig(
    d_model=64, d_ffn=128, d_head=16, enc_layers=2, enc_heads=4, enc_kernel=3,
    dec_layers=2, dec_sa_heads=4, dec_xa_heads=1, dec_xa_d_head=32, dec_kernel=1,
    lt_dim=32, lt_ffn_dim=64, lt_layers=1, lt_heads=1, text_vocab_size=100,
    num_codebooks=8, codebook_size=32, vocab_per_cb=40, num_speakers=2,
    context_frames=6, text_bos_id=98, text_eos_id=99, audio_bos_id=32, audio_eos_id=33,
    context_bos_id=34, context_eos_id=35, mask_token_id=36, max_dec_steps=16,
    min_generated_frames=2, max_pos=128)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return engine_mod.resolve_device("cuda")


@pytest.fixture(scope="module")
def full(card):
    """{dtype: (config, weights)} at 357M width."""
    c = MagpieConfig()
    w = random_magpie_weights(c, seed=0).to(device=card)
    return {torch.float32: (c, w), BF: (c, w.to(dtype=BF))}


@pytest.fixture(scope="module")
def small(card):
    return {torch.float32: (SMALL, random_magpie_weights(SMALL, seed=11).to(device=card))}


def _inputs(c, dev, B, dtype, seed):
    rng = np.random.default_rng(seed)
    hidden = torch.tensor(rng.normal(0, 1.0, (B, c.d_model)), dtype=torch.float32,
                          device=dev).to(dtype)
    seeds = torch.tensor(rng.integers(-2**31, 2**31, B), dtype=torch.int32, device=dev)
    forbid = torch.tensor(rng.random(B) < 0.3, device=dev)
    return hidden, seeds, forbid


def _flips(hidden, sampled, argmax, w, c, seed, temp, forbid):
    """The codes of one slot's frame that differ from the plain LT sampler
    fed the kernel's earlier codes, as (phase, gap, ulp): the plain winner's
    score minus the kernel's code's (in logits; at temp >= 0.01 the Gumbel
    score times temp) and one bf16 ulp of the winner's logit
    (chip_smoke.lt_flips)."""
    from magpie_tts_tpu_torch.models import local_transformer as lt_mod
    from magpie_tts_tpu_torch.ops import sampling
    from magpie_tts_tpu_torch.ops.precision import matmul_f32

    lt, dev = w.lt, hidden.device
    mask = sampling.forbidden_token_mask(c.vocab_per_cb, c.audio_bos_id, device=dev)
    seq = torch.zeros(9, c.lt_dim, dtype=hidden.dtype, device=dev)
    seq[0] = lt_mod._in_proj(hidden, lt)
    cols = torch.arange(c.vocab_per_cb, device=dev)
    flips = []
    for cb in range(c.num_codebooks):
        hid = lt_mod._lt_layer_f32(seq, lt, c)[cb]
        logits = matmul_f32(hid.to(hidden.dtype), lt.out_proj_w[cb]) + lt.out_proj_b[cb].float()
        logits = sampling.mask_logits(logits, mask, forbid, c.audio_eos_id)
        scored = [(logits, argmax[cb], 1.0)]
        if temp >= 0.01:
            keep = sampling.exact_topk_mask(logits, min(TOP_K, c.vocab_per_cb))
            g = sampling.gumbel_from_seed(sampling.phase_seed(seed, cb).to(dev), cols)
            z = torch.where(keep, logits / temp + g, torch.full_like(logits, sampling.NEG_INF))
            scored.append((z, sampled[cb], temp))
        for z, got, scale in scored:
            want = int(torch.argmax(z))
            if got != want:
                lw = abs(float(logits[want]))
                ulp = 2.0 ** (np.floor(np.log2(lw)) - 7) if lw > 0 else 0.0
                flips.append((cb, float(z[want] - z[got]) * scale, ulp))
        if cb < c.num_codebooks - 1:
            seq[cb + 1] = lt_mod._in_proj(w.audio_emb[cb, sampled[cb]], lt)
    return flips


def _codes_agree(got, want, hidden, w, c, dtype, seeds, temp, forbid):
    """float32: equal. bf16: equal, or every code that differs from the
    plain sampler fed the kernel's earlier codes a near-tie of the plain
    scores (within one bf16 ulp of the winner's logit)."""
    if dtype == torch.float32:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    for b in range(got[0].shape[0]):
        if torch.equal(got[0][b], want[0][b]) and torch.equal(got[1][b], want[1][b]):
            continue
        flips = _flips(hidden[b], got[0][b].tolist(), got[1][b].tolist(), w, c, int(seeds[b]),
                       temp, bool(forbid[b]))
        assert flips and all(gap < ulp for _, gap, ulp in flips), (b, flips)


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])


@DTYPES
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_kernel4_matches_plain(full, card, dtype, temperature):
    """Kernel 4 at B = 1 on 6 hidden rows, EOS forbidden in some, against
    its plain version."""
    c, w = full[dtype]
    hidden, seeds, forbid = _inputs(c, card, 6, dtype, 40 + int(temperature * 10))
    with torch.no_grad():
        got = [lts.sample_frame_codes(hidden[b], w, c, int(seeds[b]), temperature, TOP_K,
                                      bool(forbid[b])) for b in range(6)]
        want = [lts.sample_frame_codes_reference(hidden[b], w, c, int(seeds[b]), temperature,
                                                 TOP_K, bool(forbid[b])) for b in range(6)]
    torch.cuda.synchronize()
    stack = lambda runs, i: torch.stack([r[i] for r in runs])
    _codes_agree((stack(got, 0), stack(got, 1)), (stack(want, 0), stack(want, 1)), hidden, w, c,
                 dtype, seeds, temperature, forbid)


@DTYPES
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_kernel4_codes_are_kernel_a_codes(full, card, dtype, temperature):
    """Kernel 4 runs kernel A's LT phases: on the same hidden row, seed and
    EOS flag its codes and argmax are A's, bit for bit; and over grids of
    66 and 132 blocks they do not change."""
    c, w = full[dtype]
    hidden, seeds, forbid = _inputs(c, card, 4, dtype, 60 + int(temperature * 10))
    S, E, L, D = c.max_seq, 8, c.dec_layers, c.d_model
    gen = torch.Generator(device=card).manual_seed(4)
    rnd = lambda *shape: (torch.randn(*shape, generator=gen, device=card) * 0.5).to(dtype)
    kc, vc, xa_k, xa_v = rnd(L, S, D), rnd(L, S, D), rnd(L, E, c.d_xa), rnd(L, E, c.d_xa)
    with torch.no_grad():
        for b in range(4):
            seed, fb = int(seeds[b]), bool(forbid[b])
            sa, aa, _, _, _ = fs.frame_step(hidden[b], 20, xa_k, xa_v, kc, vc, w, c, seed,
                                            temperature, TOP_K, fb, enc_length=E)
            s4, a4 = lts.sample_frame_codes(hidden[b], w, c, seed, temperature, TOP_K, fb)
            s66, a66 = lts.sample_frame_codes(hidden[b], w, c, seed, temperature, TOP_K, fb,
                                              grid=66)
            torch.cuda.synchronize()
            assert torch.equal(s4, sa) and torch.equal(a4, aa), b
            assert torch.equal(s66, s4) and torch.equal(a66, a4), b


@DTYPES
@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("B", SLOTS)
def test_kernel7_matches_plain(full, card, dtype, temperature, B):
    """Kernel 7 at B slots, per-slot seeds and EOS flags, against its plain
    version."""
    c, w = full[dtype]
    hidden, seeds, forbid = _inputs(c, card, B, dtype, 700 + B + int(temperature * 10))
    with torch.no_grad():
        got = ltsb.sample_frame_codes_batched(hidden, w, c, seeds, temperature, TOP_K, forbid)
        want = ltsb.sample_frame_codes_batched_reference(hidden, w, c, seeds, temperature,
                                                         TOP_K, forbid)
    torch.cuda.synchronize()
    _codes_agree(got, want, hidden, w, c, dtype, seeds, temperature, forbid)


@DTYPES
@pytest.mark.parametrize("B", [3, 8, 32])
def test_kernel_c_lt_part_is_kernel7s(full, card, dtype, B):
    """Kernel C's codes equal kernel 7's on the same rows (the same LT
    sequence), and C's frame agrees with its plain version's codes."""
    c, w = full[dtype]
    hidden, seeds, forbid = _inputs(c, card, B, dtype, 900 + B)
    S, E, L, D = c.max_seq, 8, c.dec_layers, c.d_model
    gen = torch.Generator(device=card).manual_seed(B)
    rnd = lambda *shape: (torch.randn(*shape, generator=gen, device=card) * 0.5).to(dtype)
    k0, v0 = rnd(B, L, S, D), rnd(B, L, S, D)
    xa_k, xa_v = rnd(B, L, E, c.d_xa), rnd(B, L, E, c.d_xa)
    row = 40
    valid = (torch.arange(S, device=card) < row)[None].expand(B, -1)
    args = (hidden, row, valid, torch.ones(B, dtype=torch.bool, device=card),
            w.decoder.pos_emb[row][None].expand(B, -1), xa_k, xa_v)
    tail = (w, c, torch.full((B,), E, dtype=torch.int32, device=card), seeds, 0.7, TOP_K, forbid)
    with torch.no_grad():
        s7, a7 = ltsb.sample_frame_codes_batched(hidden, w, c, seeds, 0.7, TOP_K, forbid)
        sc, ac, _, _, _ = fsb.frame_step_batched(*args, k0.clone(), v0.clone(), *tail,
                                                 rows=row + 1)
        sr, ar, _, _, _ = fsb.frame_step_batched_reference(*args, k0.clone(), v0.clone(),
                                                           *tail, rows=row + 1)
    torch.cuda.synchronize()
    assert torch.equal(sc, s7) and torch.equal(ac, a7)
    _codes_agree((sc, ac), (sr, ar), hidden, w, c, dtype, seeds, 0.7, forbid)


@pytest.mark.parametrize("B", SLOTS)
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_small_config_matches_plain(small, card, B, temperature):
    """The tiny config (LT 32 wide, 40 logits: narrower than a tile's row
    groups) at every B: kernels 4 and 7 against plain, codes exact."""
    c, w = small[torch.float32]
    hidden, seeds, forbid = _inputs(c, card, B, torch.float32, 30 + B)
    with torch.no_grad():
        sk, ak = ltsb.sample_frame_codes_batched(hidden, w, c, seeds, temperature, 8, forbid)
        sr, ar = ltsb.sample_frame_codes_batched_reference(hidden, w, c, seeds, temperature, 8,
                                                           forbid)
        s4, a4 = lts.sample_frame_codes(hidden[0], w, c, int(seeds[0]), temperature, 8,
                                        bool(forbid[0]))
    torch.cuda.synchronize()
    assert torch.equal(sk, sr) and torch.equal(ak, ar)
    assert torch.equal(s4, sr[0]) and torch.equal(a4, ar[0])


def test_two_configs_in_one_process(full, small, card):
    """Kernel 4 at the small config, then at 357M (more shared memory a
    block), then small again: each launch runs and agrees with plain."""
    for c, w in (small[torch.float32], full[torch.float32], small[torch.float32]):
        hidden, _, _ = _inputs(c, card, 1, torch.float32, 77)
        with torch.no_grad():
            got = lts.sample_frame_codes(hidden[0], w, c, 3, 0.7, 8, False)
            want = lts.sample_frame_codes_reference(hidden[0], w, c, 3, 0.7, 8, False)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_stamps_follow_the_plan(full, card):
    """Kernel 4's phase stamps: one record a phase of plan_lt (48 barriers
    and the last draw at 357M), in time order."""
    c, w = full[torch.float32]
    hidden, _, _ = _inputs(c, card, 1, torch.float32, 5)
    stamps = torch.zeros(1 + fs.STAMP_WORDS * 128, dtype=torch.int64, device=card)
    with torch.no_grad():
        lts.sample_frame_codes(hidden[0], w, c, 5, 0.7, TOP_K, False, stamps=stamps)
    torch.cuda.synchronize()
    recs = fs.read_stamps(stamps)
    plan = fs.plan_lt(c)
    assert len(recs) == len(plan.phases)
    assert all(r["start"] <= r["pro_end"] <= r["end"] for r in recs)
    assert all(a["end"] <= b["start"] for a, b in zip(recs, recs[1:]))
    assert [r["work"] for r in recs] == ["gemv"] * plan.barriers + ["none"]


def test_200_frames_replayed_from_one_graph(full, card):
    """Kernels 4 and 7 captured in one CUDA graph, replayed 200 times: the
    eager bits every time."""
    c, w = full[torch.float32]
    hidden, seeds, forbid = _inputs(c, card, 8, torch.float32, 200)
    with torch.no_grad():
        want7 = ltsb.sample_frame_codes_batched(hidden, w, c, seeds, 0.7, TOP_K, forbid)
        want4 = lts.sample_frame_codes(hidden[0], w, c, 5, 0.7, TOP_K, False)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got7 = ltsb.sample_frame_codes_batched(hidden, w, c, seeds, 0.7, TOP_K, forbid)
            got4 = lts.sample_frame_codes(hidden[0], w, c, 5, 0.7, TOP_K, False)
        for _ in range(200):
            for x in got7 + got4:
                x.fill_(-1)
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got7 + got4, want7 + want4))
    del graph


def test_a_refused_launch_raises_and_clears_its_error(full, card):
    """A grid past what the card holds at once is refused by the cooperative
    launch and raises; the next launches run and agree with plain."""
    c, w = full[torch.float32]
    hidden, _, _ = _inputs(c, card, 1, torch.float32, 32)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="CUDA error"):
            lts.sample_frame_codes(hidden[0], w, c, 1, 0.0, TOP_K, False, grid=100000)
        got = lts.sample_frame_codes(hidden[0], w, c, 1, 0.0, TOP_K, False)
        want = lts.sample_frame_codes_reference(hidden[0], w, c, 1, 0.0, TOP_K, False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
