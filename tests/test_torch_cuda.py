"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, and the decode loop / codec through the kernels, at small shapes.

Every test here needs a CUDA device and skips without one. This file imports
neither jax nor the JAX package, so it also runs where jax is not installed:
    MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q -m cuda
(``MAGPIE_TEST_TPU=1`` keeps tests/conftest.py from importing jax.)
"""

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.config import CodecConfig, MagpieConfig
from magpie_tts_tpu_torch.io.codec_weights import random_codec_weights
from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu_torch.models import magpie as magpie_mod
from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts
from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
from magpie_tts_tpu_torch.parallel import continuous as continuous_mod
from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
from magpie_tts_tpu_torch.parallel.serving import BatchedMagpieEngine
from magpie_tts_tpu_torch.runtime import engine as engine_mod

pytestmark = pytest.mark.cuda

# The tiny test configs of tests/utils.py (repeated: that module imports the
# JAX package).
SMALL = MagpieConfig(
    d_model=64, d_ffn=128, d_head=16, enc_layers=2, enc_heads=4, enc_kernel=3,
    dec_layers=2, dec_sa_heads=4, dec_xa_heads=1, dec_xa_d_head=32, dec_kernel=1,
    lt_dim=32, lt_ffn_dim=64, lt_layers=1, lt_heads=1, text_vocab_size=100,
    num_codebooks=8, codebook_size=32, vocab_per_cb=40, num_speakers=2,
    context_frames=6, text_bos_id=98, text_eos_id=99, audio_bos_id=32, audio_eos_id=33,
    context_bos_id=34, context_eos_id=35, mask_token_id=36, max_dec_steps=16,
    min_generated_frames=2, max_pos=128)
SMALL_CODEC = CodecConfig(hop_length=64, base_channels=64, up_sample_rates=(4, 2, 2, 2, 2),
                          up_channels=(32, 16, 8, 4, 2), up_kernels=(8, 4, 4, 4, 4))
TOL = 1e-4  # summation order of the GEMVs / conv differs from torch's


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return engine_mod.resolve_device("cuda")


@pytest.fixture
def prepared(cuda):
    w = random_magpie_weights(SMALL, seed=11).to(device=cuda)
    tokens = torch.tensor(np.random.default_rng(7).integers(2, 96, size=8), device=cuda)
    with torch.no_grad():
        xa_k, xa_v, st = magpie_mod.prepare(tokens, 6, 0, w, SMALL)
    return w, xa_k, xa_v, st


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_frame_step_kernel_matches_plain(prepared, temperature):
    w, xa_k, xa_v, st = prepared
    args = dict(hidden=st.hidden, pos=st.pos, xa_k=xa_k, xa_v=xa_v, weights=w, config=SMALL,
                seed=5, temperature=temperature, top_k=8, forbid_eos=False, enc_length=6)
    kk, vk = st.k_cache.clone(), st.v_cache.clone()
    kr, vr = st.k_cache.clone(), st.v_cache.clone()
    with torch.no_grad():
        sk, ak, hk, _, _ = fs.frame_step(k_cache=kk, v_cache=vk, **args)
        sr, ar, hr, _, _ = fs.frame_step_reference(k_cache=kr, v_cache=vr, **args)
    assert torch.equal(sk, sr) and torch.equal(ak, ar)
    for got, want in ((hk, hr), (kk, kr), (vk, vr)):
        assert float((got - want).abs().max()) < TOL


@pytest.mark.parametrize("n,residual", [(1, False), (1, True), (2, True)])
def test_conv_kernel_matches_plain(cuda, n, residual):
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.normal(0, 0.5, size=(n, 700, 54)), dtype=torch.float32, device=cuda)
    w = torch.tensor(rng.normal(0, 0.1, size=(11, 54, 54)), dtype=torch.float32, device=cuda)
    b = torch.tensor(rng.normal(size=54), dtype=torch.float32, device=cuda)
    alpha = torch.tensor(rng.uniform(0.4, 1.4, size=27), dtype=torch.float32, device=cuda)
    r = torch.randn(n, 700, 54, device=cuda) if residual else None
    got = cc.snake_causal_conv(x, w, b, alpha, 5, 0.01, residual=r)
    want = cc.snake_causal_conv_reference(x, w, b, alpha, 5, 0.01, r)
    assert float((got - want).abs().max()) < TOL


def test_main_path_goes_through_the_kernels(prepared):
    """One frame-step launch per loop iteration, 92 conv launches per decode."""
    w, xa_k, xa_v, st = prepared
    fs.launches = cc.launches = 0
    with torch.no_grad():
        out = magpie_mod.decode_loop(xa_k, xa_v, st, 6, w, SMALL, (0, 3), 0.7, 8)
    assert fs.launches == out.frame_idx + (1 if out.done else 0)
    codec = engine_mod.CodecEngine(random_codec_weights(SMALL_CODEC, seed=1), SMALL_CODEC,
                                   device="cuda")
    audio = codec.decode(out.codes[:max(out.frame_idx, 1)])
    assert cc.launches == 92 and np.all(np.isfinite(audio))


def _batched_inputs(w, B, write_row, device):
    """B slots with ring-style masks (wrapped runs; the last slot empty)."""
    rng = np.random.default_rng(B)
    L, S, D, E = SMALL.dec_layers, SMALL.max_seq, SMALL.d_model, 16
    valid = np.zeros((B, S), bool)
    for b in range(B - 1):
        valid[b, (write_row + 1 + 3 * b + np.arange(10 + b)) % S] = True
    valid[:, write_row] = False
    f32 = lambda *shape, s=0.5: torch.tensor(rng.normal(0, s, shape), dtype=torch.float32,
                                            device=device)
    return dict(
        hidden=f32(B, D, s=1.0), write_row=write_row,
        valid=torch.tensor(valid, device=device),
        may_continue=torch.tensor(rng.random(B) < 0.7, device=device),
        posemb=w.decoder.pos_emb[torch.tensor(rng.integers(0, 100, B), device=device)],
        xa_k=f32(B, L, E, SMALL.d_xa), xa_v=f32(B, L, E, SMALL.d_xa),
        k_cache=f32(B, L, S, D), v_cache=f32(B, L, S, D),
        enc_lengths=torch.tensor(rng.integers(1, E + 1, B), dtype=torch.int32, device=device),
        seeds=torch.tensor(rng.integers(-2**31, 2**31, B), dtype=torch.int32, device=device),
        forbid_eos=torch.tensor(rng.random(B) < 0.3, device=device))


@pytest.mark.parametrize("B,write_row,temperature", [(3, 5, 0.0), (8, 30, 0.7), (13, 47, 0.7)])
def test_frame_step_batched_kernel_matches_plain(cuda, B, write_row, temperature):
    """Any B in 1..64 (3 and 13 are not multiples of 8); masks that wrap;
    codes exact, hidden and caches to TOL for slots with a valid row."""
    w = random_magpie_weights(SMALL, seed=11).to(device=cuda)
    x = _batched_inputs(w, B, write_row, cuda)
    kk, vk = x["k_cache"].clone(), x["v_cache"].clone()
    kr, vr = x.pop("k_cache"), x.pop("v_cache")
    args = dict(x, weights=w, config=SMALL, temperature=temperature, top_k=8)
    fsb.launches = 0
    with torch.no_grad():
        sk, ak, hk, _, _ = fsb.frame_step_batched(k_cache=kk, v_cache=vk, **args)
        sr, ar, hr, _, _ = fsb.frame_step_batched_reference(k_cache=kr, v_cache=vr, **args)
    torch.cuda.synchronize()
    assert fsb.launches == 1
    assert torch.equal(sk, sr) and torch.equal(ak, ar)
    live = slice(0, B - 1)
    for got, want in ((hk, hr), (kk, kr), (vk, vr)):
        assert float((got[live] - want[live]).abs().max()) < TOL
        assert torch.isfinite(got).all()


def test_batched_engines_go_through_the_kernel(cuda):
    """Lockstep: one launch per frame run; continuous: one per segment frame."""
    w = random_magpie_weights(SMALL, seed=11)
    rng = np.random.default_rng(5)
    reqs = [[98] + [int(t) for t in rng.integers(2, 30, size=n)] + [99] for n in (4, 9, 6)]
    fsb.launches = 0
    lock = BatchedMagpieEngine(w, SMALL, batch_size=3, device="cuda", token_buckets=(16,))
    codes = lock.synthesize_batch(reqs, temperature=0.7, top_k=8, seed=1)
    assert 0 < fsb.launches <= SMALL.max_dec_steps
    assert all(c.shape[1] == 8 for c in codes)
    fsb.launches = 0
    cont = ContinuousBatchingEngine(w, SMALL, n_slots=2, device="cuda", token_buckets=(16,),
                                    segment_frames=4)
    ids = [cont.submit(r, seed=2) for r in reqs]
    segments, finished = 0, {}
    while cont.pending:
        segments += 1
        finished.update(cont.step(temperature=0.7, top_k=8))
    assert sorted(finished) == ids and fsb.launches == 4 * segments


def _bounded_vs_full(monkeypatch, path: str, kernel: str, use_fused: bool):
    """Codes of an engine run with the attention bound the engine passes
    (``rows``) and with the bound at max_seq, through ``kernel``, the name of
    the bounded wrapper in the loop's module. Continuous: nine requests
    through three slots, one joining per segment, so the ring wraps."""
    w = random_magpie_weights(SMALL, seed=11)
    rng = np.random.default_rng(13)
    reqs = [[98] + [int(t) for t in rng.integers(2, 30, size=n)] + [99]
            for n in (4, 9, 6, 12, 5, 7, 3, 10, 8)]
    module = continuous_mod if path == "continuous" else magpie_mod
    real = getattr(module, kernel)
    bounds = []

    def run(full: bool):
        def launch(*a, rows=None, **k):
            bounds.append(rows)
            return real(*a, rows=None if full else rows, **k)

        monkeypatch.setattr(module, kernel, launch)
        if path == "lockstep":
            lock = BatchedMagpieEngine(w, SMALL, batch_size=3, device="cuda", token_buckets=(16,),
                                       use_fused=use_fused)
            return lock.synthesize_batch(reqs[:3], temperature=0.7, top_k=8, seed=1)
        cont = ContinuousBatchingEngine(w, SMALL, n_slots=3, device="cuda", token_buckets=(16,),
                                        segment_frames=8, use_fused=use_fused)
        ids = [cont.submit(r, seed=i) for i, r in enumerate(reqs[:3])]
        ring, finished = [], {}
        while cont.pending or len(ids) < len(reqs):
            if len(ids) < len(reqs):   # one more request per segment
                ids.append(cont.submit(reqs[len(ids)], seed=len(ids)))
            ring.append(cont.ring_p)
            finished.update(cont.step(temperature=0.0, top_k=8))
        assert any(b < a for a, b in zip(ring, ring[1:])), "the ring never wrapped"
        return [finished[i] for i in ids]

    bounded = run(full=False)
    assert any(b is not None and b < SMALL.max_seq for b in bounds)
    full = run(full=True)
    assert len(bounded) == len(full)
    for i, (got, want) in enumerate(zip(bounded, full)):
        np.testing.assert_array_equal(got, want, err_msg=f"{path} request {i}")


@pytest.mark.parametrize("path", ["continuous", "lockstep"])
def test_attention_bound_drops_no_valid_row(cuda, monkeypatch, path):
    """The host-side attention bound an engine passes kernel C (``rows``: the
    ring engine's tracked bound, lockstep's pos + 1) gives codes equal, bit
    for bit, to the same run with the bound at max_seq."""
    _bounded_vs_full(monkeypatch, path, "frame_step_batched", use_fused=True)


@pytest.mark.parametrize("path", ["continuous", "lockstep"])
def test_split_attention_bound_drops_no_valid_row(cuda, monkeypatch, path):
    """The same for the split path's batched decoder step (kernel 8)."""
    _bounded_vs_full(monkeypatch, path, "decode_step_batched", use_fused=False)


def _eos(sampled, argmax):
    return ((sampled == SMALL.audio_eos_id) | (argmax == SMALL.audio_eos_id)).any(-1)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_split_kernels_match_plain_and_fused(prepared, temperature):
    """Kernels 4 and 5 against their plain versions, and kernel 4 + the
    embedding + kernel 5 against kernel A on the same state: codes exact,
    hidden and caches to TOL."""
    w, xa_k, xa_v, st = prepared
    lts.launches = ds.launches = 0
    caches = [(st.k_cache.clone(), st.v_cache.clone()) for _ in range(3)]
    (kk, vk), (kr, vr), (kf, vf) = caches
    with torch.no_grad():
        for forbid in (True, False):
            sk, ak = lts.sample_frame_codes(st.hidden, w, SMALL, 5, temperature, 8, forbid)
            sr, ar = lts.sample_frame_codes_reference(st.hidden, w, SMALL, 5, temperature, 8,
                                                      forbid)
            assert torch.equal(sk, sr) and torch.equal(ak, ar)
        emb = magpie_mod.audio_frame_embedding(sk, w, SMALL)
        hk = ds.decode_step(emb, st.pos, xa_k, xa_v, kk, vk, w, SMALL, enc_length=6)
        hr = ds.decode_step_reference(emb, st.pos, xa_k, xa_v, kr, vr, w, SMALL, enc_length=6)
        sf, af, hf, _, _ = fs.frame_step(st.hidden, st.pos, xa_k, xa_v, kf, vf, w, SMALL, 5,
                                         temperature, 8, False, enc_length=6)
    torch.cuda.synchronize()
    assert lts.launches == 2 and ds.launches == 1
    assert torch.equal(sk, sf) and torch.equal(ak, af)
    for want in ((hr, kr, vr), (hf, kf, vf)):
        for got, ref in zip((hk, kk, vk), want):
            assert float((got - ref).abs().max()) < TOL


@pytest.mark.parametrize("B,write_row,temperature", [(3, 5, 0.0), (8, 30, 0.7), (13, 47, 0.7)])
def test_split_batched_kernels_match_plain_and_fused(cuda, B, write_row, temperature):
    """Kernels 7 and 8 against their plain versions at any B (3 and 13 are not
    multiples of 8), and kernel 7 + the embedding + kernel 8 (write row valid
    as kernel C decides it) against kernel C on the same state: codes exact,
    hidden and caches to TOL for slots with a valid row."""
    w = random_magpie_weights(SMALL, seed=11).to(device=cuda)
    x = _batched_inputs(w, B, write_row, cuda)
    caches = [(x["k_cache"].clone(), x["v_cache"].clone()) for _ in range(3)]
    (kk, vk), (kr, vr), (kf, vf) = caches
    ltsb.launches = dsb.launches = 0
    with torch.no_grad():
        sample = (x["hidden"], w, SMALL, x["seeds"], temperature, 8, x["forbid_eos"])
        sk, ak = ltsb.sample_frame_codes_batched(*sample)
        sr, ar = ltsb.sample_frame_codes_batched_reference(*sample)
        valid = x["valid"].clone()
        valid[:, write_row] = x["may_continue"] & ~_eos(sk, ak)
        x_pe = magpie_mod.audio_frame_embedding(sk, w, SMALL) + x["posemb"]
        step = (x_pe, write_row, valid, x["xa_k"], x["xa_v"])
        hk = dsb.decode_step_batched(*step, kk, vk, w, SMALL, x["enc_lengths"])
        hr = dsb.decode_step_batched_reference(*step, kr, vr, w, SMALL, x["enc_lengths"])
        fused = dict(x, k_cache=kf, v_cache=vf, weights=w, config=SMALL, temperature=temperature,
                     top_k=8)
        sf, af, hf, _, _ = fsb.frame_step_batched(**fused)
    torch.cuda.synchronize()
    assert ltsb.launches == 1 and dsb.launches == 1
    assert torch.equal(sk, sr) and torch.equal(ak, ar)
    assert torch.equal(sk, sf) and torch.equal(ak, af)
    live = slice(0, B - 1)
    for want in ((hr, kr, vr), (hf, kf, vf)):
        for got, ref in zip((hk, kk, vk), want):
            assert float((got[live] - ref[live]).abs().max()) < TOL
            assert torch.isfinite(got).all()


def test_split_paths_go_through_the_kernels(prepared):
    """use_fused=False: kernels 4 and 5 once per loop iteration, kernels 7 and
    8 once per lockstep frame and per continuous segment frame; kernels A and
    C never."""
    w, xa_k, xa_v, st = prepared
    for m in (fs, fsb, lts, ds, ltsb, dsb):
        m.launches = 0
    with torch.no_grad():
        out = magpie_mod.decode_loop(xa_k, xa_v, st, 6, w, SMALL, (0, 3), 0.7, 8,
                                     use_fused=False)
    steps = out.frame_idx + (1 if out.done else 0)
    assert lts.launches == ds.launches == steps and fs.launches == 0
    rng = np.random.default_rng(5)
    reqs = [[98] + [int(t) for t in rng.integers(2, 30, size=n)] + [99] for n in (4, 9, 6)]
    lock = BatchedMagpieEngine(w, SMALL, batch_size=3, device="cuda", token_buckets=(16,),
                               use_fused=False)
    lock.synthesize_batch(reqs, temperature=0.7, top_k=8, seed=1)
    assert 0 < ltsb.launches == dsb.launches <= SMALL.max_dec_steps
    ltsb.launches = dsb.launches = 0
    cont = ContinuousBatchingEngine(w, SMALL, n_slots=2, device="cuda", token_buckets=(16,),
                                    segment_frames=4, use_fused=False)
    ids = [cont.submit(r, seed=2) for r in reqs]
    segments, finished = 0, {}
    while cont.pending:
        segments += 1
        finished.update(cont.step(temperature=0.7, top_k=8))
    assert sorted(finished) == ids
    assert ltsb.launches == dsb.launches == 4 * segments and fsb.launches == 0


def test_split_wrappers_reject_bad_inputs(cuda):
    w = random_magpie_weights(SMALL, seed=11).to(device=cuda)
    D = SMALL.d_model
    with pytest.raises(ValueError):   # hidden must be float32
        lts.sample_frame_codes(torch.zeros(D, device=cuda, dtype=torch.float64), w, SMALL, 1,
                               0.0, 8, False)
    x = _batched_inputs(w, 2, 5, cuda)
    with pytest.raises(ValueError):   # caches must be [L, max_seq, d_model]
        ds.decode_step(x["hidden"][0], 9, x["xa_k"][0], x["xa_v"][0], x["k_cache"][0][:, :10],
                       x["v_cache"][0], w, SMALL)
    with pytest.raises(ValueError):   # pos past the cache
        ds.decode_step(x["hidden"][0], SMALL.max_seq, x["xa_k"][0], x["xa_v"][0],
                       x["k_cache"][0], x["v_cache"][0], w, SMALL)
    with pytest.raises(ValueError):   # seeds must be int32
        ltsb.sample_frame_codes_batched(x["hidden"], w, SMALL, x["seeds"].long(), 0.0, 8,
                                        x["forbid_eos"])
    with pytest.raises(ValueError):   # valid must be bool
        dsb.decode_step_batched(x["hidden"], 5, x["valid"].to(torch.int32), x["xa_k"],
                                x["xa_v"], x["k_cache"], x["v_cache"], w, SMALL,
                                x["enc_lengths"])
    with pytest.raises(ValueError):   # at most 64 slots
        ltsb.sample_frame_codes_batched(torch.zeros(65, D, device=cuda), w, SMALL,
                                        torch.zeros(65, dtype=torch.int32, device=cuda), 0.0,
                                        8, torch.zeros(65, dtype=torch.bool, device=cuda))


def test_wrappers_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        cc.snake_causal_conv(torch.zeros(8, 4, device=cuda, dtype=torch.float64),
                             torch.zeros(3, 4, 4, device=cuda), torch.zeros(4, device=cuda),
                             None)
    with pytest.raises(ValueError):
        cc.snake_causal_conv(torch.zeros(8, 4, device=cuda), torch.zeros(3, 5, 4, device=cuda),
                             torch.zeros(4, device=cuda), None)
    w = random_magpie_weights(SMALL, seed=11).to(device=cuda)
    x = _batched_inputs(w, 2, 5, cuda)
    x["valid"] = x["valid"].to(torch.int32)          # must be bool
    with pytest.raises(ValueError):
        fsb.frame_step_batched(weights=w, config=SMALL, temperature=0.0, top_k=8, **x)
