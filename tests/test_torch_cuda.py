"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, and the decode loop / codec through the kernels, at small shapes.

Every test here needs a CUDA device and skips without one. This file imports
neither jax nor the JAX package, so it also runs where jax is not installed:
    MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q -m cuda
(``MAGPIE_TEST_TPU=1`` keeps tests/conftest.py from importing jax.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.config import CodecConfig, MagpieConfig
from magpie_tts_tpu_torch.io.codec_weights import ResBlockWeights, random_codec_weights
from magpie_tts_tpu_torch.io.magpie_weights import (q8_dequantized_decoder, q8_stream_from_arrays,
                                                     quantize_decoder_stream, random_magpie_weights)
from magpie_tts_tpu_torch.models import magpie as magpie_mod
from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
from magpie_tts_tpu_torch.ops.kernels import codec_res_fused as crf
from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts
from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
from magpie_tts_tpu_torch.ops.kernels import q8_dequant
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
    with pytest.raises(ValueError):   # at least one slot (65 run as two slot groups)
        ltsb.sample_frame_codes_batched(torch.zeros(0, D, device=cuda), w, SMALL,
                                        torch.zeros(0, dtype=torch.int32, device=cuda), 0.0,
                                        8, torch.zeros(0, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):   # at most 64 slots a launch
        fsb.launch("magpie_lt_sample_batched_f32", 65, {}, {}, SMALL, cuda)


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


# ------------------------------------------------ quantized weight streams

@pytest.mark.parametrize("torch_shape,transform,lead", [
    ((40, 64), "linear", (3,)), ((96, 32, 1), "conv1", ()), ((64, 40, 3), "conv_ffn", (2,)),
    ((2024, 768), "linear", ())])
def test_q8_dequant_kernel_matches_plain(cuda, torch_shape, transform, lead):
    """Kernel 10 against its plain version, bit for bit, for each loader
    transform (edges that are not multiples of the 32 x 32 tile included)."""
    rng = np.random.default_rng(len(lead))
    n_blocks = int(np.prod(torch_shape)) // 32
    q = torch.tensor(rng.integers(-127, 128, (*lead, n_blocks, 32)), dtype=torch.int8,
                     device=cuda)
    s = torch.tensor(rng.normal(0, 0.01, (*lead, n_blocks, 1)).astype(np.float16),
                     dtype=torch.float32, device=cuda)
    q8_dequant.launches = 0
    got = q8_dequant.dequantize(q, s, torch_shape, transform)
    want = q8_dequant.dequantize_reference(q, s, torch_shape, transform)
    torch.cuda.synchronize()
    assert q8_dequant.launches == 1 and got.shape == want.shape and torch.equal(got, want)


def _streams(w):
    """(Q8 stream, weights whose decoder holds its dequantized matrices,
    int8 stream) on w's device."""
    q8 = q8_stream_from_arrays(w.decoder).to(w.text_emb.device)
    deq = dataclasses.replace(w, decoder=q8_dequantized_decoder(w.decoder, q8))
    return q8, deq, quantize_decoder_stream(w.decoder)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_single_stream_kernels_q8_bit_equal_dense_int8_match_plain(prepared, temperature):
    """Kernels A and 5: with the Q8 stream, bit-equal to the same kernel dense
    on the dequantized weights (codes, hidden, caches); with the int8 stream,
    codes exact against the plain int8 version, floats to TOL."""
    w, xa_k, xa_v, st = prepared
    q8, deq, int8 = _streams(w)
    args = dict(hidden=st.hidden, pos=st.pos, xa_k=xa_k, xa_v=xa_v, config=SMALL, seed=5,
                temperature=temperature, top_k=8, forbid_eos=False, enc_length=6)
    codes = torch.arange(8, dtype=torch.int32, device=st.hidden.device) * 3
    emb = magpie_mod.audio_frame_embedding(codes, w, SMALL)
    dec = dict(x=emb, pos=st.pos, xa_k=xa_k, xa_v=xa_v, config=SMALL, enc_length=6)
    runs = {}
    for name, (weights, stream, fn_a, fn_5) in {
            "q8": (deq, q8, fs.frame_step, ds.decode_step),
            "dense": (deq, None, fs.frame_step, ds.decode_step),
            "int8": (w, int8, fs.frame_step, ds.decode_step),
            "int8_plain": (w, int8, fs.frame_step_reference, ds.decode_step_reference)}.items():
        ka, va, k5, v5 = (st.k_cache.clone() for _ in range(4))
        with torch.no_grad():
            sa, aa, ha, _, _ = fn_a(k_cache=ka, v_cache=va, weights=weights, stream=stream, **args)
            h5 = fn_5(k_cache=k5, v_cache=v5, weights=weights, stream=stream, **dec)
        runs[name] = (sa, aa, ha, ka, va, h5, k5, v5)
    torch.cuda.synchronize()
    assert _same(runs["q8"], runs["dense"])
    got, want = runs["int8"], runs["int8_plain"]
    assert _same(got[:2], want[:2])
    for a, b in zip(got[2:], want[2:]):
        assert float((a - b).abs().max()) < TOL
    assert fs.mode_launches["q8"] >= 1 and ds.mode_launches["int8"] >= 1


@pytest.mark.parametrize("B,write_row,temperature", [(3, 5, 0.0), (8, 30, 0.7)])
def test_batched_kernels_q8_bit_equal_dense_int8_match_plain(cuda, B, write_row, temperature):
    """Kernels C and 8 with ring masks: the Q8 stream bit-equal to the dense
    kernel on the dequantized weights; the int8 stream's codes exact against
    plain, floats to TOL on slots with a valid row."""
    w = random_magpie_weights(SMALL, seed=11).to(device=cuda)
    q8, deq, int8 = _streams(w)
    x = _batched_inputs(w, B, write_row, cuda)
    k0, v0 = x.pop("k_cache"), x.pop("v_cache")
    valid8 = x["valid"].clone()
    valid8[:, write_row] = x["may_continue"]
    x_pe = x["hidden"] * 0.1 + x["posemb"]
    runs = {}
    for name, (weights, stream, fn_c, fn_8) in {
            "q8": (deq, q8, fsb.frame_step_batched, dsb.decode_step_batched),
            "dense": (deq, None, fsb.frame_step_batched, dsb.decode_step_batched),
            "int8": (w, int8, fsb.frame_step_batched, dsb.decode_step_batched),
            "int8_plain": (w, int8, fsb.frame_step_batched_reference,
                           dsb.decode_step_batched_reference)}.items():
        kc, vc, k8, v8 = k0.clone(), v0.clone(), k0.clone(), v0.clone()
        with torch.no_grad():
            sc, ac, hc, _, _ = fn_c(k_cache=kc, v_cache=vc, weights=weights, config=SMALL,
                                    temperature=temperature, top_k=8, stream=stream, **x)
            h8 = fn_8(x_pe, write_row, valid8, x["xa_k"], x["xa_v"], k8, v8, weights, SMALL,
                      x["enc_lengths"], stream=stream)
        runs[name] = (sc, ac, hc, kc, vc, h8, k8, v8)
    torch.cuda.synchronize()
    assert _same(runs["q8"], runs["dense"])
    got, want = runs["int8"], runs["int8_plain"]
    assert _same(got[:2], want[:2])
    live = slice(0, B - 1)
    for a, b in zip(got[2:], want[2:]):
        assert float((a[live] - b[live]).abs().max()) < TOL


def test_stream_wrappers_reject_bad_streams(prepared):
    w, xa_k, xa_v, st = prepared
    q8, _, int8 = _streams(w)
    args = (st.hidden, st.pos, xa_k, xa_v, st.k_cache.clone(), st.v_cache.clone(), w, SMALL, 5,
            0.0, 8, False)
    with pytest.raises(TypeError):     # not a stream
        fs.frame_step(*args, stream=w.decoder)
    with pytest.raises(ValueError):    # stream on the CPU
        fs.frame_step(*args, stream=int8.to("cpu"))
    with pytest.raises(ValueError):    # values must be int8
        fs.frame_step(*args, stream=dataclasses.replace(q8, qkv_q=q8.qkv_q.float()))
    with pytest.raises(ValueError):    # block scales [L, K / 32, N]
        fs.frame_step(*args, stream=dataclasses.replace(q8, ff_out_bs=q8.ff_out_bs[:, :1]))


# ------------------------------------------------------------- bfloat16

BF = torch.bfloat16


def _scaled_ulps(got, want):
    """|got - want| in bf16 ulps of max(|want|, its row's RMS) (as
    chip_smoke.scaled_ulps)."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt() if w.shape[-1] > 1 else w.abs()
    ref = torch.maximum(w.abs(), rms).clamp_min(1e-30)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(ref)) - 7)


def _bf16_close(pairs, share=0.95, most=8.0):
    """The bf16 frame kernels' bar (chip_smoke.ULP_SHARE / ULP_MAX): the
    float32 sums run in another order than torch's and the decoder's later
    roundings spread a one-ulp step, so 95% within 1 scaled ulp, none past 8."""
    d = torch.cat([_scaled_ulps(a, b).flatten() for a, b in pairs])
    assert float((d <= 1).float().mean()) >= share and float(d.max()) <= most, \
        (float((d <= 1).float().mean()), float(d.max()))


@pytest.fixture
def prepared_bf16(cuda):
    w = random_magpie_weights(SMALL, seed=11).to(device=cuda, dtype=BF)
    tokens = torch.tensor(np.random.default_rng(7).integers(2, 96, size=8), device=cuda)
    with torch.no_grad():
        xa_k, xa_v, st = magpie_mod.prepare(tokens, 6, 0, w, SMALL)
    return w, xa_k, xa_v, st


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_bf16_single_stream_kernels_match_plain(prepared_bf16, temperature):
    """Kernels A, 4 and 5 in bf16 against their plain versions: codes exact,
    hidden and the new K/V row within the bf16 bar; every launch counted as
    bfloat16."""
    w, xa_k, xa_v, st = prepared_bf16
    for m in (fs, lts, ds):
        m.dtype_launches = dict.fromkeys(m.dtype_launches, 0)
    (kk, vk), (kr, vr), (k5, v5), (k5r, v5r) = [(st.k_cache.clone(), st.v_cache.clone())
                                                for _ in range(4)]
    args = dict(seed=5, temperature=temperature, top_k=8, forbid_eos=False, enc_length=6)
    with torch.no_grad():
        sk, ak, hk, _, _ = fs.frame_step(st.hidden, st.pos, xa_k, xa_v, kk, vk, w, SMALL, **args)
        sr, ar, hr, _, _ = fs.frame_step_reference(st.hidden, st.pos, xa_k, xa_v, kr, vr, w,
                                                   SMALL, **args)
        s4, a4 = lts.sample_frame_codes(st.hidden, w, SMALL, 5, temperature, 8, False)
        emb = magpie_mod.audio_frame_embedding(sr, w, SMALL)
        h5 = ds.decode_step(emb, st.pos, xa_k, xa_v, k5, v5, w, SMALL, enc_length=6)
        h5r = ds.decode_step_reference(emb, st.pos, xa_k, xa_v, k5r, v5r, w, SMALL, enc_length=6)
    torch.cuda.synchronize()
    assert hk.dtype == h5.dtype == BF
    assert torch.equal(sk, sr) and torch.equal(ak, ar)
    assert torch.equal(s4, sr) and torch.equal(a4, ar)
    p = st.pos
    _bf16_close(((hk, hr), (kk[:, p], kr[:, p]), (vk[:, p], vr[:, p])))
    _bf16_close(((h5, h5r), (k5[:, p], k5r[:, p]), (v5[:, p], v5r[:, p])))
    assert fs.dtype_launches == {"float32": 0, "bfloat16": 1}
    assert lts.dtype_launches == ds.dtype_launches == {"float32": 0, "bfloat16": 1}


@pytest.mark.parametrize("B,write_row,temperature", [(8, 30, 0.0), (32, 47, 0.7)])
def test_bf16_batched_kernels_match_plain(cuda, B, write_row, temperature):
    """Kernels C, 7 and 8 in bf16 at B = 8 and 32 with ring masks: codes
    exact, hidden and new K/V rows of the live slots within the bf16 bar."""
    w = random_magpie_weights(SMALL, seed=11).to(device=cuda, dtype=BF)
    x = _batched_inputs(w, B, write_row, cuda)
    for key in ("hidden", "xa_k", "xa_v", "k_cache", "v_cache"):
        x[key] = x[key].to(BF)
    (kk, vk), (kr, vr), (k8, v8), (k8r, v8r) = [(x["k_cache"].clone(), x["v_cache"].clone())
                                                for _ in range(4)]
    del x["k_cache"], x["v_cache"]
    args = dict(x, weights=w, config=SMALL, temperature=temperature, top_k=8)
    with torch.no_grad():
        sk, ak, hk, _, _ = fsb.frame_step_batched(k_cache=kk, v_cache=vk, **args)
        sr, ar, hr, _, _ = fsb.frame_step_batched_reference(k_cache=kr, v_cache=vr, **args)
        sample = (x["hidden"], w, SMALL, x["seeds"], temperature, 8, x["forbid_eos"])
        s7, a7 = ltsb.sample_frame_codes_batched(*sample)
        valid = x["valid"].clone()
        valid[:, write_row] = x["may_continue"] & ~_eos(sr, ar)
        step = (magpie_mod.audio_frame_embedding(sr, w, SMALL) + x["posemb"], write_row, valid,
                x["xa_k"], x["xa_v"])
        h8 = dsb.decode_step_batched(*step, k8, v8, w, SMALL, x["enc_lengths"])
        h8r = dsb.decode_step_batched_reference(*step, k8r, v8r, w, SMALL, x["enc_lengths"])
    torch.cuda.synchronize()
    assert torch.equal(sk, sr) and torch.equal(ak, ar)
    assert torch.equal(s7, sr) and torch.equal(a7, ar)
    live, r = slice(0, B - 1), write_row
    _bf16_close(((hk[live], hr[live]), (kk[live, :, r], kr[live, :, r]),
                 (vk[live, :, r], vr[live, :, r])))
    _bf16_close(((h8[live], h8r[live]), (k8[live, :, r], k8r[live, :, r]),
                 (v8[live, :, r], v8r[live, :, r])))


@pytest.mark.parametrize("cin,cout,k,d,residual,act", [
    (32, 64, 7, 1, False, False), (54, 54, 11, 5, False, True), (108, 108, 7, 3, True, True),
    (27, 1, 3, 1, False, True)])
def test_bf16_conv_kernel_matches_plain(cuda, cin, cout, k, d, residual, act):
    """Kernel B in bf16 (one rounding per output): every value within 1
    scaled bf16 ulp of the plain version."""
    rng = np.random.default_rng(cin)
    bf = lambda *shape, s=0.5: torch.tensor(rng.normal(0, s, shape), dtype=BF, device=cuda)
    x, wt, b = bf(2, 500, cin), bf(k, cin, cout, s=0.1), bf(cout, s=1.0)
    alpha = torch.tensor(rng.uniform(0.4, 1.4, cin // 2), dtype=BF, device=cuda) if act else None
    r = bf(2, 500, cout) if residual else None
    cc.dtype_launches = dict.fromkeys(cc.dtype_launches, 0)
    got = cc.snake_causal_conv(x, wt, b, alpha, d, 0.01, residual=r)
    want = cc.snake_causal_conv_reference(x, wt, b, alpha, d, 0.01, r)
    torch.cuda.synchronize()
    assert got.dtype == BF and cc.dtype_launches == {"float32": 0, "bfloat16": 1}
    d_ulps = _scaled_ulps(got, want) if cout > 1 else _scaled_ulps(got.flatten(), want.flatten())
    assert float(d_ulps.max()) <= 1.0


@pytest.mark.parametrize("torch_shape,transform,lead", [
    ((40, 64), "linear", (3,)), ((96, 32, 1), "conv1", ()), ((64, 40, 3), "conv_ffn", (2,))])
def test_bf16_q8_dequant_kernel_matches_plain(cuda, torch_shape, transform, lead):
    """Kernel 10 writing bf16: bit-equal to its plain version and to the
    float32 dequant rounded to bf16."""
    rng = np.random.default_rng(len(lead) + 7)
    n_blocks = int(np.prod(torch_shape)) // 32
    q = torch.tensor(rng.integers(-127, 128, (*lead, n_blocks, 32)), dtype=torch.int8,
                     device=cuda)
    s = torch.tensor(rng.normal(0, 0.01, (*lead, n_blocks, 1)).astype(np.float16),
                     dtype=torch.float32, device=cuda)
    got = q8_dequant.dequantize(q, s, torch_shape, transform, BF)
    want = q8_dequant.dequantize_reference(q, s, torch_shape, transform, BF)
    f32 = q8_dequant.dequantize(q, s, torch_shape, transform)
    torch.cuda.synchronize()
    assert got.dtype == BF and torch.equal(got, want) and torch.equal(got, f32.to(BF))


def test_bf16_streams_q8_bit_equal_dense_int8_match_plain(prepared_bf16):
    """Kernels A and 5 in bf16 with the Q8 stream bit-equal to the dense
    kernel on the weights dequantized in bf16; the int8 stream against plain."""
    w, xa_k, xa_v, st = prepared_bf16
    q8 = q8_stream_from_arrays(w.decoder).to(st.hidden.device)
    dec = q8_dequantized_decoder(w.decoder, q8)
    dec = dataclasses.replace(dec, qkv=dec.qkv.to(BF), sa_out=dec.sa_out.to(BF),
                              ff_proj=dec.ff_proj.to(BF), ff_out=dec.ff_out.to(BF))
    deq = dataclasses.replace(w, decoder=dec)
    int8 = quantize_decoder_stream(w.decoder)
    runs = {}
    for name, (weights, stream, fn) in {"q8": (deq, q8, fs.frame_step),
                                        "dense": (deq, None, fs.frame_step),
                                        "int8": (w, int8, fs.frame_step),
                                        "int8_plain": (w, int8, fs.frame_step_reference)}.items():
        k, v = st.k_cache.clone(), st.v_cache.clone()
        with torch.no_grad():
            out = fn(st.hidden, st.pos, xa_k, xa_v, k, v, weights, SMALL, 5, 0.7, 8, False,
                     enc_length=6, stream=stream)
        runs[name] = (*out[:3], k[:, st.pos], v[:, st.pos])
    torch.cuda.synchronize()
    assert _same(runs["q8"], runs["dense"])
    assert _same(runs["int8"][:2], runs["int8_plain"][:2])
    _bf16_close(list(zip(runs["int8"][2:], runs["int8_plain"][2:])))


def test_bf16_paths_launch_only_bf16_kernels(prepared_bf16):
    """A bf16 decode loop (fused and split), lockstep and continuous engine:
    every launch of every wrapper is a bfloat16 one."""
    w, xa_k, xa_v, st = prepared_bf16
    mods = (fs, lts, ds, fsb, ltsb, dsb)
    for m in mods:
        m.dtype_launches = dict.fromkeys(m.dtype_launches, 0)
    with torch.no_grad():
        for fused in (True, False):
            s = dataclasses.replace(st, k_cache=st.k_cache.clone(), v_cache=st.v_cache.clone(),
                                    codes=st.codes.copy())
            magpie_mod.decode_loop(xa_k, xa_v, s, 6, w, SMALL, (0, 3), 0.7, 8, use_fused=fused)
    rng = np.random.default_rng(5)
    reqs = [[98] + [int(t) for t in rng.integers(2, 30, size=n)] + [99] for n in (4, 9, 6)]
    wf = random_magpie_weights(SMALL, seed=11)
    for fused in (True, False):
        BatchedMagpieEngine(wf, SMALL, batch_size=3, device="cuda", compute_dtype=BF,
                            token_buckets=(16,), use_fused=fused).synthesize_batch(
            reqs, temperature=0.7, top_k=8, seed=1)
        cont = ContinuousBatchingEngine(wf, SMALL, n_slots=2, device="cuda", compute_dtype=BF,
                                        token_buckets=(16,), segment_frames=4, use_fused=fused)
        cont.synthesize_all(reqs, temperature=0.7, top_k=8)
    torch.cuda.synchronize()
    for m in mods:
        assert m.dtype_launches["float32"] == 0 and m.dtype_launches["bfloat16"] > 0, m.__name__


def test_wrappers_reject_other_dtypes(prepared_bf16):
    """float16 (not a compute dtype) raises in every wrapper; so does a bf16
    row with float32 weights (no conversion, no fallback)."""
    w, xa_k, xa_v, st = prepared_bf16
    dev = st.hidden.device
    with pytest.raises(ValueError):
        fs.frame_step(st.hidden.half(), st.pos, xa_k, xa_v, st.k_cache, st.v_cache, w, SMALL,
                      5, 0.0, 8, False)
    with pytest.raises(ValueError):
        lts.sample_frame_codes(st.hidden, random_magpie_weights(SMALL, seed=1).to(device=dev),
                               SMALL, 1, 0.0, 8, False)
    with pytest.raises(ValueError):
        ds.decode_step(st.hidden, st.pos, xa_k.float(), xa_v.float(), st.k_cache, st.v_cache, w,
                       SMALL)
    with pytest.raises(ValueError):
        cc.snake_causal_conv(torch.zeros(1, 8, 4, device=dev, dtype=torch.float16),
                             torch.zeros(3, 4, 4, device=dev, dtype=torch.float16),
                             torch.zeros(4, device=dev, dtype=torch.float16), None)
    with pytest.raises(ValueError):
        cc.snake_causal_conv(torch.zeros(1, 8, 4, device=dev, dtype=BF),
                             torch.zeros(3, 4, 4, device=dev), torch.zeros(4, device=dev), None)
    with pytest.raises(ValueError):
        q8_dequant.dequantize(torch.zeros(1, 32, dtype=torch.int8, device=dev),
                              torch.ones(1, 1, device=dev), (1, 32), "linear", torch.float16)


# ------------------------------------------------ kernel 9: the fused res layer

PROD_CODEC = CodecConfig()
# bf16 in scaled ulps: each of a branch's 6 convs rounds to bf16, and float32
# sums in another order than torch's move a rounding by one ulp now and then,
# which the later convs spread. Measured on an H100: 94.95% within 1 ulp at
# C = 108, T = 1000, where the frame kernels' 95% bar failed; none past 8.
BF16_ULP_SHARE, BF16_ULP_MAX = 0.90, 8


def _fused_layer(dev, stage: int, dtype=torch.float32):
    cw = random_codec_weights(PROD_CODEC, seed=3).to(device=dev, dtype=dtype)
    return crf.stack_res_layer(cw.stages[stage].resblocks, PROD_CODEC.resblock_dilations)


def _scaled_ulps(got, want):
    g, w = got.float(), want.float()
    ref = torch.maximum(w.abs(), w.pow(2).mean(-1, keepdim=True).sqrt()).clamp_min(1e-30)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(ref)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("stage,n,T", [(2, 1, 1000), (3, 3, 515), (4, 1, 100), (4, 3, 64)])
def test_res_layer_fused_kernel_matches_plain(cuda, dtype, stage, n, T):
    """Kernel 9 against its plain version at the codec's C = 108 / 54 / 27:
    N = 1 and 3 (decode_batch), T not a multiple of the tile, T below the
    halo (120). float32 within 1e-5 of the largest value; bf16 in scaled
    ulps. Any tile gives the same bits."""
    layer = _fused_layer(cuda, stage, dtype)
    gen = torch.Generator(device=cuda).manual_seed(T)
    x = (torch.randn(n, T, layer.channels, generator=gen, device=cuda) * 0.5).to(dtype)
    crf.launches = 0
    got = crf.res_layer_fused(x, layer)
    want = crf.res_layer_fused_reference(x, layer)
    assert crf.launches == 1 and got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    else:
        u = _scaled_ulps(got, want)
        assert float((u <= 1).float().mean()) >= BF16_ULP_SHARE and float(u.max()) <= BF16_ULP_MAX
    assert torch.equal(crf.res_layer_fused(x, layer, tile=8), got)


def test_res_layer_fused_rejects_bad_inputs(cuda):
    """float16, a dtype mix, C > 128 and a layer left on the CPU raise."""
    layer = _fused_layer(cuda, 4)
    x = torch.zeros(1, 16, 27, device=cuda)
    with pytest.raises(ValueError):
        crf.res_layer_fused(x.half(), layer)
    with pytest.raises(ValueError):
        crf.res_layer_fused(x.to(BF), layer)
    with pytest.raises(ValueError):
        crf.res_layer_fused(x, _fused_layer("cpu", 4))
    z = lambda *shape: torch.zeros(*shape, device=cuda)
    wide_layer = crf.stack_res_layer(
        [[ResBlockWeights(z(65), z(k, 130, 130), z(130), z(65), z(k, 130, 130), z(130))] * 3
         for k in (3, 7, 11)], PROD_CODEC.resblock_dilations)
    with pytest.raises(ValueError):
        crf.res_layer_fused(torch.zeros(1, 16, 130, device=cuda), wide_layer)


@pytest.mark.parametrize("fused", [False, True])
def test_streamed_window_rows_equal_offline_rows(cuda, monkeypatch, fused):
    """A streaming window [base, base + 36) at full codec width: the rows of
    its last 4 frames (after 32 context frames) are bit-equal to the offline
    decode's rows, through kernel B alone and with kernel 9 (every kernel
    computes a row by the same arithmetic wherever the window starts)."""
    if fused:
        monkeypatch.setenv("MAGPIE_FUSED_CODEC", "1")
    codec = engine_mod.CodecEngine(random_codec_weights(PROD_CODEC, seed=1), PROD_CODEC,
                                   device="cuda")
    codes = np.random.default_rng(4).integers(0, 2016, size=(60, 8)).astype(np.int32)
    crf.launches = 0
    offline = codec.decode(codes)
    hop = PROD_CODEC.hop_length
    for base in (0, 7, 24):
        window = codec.decode(codes[base:base + 36], bucket=False)
        np.testing.assert_array_equal(window[32 * hop:],
                                      offline[(base + 32) * hop:(base + 36) * hop])
    assert crf.launches == (12 if fused else 0)


def test_fused_codec_goes_through_kernel_9(cuda, monkeypatch):
    """MAGPIE_FUSED_CODEC on the small codec (every stage <= 128 channels):
    5 fused launches and the pre- and post-conv per decode, none of the 90
    res-block convs through kernel B; decode_batch launches once per layer."""
    monkeypatch.setenv("MAGPIE_FUSED_CODEC", "1")
    codec = engine_mod.CodecEngine(random_codec_weights(SMALL_CODEC, seed=1), SMALL_CODEC,
                                   device="cuda")
    codes = np.random.default_rng(2).integers(0, 32, size=(9, 8)).astype(np.int32)
    crf.launches = cc.launches = 0
    audio = codec.decode(codes)
    assert (crf.launches, cc.launches) == (5, 2) and np.all(np.isfinite(audio))
    codec.decode_batch([codes, codes[:4], codes[:2]])
    assert (crf.launches, cc.launches) == (10, 4)


# ---------------------------------------------- the H100 probes (kernels 11-18)

from magpie_tts_tpu_torch.ops.kernels import probe_attend, probe_copy, probe_gemv  # noqa: E402
from magpie_tts_tpu_torch.scripts import (opt_attend_probe, opt_int8_attend_probe,  # noqa: E402
                                          opt_launch_probe, opt_slope_probe, probe_int4, timing)


@pytest.mark.parametrize("fmt", probe_gemv.FORMATS)
def test_probe_gemv_kernel_matches_plain(cuda, fmt):
    """Kernels 11-13 at the probe's shapes: the nibble formats bit-equal to
    plain (x = ones, and small integer x: every sum an exact integer), bf16
    within 1e-5 of the largest value (float32 sums in another order)."""
    x, w, _, _ = probe_int4.make_inputs(cuda)[fmt]
    xs = [x]
    if fmt != "bf16":
        xi = np.random.default_rng(2).integers(-3, 4, size=tuple(x.shape)).astype(np.float32)
        xs.append(torch.from_numpy(xi).to(device=cuda, dtype=BF))
    else:
        xs.append(torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(2),
                              device=cuda).to(BF))
    for xx in xs:
        got, want = probe_gemv.gemv(xx, w, fmt), probe_gemv.gemv_reference(xx, w, fmt)
        torch.cuda.synchronize()
        if fmt == "bf16":
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("rows", [320, 640])
@pytest.mark.parametrize("mode", probe_attend.MODES)
def test_probe_attend_kernel_matches_plain(cuda, mode, rows, iters):
    """Kernels 14 and 18 against plain within 5e-4 of the largest value."""
    if mode in ("bf16", "i8mixed", "i8cast"):
        x = opt_int8_attend_probe.inputs_for(mode, opt_int8_attend_probe.make_inputs(cuda))
    else:
        x = opt_attend_probe.make_inputs(cuda)
    args = [x[n] for n in ("q", "k", "v", "sk", "sv")]
    got = probe_attend.attend(*args, rows, iters, mode)
    want = probe_attend.attend_reference(*args, rows, iters, mode)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 5e-4 * float(want.abs().max())


def _probe_attend_args(mode: str, device, slots=None) -> list:
    if mode in ("bf16", "i8mixed", "i8cast"):
        x = opt_int8_attend_probe.inputs_for(mode, opt_int8_attend_probe.make_inputs(device))
    else:
        x = opt_attend_probe.make_inputs(device)
    args = [x[n] for n in ("q", "k", "v", "sk", "sv")]
    if slots is not None:
        args = [None if a is None else a[slots].contiguous() for a in args]
    return args


def _probe_attend_close(got, want) -> bool:
    return float((got.cpu() - want.cpu()).abs().max()) <= 5e-4 * float(want.abs().max())


@pytest.mark.parametrize("rows", [1, 63, 65, 639])
@pytest.mark.parametrize("mode", probe_attend.MODES)
def test_probe_attend_kernel_ragged_rows(cuda, mode, rows):
    """Rows that are not a multiple of the plan's chunk, against plain within
    5e-4 of the largest value."""
    args = _probe_attend_args(mode, cuda)
    got = probe_attend.attend(*args, rows, 1, mode)
    torch.cuda.synchronize()
    assert _probe_attend_close(got, probe_attend.attend_reference(*args, rows, 1, mode))


@pytest.mark.parametrize("rows", [320, 640])
@pytest.mark.parametrize("mode", probe_attend.MODES)
def test_probe_attend_kernel_matches_chunked_model(cuda, mode, rows):
    """The kernel against the CPU model of its arithmetic (chunk partials in
    chunk order), 5e-4 of the largest value (expf differs by an ulp between
    the card and the CPU, which can move a bf16 probability)."""
    args = _probe_attend_args(mode, cuda)
    got = probe_attend.attend(*args, rows, 1, mode)
    torch.cuda.synchronize()
    assert _probe_attend_close(got, probe_attend.chunked_model(*args, rows, mode))


@pytest.mark.parametrize("mode", probe_attend.MODES)
def test_probe_attend_slot_bits_do_not_depend_on_the_slot_count(cuda, mode):
    """Slots 0 and 5 alone (G = 1) give the bits they give among 8 slots."""
    many = probe_attend.attend(*_probe_attend_args(mode, cuda), 640, 1, mode)
    for b in (0, 5):
        one = probe_attend.attend(*_probe_attend_args(mode, cuda, slice(b, b + 1)), 640, 1, mode)
        torch.cuda.synchronize()
        assert torch.equal(one[0], many[b])


@pytest.mark.parametrize("mode", probe_attend.MODES)
def test_probe_attend_more_blocks_than_the_card_holds(cuda, mode):
    """G = 64 at 640 rows: more blocks than the card holds at once (the
    clusters run in waves; cur's blocks loop over items, later items copying
    their V in phase 2). Against plain, and slot 3 bit-equal to the same
    slot at G = 8."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    big = [a.repeat(8, *([1] * (a.dim() - 1))) if a is not None else None
           for a in _probe_attend_args(mode, cuda)]
    big[1] = big[1].roll(1, dims=0).contiguous()  # slots differ from their copies
    if mode not in probe_attend.INT8_MODES:
        big[2] = (big[2].float() + 0.01 * torch.randn(big[2].shape, generator=gen,
                                                      device=cuda)).to(BF)
    got = probe_attend.attend(*big, 640, 1, mode)
    want = probe_attend.attend_reference(*big, 640, 1, mode)
    few = probe_attend.attend(*[None if a is None else a[:8].contiguous() for a in big], 640, 1,
                              mode)
    torch.cuda.synchronize()
    assert _probe_attend_close(got, want) and torch.equal(got[3], few[3])


@pytest.mark.parametrize("mode", probe_attend.MODES)
def test_probe_attend_phase_stamps(cuda, mode):
    """Every block stamps its six phases in order; the stamped launch adds
    the same attend as an ordinary one."""
    args = _probe_attend_args(mode, cuda)
    st = probe_attend.attend_stamps(*args, 640, mode).cpu()
    st = st[st[:, 0] > 0]
    assert st.shape[0] == probe_attend.plan_attend(mode).blocks(8, 12, 640)
    assert bool((st[:, 1:] >= st[:, :-1]).all())
    ph = probe_attend.read_phases(st)
    assert 0 < ph["end_last_us"] < 1e5 and ph["blocks"] == st.shape[0]


@pytest.mark.parametrize("mode", probe_attend.MODES)
def test_probe_attend_graph_replays_are_stable(cuda, mode):
    """One launch captured in a CUDA graph (the output zeroed, then the
    attend added) and replayed 50 times gives the eager launch's bits every
    time: no ticket or barrier word is left stale by a replay."""
    args = _probe_attend_args(mode, cuda)
    out = torch.zeros(8, 768, device=cuda)
    probe_attend.attend_accumulate(out, *args, 640, mode)
    torch.cuda.synchronize()
    eager = out.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.zero_()
        probe_attend.attend_accumulate(out, *args, 640, mode)
    for _ in range(50):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    del graph


@pytest.mark.parametrize("grid_n,variant", [(1, "minimal"), (8, "minimal"), (20, "minimal"),
                                            (8, "constblk"), (8, "streamed"), (3, "streamed")])
def test_probe_copy_kernel_bit_equal_plain(cuda, grid_n, variant):
    """Kernels 15-17: chained launches and every block's checksum bit-equal
    to plain (at grid 8 from zeros, 764 after 100 launches)."""
    gen = torch.Generator(device=cuda).manual_seed(grid_n)
    kw = {}
    if variant == "constblk":
        kw["consts"] = opt_slope_probe.const_blocks(cuda)
    elif variant == "streamed":
        kw["slab"] = torch.randn(grid_n, 512, 1024, generator=gen, device=cuda).to(BF)
    h = torch.zeros(32, 768, dtype=BF, device=cuda)
    hr = h.clone()
    for _ in range(100 if variant == "minimal" else 3):
        h, cs = probe_copy.copy(h, grid_n, **kw)
        hr_next, csr = probe_copy.copy_reference(hr, grid_n, **kw)
        assert torch.equal(cs, csr)
        hr = hr_next
    torch.cuda.synchronize()
    assert torch.equal(h, hr)
    if (grid_n, variant) == (8, "minimal"):
        assert bool((h == 764).all())


def _copy_kwargs(variant: str, grid_n: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(grid_n)
    if variant == "constblk":
        return {"consts": opt_slope_probe.const_blocks(device)}
    if variant == "streamed":
        return {"slab": torch.randn(grid_n, 512, 1024, generator=gen, device=device).to(BF)}
    return {}


@pytest.mark.parametrize("grid_n", [1, 8, 20])
@pytest.mark.parametrize("variant", probe_copy.VARIANTS)
def test_probe_copy_every_cluster_size(cuda, variant, grid_n):
    """Kernels 15-17 at every CTA count a step a launch takes (1 to 16,
    clusters above 8 non-portable), 3 chained launches each from a random x:
    output and every step's checksum bit-equal to plain, whatever the
    count."""
    kw = _copy_kwargs(variant, grid_n, cuda)
    x0 = torch.randn(32, 768, generator=torch.Generator(device=cuda).manual_seed(7),
                     device=cuda).to(BF)
    want = [x0]
    sums = []
    for _ in range(3):
        out, cs = probe_copy.copy_reference(want[-1], grid_n, **kw)
        want.append(out)
        sums.append(cs)
    for ctas in range(1, probe_copy.MAX_CLUSTER + 1):
        h = x0
        for n in range(3):
            h, cs = probe_copy.copy(h, grid_n, ctas=ctas, **kw)
            torch.cuda.synchronize()
            assert torch.equal(cs, sums[n]), (ctas, n)
        assert torch.equal(h, want[-1]), ctas


@pytest.mark.parametrize("variant", probe_copy.VARIANTS)
def test_probe_copy_phase_stamps(cuda, variant):
    """The stamped launch gives the plain launch's bits; every CTA of the
    plan stamps its five phases in order."""
    kw = _copy_kwargs(variant, 8, cuda)
    x = torch.randn(32, 768, device=cuda).to(BF)
    out, cs = probe_copy.copy(x, 8, **kw)
    out_s, cs_s, st = probe_copy.copy_stamps(x, 8, **kw)
    torch.cuda.synchronize()
    st = st.cpu()
    assert torch.equal(out, out_s) and torch.equal(cs, cs_s)
    assert st.shape == (probe_copy.plan_for(x, 8, **kw).blocks, probe_copy.STAMPS)
    assert bool((st > 0).all()) and bool((st[:, 1:] >= st[:, :-1]).all())
    assert 0 < probe_copy.read_phases(st)["end_last_us"] < 1e5


def test_probe_copy_rejects_bad_plans(cuda):
    x = torch.zeros(32, 768, dtype=BF, device=cuda)
    for ctas in (0, 17):
        with pytest.raises(ValueError):
            probe_copy.copy(x, 8, ctas=ctas)
    with pytest.raises(ValueError):
        probe_copy.copy(x, 8, stamps=torch.zeros(3, 5, dtype=torch.int64, device=cuda))


def test_probe_wrappers_reject_bad_inputs(cuda):
    x, w, _, _ = probe_int4.make_inputs(cuda)["native_int4"]
    bad_gemv = [(x.float(), w, "native_int4"), (x, w.to(torch.int8), "native_int4"),
                (x[:, :512].contiguous(), w, "native_int4"), (x, w, "int3"),
                (x, w[:, :1000].contiguous(), "native_int4")]
    for args in bad_gemv:
        with pytest.raises(ValueError):
            probe_gemv.gemv(*args)
    a = opt_attend_probe.make_inputs(cuda)
    out = torch.zeros(8, 768, device=cuda)
    with pytest.raises(ValueError):
        probe_attend.attend_accumulate(out, a["q"], a["k"], a["v"], None, None, 641, "tr")
    with pytest.raises(ValueError):
        probe_attend.attend_accumulate(out, a["q"], a["k"], a["v"], None, None, 320, "i8mixed")
    with pytest.raises(ValueError):
        probe_attend.attend_accumulate(out.double(), a["q"], a["k"], a["v"], None, None, 320,
                                       "cur")
    with pytest.raises(ValueError):
        probe_attend.attend(a["q"], a["k"], a["v"], None, None, 320, 1, "flash")
    h = torch.zeros(32, 768, dtype=BF, device=cuda)
    for kw in ({"grid_n": 0}, {"grid_n": 8, "slab": torch.zeros(4, 16, dtype=BF, device=cuda)}):
        with pytest.raises(ValueError):
            probe_copy.copy(h, **kw)
    with pytest.raises(ValueError):
        probe_copy.copy(h.float(), 8)
    with pytest.raises(ValueError):
        probe_copy.copy(torch.zeros(3, dtype=BF, device=cuda), 1)


def test_graph_slope_times_the_copy_kernel(cuda):
    """graph_slope captures the chained copy kernel and returns a positive
    per-launch time; the graph's chain equals the eager chain."""
    body = lambda i, h: probe_copy.copy(h, 8)[0]
    x0 = torch.zeros(32, 768, dtype=BF, device=cuda)
    res = timing.graph_slope(body, x0, 5, 25, reps=2)
    assert res["clock"] == "cuda graph" and res["per_launch_ms"] > 0
    assert timing.eager_slope(body, x0, 5, 25, reps=2)["per_launch_ms"] > 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = timing.chain(body, x0, 10)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, timing.chain(body, x0, 10))


def test_frame_kernel_chain_captures_in_a_cuda_graph(prepared):
    """Kernel A's chain captured in a CUDA graph gives the eager chain's bits:
    its wrapper reads nothing back to the host."""
    w, xa_k, xa_v, st = prepared

    def body(i, carry):
        h, kc, vc = carry
        _, _, h2, kc, vc = fs.frame_step(h, st.pos, xa_k, xa_v, kc, vc, w, SMALL, i, 0.7, 8,
                                         False, enc_length=6)
        return h2, kc, vc

    ke, ve = st.k_cache.clone(), st.v_cache.clone()
    kg, vg = st.k_cache.clone(), st.v_cache.clone()
    with torch.no_grad():
        want = timing.chain(body, (st.hidden, ke, ve), 4)[0]
        body(0, (st.hidden, kg.clone(), vg.clone()))  # warm-up
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = timing.chain(body, (st.hidden, kg, vg), 4)[0]
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(kg, ke)


def test_probe_scripts_run_on_the_card(cuda):
    """Each probe module's path at tiny counts on the card."""
    assert probe_int4.probe("packed_int8", cuda, n_lo=2, n_hi=4, reps=1, timed_n=2)[
        "bit_equal_plain"]
    x = opt_attend_probe.make_inputs(cuda)
    assert opt_attend_probe.slopes("cur", 320, x, cuda, i_lo=2, i_hi=4, reps=1)["graph_l2_ms"] > 0
    assert opt_launch_probe.run("grid 20", 32, 20, 0, cuda, n_lo=2, n_hi=6, reps=1, iters=10)[
        "bit_equal_plain"]
    assert opt_slope_probe.probe_constblk(cuda, n_lo=2, n_hi=6, reps=1)["graph_ms"] > 0


# --------------------- kernels 11-13: K split across a cluster


def _gemv_inputs(fmt: str, K: int, N: int, device, seed: int, small_x: bool = True):
    """Random inputs: int4 weights (native or packed) with small-integer x
    (every sum an exact integer) or, with small_x False, normal x; bf16
    normal weights and x."""
    rng = np.random.default_rng(seed)
    if fmt == "bf16":
        w = torch.from_numpy(rng.standard_normal((K, N))).to(device=device, dtype=BF)
    else:
        pack = probe_gemv.pack_int8 if fmt == "packed_int8" else probe_gemv.pack_native_int4
        w = torch.from_numpy(pack(rng.integers(-8, 8, size=(K, N)))).to(device)
    if fmt != "bf16" and small_x:
        x = torch.from_numpy(rng.integers(-3, 4, size=(8, K)).astype(np.float32))
    else:
        x = torch.from_numpy(rng.standard_normal((8, K)))
    return x.to(device=device, dtype=BF), w


def _gemv_close(fmt: str, got, want) -> bool:
    got, want = got.cpu(), want.cpu()
    if fmt == "bf16":
        return float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    return torch.equal(got, want)


@pytest.mark.parametrize("N", [64, 192, 3072])
@pytest.mark.parametrize("K", [256, 512, 768, 1024])
@pytest.mark.parametrize("fmt", probe_gemv.FORMATS)
def test_probe_gemv_split_kernel_matches_plain(cuda, fmt, K, N):
    """Kernels 11-13 at every K the wrapper takes and N 64 / 192 / 3072
    (one tile, three, the probe's 48): int4 bit-equal to plain and to the
    CPU model of the sum order, bf16 within 1e-5 of the largest value."""
    x, w = _gemv_inputs(fmt, K, N, cuda, seed=K + N)
    got = probe_gemv.gemv(x, w, fmt)
    torch.cuda.synchronize()
    assert _gemv_close(fmt, got, probe_gemv.gemv_reference(x, w, fmt))
    assert _gemv_close(fmt, got, probe_gemv.split_model(x, w, fmt))


@pytest.mark.parametrize("fmt", probe_gemv.FORMATS)
def test_probe_gemv_split_launches_repeat_their_bits(cuda, fmt):
    """Normal x (sums no longer exact, so the order shows): two launches give
    the same bits, the plan passed explicitly gives the default launch's
    bits (the kernel's plan_splits mirrors plan_gemv), and every split of
    K = 768 agrees with plain."""
    x, w = _gemv_inputs(fmt, 768, 3072, cuda, seed=1, small_x=False)
    a, b = probe_gemv.gemv(x, w, fmt), probe_gemv.gemv(x, w, fmt)
    plan = probe_gemv.plan_gemv(fmt, 768, 3072)
    explicit = probe_gemv.gemv(x, w, fmt, splits=plan.splits)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, explicit)
    want = probe_gemv.gemv_reference(x, w, fmt)
    for splits in (1, 2, 3, 4, 6, 8):
        got = probe_gemv.gemv(x, w, fmt, splits=splits)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("fmt", probe_gemv.FORMATS)
def test_probe_gemv_split_graph_replays_are_stable(cuda, fmt):
    """100 launches captured in one CUDA graph give an eager launch's bits
    every time (no state carried between launches)."""
    x, w = _gemv_inputs(fmt, 768, 3072, cuda, seed=2, small_x=False)
    eager = probe_gemv.gemv(x, w, fmt)
    torch.cuda.synchronize()
    outs = torch.zeros(100, 8, 3072, device=cuda)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(100):
            outs[i].copy_(probe_gemv.gemv(x, w, fmt))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(outs, eager.expand(100, 8, 3072))
    del graph


def test_probe_gemv_packed_keeps_its_bits(cuda):
    """Kernel 12 on the cluster design keeps its bits: on the probe's inputs
    the exact integer product; on a seeded normal x the same bits from two
    launches, the plan's split passed explicitly and the stamped launch, and
    those of the CPU model of its sum order within 1e-5 of the largest
    value (the tensor cores' rounding inside an mma is not modelled)."""
    x, w, _, wint = probe_int4.make_inputs(cuda)["packed_int8"]
    got = probe_gemv.gemv(x, w, "packed_int8")
    xr = torch.from_numpy(np.random.default_rng(7).standard_normal((8, 768))).to(device=cuda,
                                                                                  dtype=BF)
    rnd = [probe_gemv.gemv(xr, w, "packed_int8"), probe_gemv.gemv(xr, w, "packed_int8"),
           probe_gemv.gemv(xr, w, "packed_int8",
                           splits=probe_gemv.plan_gemv("packed_int8", 768, 3072).splits),
           probe_gemv.gemv_stamps(xr, w, "packed_int8")[0]]
    torch.cuda.synchronize()
    exact = np.ones((8, 768), np.float32) @ wint.astype(np.float32)
    assert np.array_equal(got.cpu().numpy(), exact)
    assert all(torch.equal(r, rnd[0]) for r in rnd[1:])
    model = probe_gemv.split_model(xr, w, "packed_int8").cpu()
    assert float((rnd[0].cpu() - model).abs().max()) <= 1e-5 * float(model.abs().max())


@pytest.mark.parametrize("K", [256, 512, 768, 1024])
def test_probe_gemv_packed_every_split(cuda, K):
    """Kernel 12 at every K and every split it takes (divisors of its K / 32
    byte-row steps, at most 8): small-integer x bit-equal to plain and to
    the model of the split's sum order; normal x within 1e-5 of the largest
    plain value."""
    x, w = _gemv_inputs("packed_int8", K, 3072, cuda, seed=K)
    xn, _ = _gemv_inputs("packed_int8", K, 3072, cuda, seed=K, small_x=False)
    base = probe_gemv.plan_gemv("packed_int8", K, 3072)
    want, want_n = probe_gemv.gemv_reference(x, w, "packed_int8"), probe_gemv.gemv_reference(
        xn, w, "packed_int8")
    for splits in (s for s in range(1, 9) if base.steps(K) % s == 0):
        plan = dataclasses.replace(base, splits=splits, kchunk=K // splits)
        got = probe_gemv.gemv(x, w, "packed_int8", splits=splits)
        got_n = probe_gemv.gemv(xn, w, "packed_int8", splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(got, want), splits
        assert torch.equal(got, probe_gemv.split_model(x, w, "packed_int8", plan)), splits
        assert float((got_n - want_n).abs().max()) <= 1e-5 * float(want_n.abs().max()), splits


@pytest.mark.parametrize("fmt", probe_gemv.FORMATS)
def test_probe_gemv_phase_stamps(cuda, fmt):
    """The stamped launch gives the plain launch's bits; every CTA stamps its
    five phases in order."""
    x, w = _gemv_inputs(fmt, 768, 3072, cuda, seed=3, small_x=False)
    plain = probe_gemv.gemv(x, w, fmt)
    out, st = probe_gemv.gemv_stamps(x, w, fmt)
    torch.cuda.synchronize()
    st = st.cpu()
    assert torch.equal(out, plain)
    assert st.shape == (probe_gemv.plan_gemv(fmt, 768, 3072).ctas, probe_gemv.STAMPS)
    assert bool((st > 0).all()) and bool((st[:, 1:] >= st[:, :-1]).all())
    ph = probe_gemv.read_phases(st)
    assert 0 < ph["end_last_us"] < 1e5 and ph["ctas"] == st.shape[0]


def test_probe_gemv_split_rejects_bad_plans(cuda):
    x, w = _gemv_inputs("bf16", 768, 3072, cuda, seed=4)
    for splits in (0, 5, 7, 9):
        with pytest.raises(ValueError):
            probe_gemv.gemv(x, w, "bf16", splits=splits)
    with pytest.raises(ValueError):
        probe_gemv.gemv(x, w, "bf16", stamps=torch.zeros(10, 5, dtype=torch.int64, device=cuda))
    xp, wp, _, _ = probe_int4.make_inputs(cuda)["packed_int8"]
    for splits in (0, 5, 7, 9):
        with pytest.raises(ValueError):
            probe_gemv.gemv(xp, wp, "packed_int8", splits=splits)


@pytest.mark.parametrize("fmt", probe_gemv.FORMATS)
def test_probe_gemv_takes_an_unaligned_x(cuda, fmt):
    """A contiguous x at an offset that is not 16-byte aligned (the kernels
    copy x in 16-byte pieces) is still taken: the aligned copy's bits."""
    x, w, _, _ = probe_int4.make_inputs(cuda)[fmt]
    xr = torch.from_numpy(np.random.default_rng(8).standard_normal((8, 768))).to(device=cuda,
                                                                                  dtype=BF)
    base = torch.zeros(8 * 768 + 1, dtype=BF, device=cuda)
    unaligned = base[1:].view(8, 768)
    unaligned.copy_(xr)
    assert unaligned.is_contiguous() and unaligned.data_ptr() % 16
    got, want = probe_gemv.gemv(unaligned, w, fmt), probe_gemv.gemv(xr, w, fmt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
