"""Kernels A and 5 as one persistent, cooperative launch a frame, on the card.

Each test needs a CUDA device and skips without one; the file imports neither
jax nor the JAX package:
    MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_frame_persistent_cuda.py -q -m cuda

The kernels against their plain versions at the positions where the row
chunks, the ring and the bounds turn (row 1, 63 / 64 / 65 rows, the last
cache row), with fewer encoder rows than the cache holds, EOS forbidden and
not, temperature 0 and 0.7, in both dtypes and every weight stream; the bits
across grid sizes; 500 frames replayed from one CUDA graph; the phase stamps
against the plan; a grid that cannot be co-resident refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.config import MagpieConfig
from magpie_tts_tpu_torch.io.magpie_weights import (q8_dequantized_decoder, q8_stream_from_arrays,
                                                     quantize_decoder_stream, random_magpie_weights)
from magpie_tts_tpu_torch.models import magpie as magpie_mod
from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
from magpie_tts_tpu_torch.runtime import engine as engine_mod

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
TOL = 1e-4  # float32: the GEMVs' summation order differs from torch's
# The tiny config of tests/test_torch_cuda.py with 64 decode steps: a 96-row
# cache, so that 63 / 64 / 65 rows straddle the first attention chunk (64
# rows at d_head 16).
CFG = MagpieConfig(
    d_model=64, d_ffn=128, d_head=16, enc_layers=2, enc_heads=4, enc_kernel=3,
    dec_layers=2, dec_sa_heads=4, dec_xa_heads=1, dec_xa_d_head=32, dec_kernel=1,
    lt_dim=32, lt_ffn_dim=64, lt_layers=1, lt_heads=1, text_vocab_size=100,
    num_codebooks=8, codebook_size=32, vocab_per_cb=40, num_speakers=2,
    context_frames=6, text_bos_id=98, text_eos_id=99, audio_bos_id=32, audio_eos_id=33,
    context_bos_id=34, context_eos_id=35, mask_token_id=36, max_dec_steps=64,
    min_generated_frames=2, max_pos=128)
ENC = 6
POSITIONS = (0, 62, 63, 64, CFG.max_seq - 1)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return engine_mod.resolve_device("cuda")


@pytest.fixture(scope="module")
def states(card):
    """{dtype: (weights, xa_k, xa_v, hidden, k_cache, v_cache)}: prepare()'s
    state with every cache row past the context filled at its scale."""
    out = {}
    for dt in (torch.float32, BF):
        w = random_magpie_weights(CFG, seed=11).to(device=card, dtype=dt)
        tokens = torch.tensor(np.random.default_rng(7).integers(2, 96, size=8), device=card)
        with torch.no_grad():
            xa_k, xa_v, st = magpie_mod.prepare(tokens, ENC, 0, w, CFG)
        gen = torch.Generator(device=card).manual_seed(3)
        scale = float(st.k_cache[:, :CFG.context_frames].float().std())
        ctx = torch.arange(CFG.max_seq, device=card)[None, :, None] < CFG.context_frames + 1
        fill = lambda: (torch.randn(st.k_cache.shape, generator=gen, device=card)
                        * scale).to(dt)
        out[dt] = (w, xa_k, xa_v, st.hidden, torch.where(ctx, st.k_cache, fill()),
                   torch.where(ctx, st.v_cache, fill()))
    return out


def _streams(w):
    """(q8 stream, weights whose decoder holds its matrices dequantized in
    w's dtype, int8 stream)."""
    q8 = q8_stream_from_arrays(w.decoder).to(w.text_emb.device)
    dec = q8_dequantized_decoder(w.decoder, q8)
    dt = w.decoder.qkv.dtype
    dec = dataclasses.replace(dec, **{n: getattr(dec, n).to(dt)
                                      for n in ("qkv", "sa_out", "ff_proj", "ff_out")})
    return q8, dataclasses.replace(w, decoder=dec), quantize_decoder_stream(w.decoder)


def _scaled_ulps(got, want):
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt() if w.shape[-1] > 1 else w.abs()
    ref = torch.maximum(w.abs(), rms).clamp_min(1e-30)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(ref)) - 7)


def _close(pairs, dtype):
    """float32 within TOL; bf16 within the frame kernels' bar (95% within 1
    scaled ulp, none past 8: chip_smoke.ULP_SHARE / ULP_MAX)."""
    if dtype == torch.float32:
        for a, b in pairs:
            assert float((a.float() - b.float()).abs().max()) < TOL
        return
    d = torch.cat([_scaled_ulps(a, b).flatten() for a, b in pairs])
    assert float((d <= 1).float().mean()) >= 0.95 and float(d.max()) <= 8.0


def _run(fn, state, pos, weights=None, stream=None, **kw):
    w, xa_k, xa_v, hidden, k0, v0 = state
    k, v = k0.clone(), v0.clone()
    with torch.no_grad():
        out = fn(hidden, pos, xa_k, xa_v, k, v, weights if weights is not None else w, CFG,
                 stream=stream, **kw)
    torch.cuda.synchronize()
    return out, k, v


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("temperature,forbid", [(0.0, False), (0.7, True)])
def test_frame_kernels_match_plain_at_the_traps(states, dtype, pos, temperature, forbid):
    """Kernel A and kernel 5 against their plain versions: codes exact,
    hidden and the new K/V row within the bar, 3 of 6 encoder rows."""
    state = states[dtype]
    samp = dict(seed=9 + pos, temperature=temperature, top_k=8, forbid_eos=forbid,
                enc_length=3)
    (sk, ak, hk, _, _), kk, vk = _run(fs.frame_step, state, pos, **samp)
    (sr, ar, hr, _, _), kr, vr = _run(fs.frame_step_reference, state, pos, **samp)
    assert torch.equal(sk, sr) and torch.equal(ak, ar)
    if forbid:
        assert not bool((sk == CFG.audio_eos_id).any())
    _close(((hk, hr), (kk[:, pos], kr[:, pos]), (vk[:, pos], vr[:, pos])), dtype)
    emb = magpie_mod.audio_frame_embedding(sr, state[0], CFG)
    e_state = (state[0], state[1], state[2], emb) + state[4:]
    h5, k5, v5 = _run(ds.decode_step, e_state, pos, enc_length=3)
    h5r, k5r, v5r = _run(ds.decode_step_reference, e_state, pos, enc_length=3)
    _close(((h5, h5r), (k5[:, pos], k5r[:, pos]), (v5[:, pos], v5r[:, pos])), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("enc_length", [64, 65, 80])
def test_cross_attention_in_one_chunk_and_over_the_grid(states, dtype, enc_length):
    """80 encoder rows: at 64 the cross-attention fits one chunk (every block
    attends itself), at 65 and 80 it takes two (the two steps over the grid);
    A and 5 against plain."""
    w, _, _, hidden, k0, v0 = states[dtype]
    gen = torch.Generator(device=hidden.device).manual_seed(enc_length)
    xa = [(torch.randn(CFG.dec_layers, 80, CFG.d_xa, generator=gen, device=hidden.device)
           * 0.5).to(dtype) for _ in range(2)]
    state = (w, xa[0], xa[1], hidden, k0, v0)
    samp = dict(seed=2, temperature=0.7, top_k=8, forbid_eos=False, enc_length=enc_length)
    (sk, ak, hk, _, _), kk, _ = _run(fs.frame_step, state, 70, **samp)
    (sr, ar, hr, _, _), kr, _ = _run(fs.frame_step_reference, state, 70, **samp)
    assert torch.equal(sk, sr) and torch.equal(ak, ar)
    _close(((hk, hr), (kk[:, 70], kr[:, 70])), dtype)
    h5, _, _ = _run(ds.decode_step, state, 70, enc_length=enc_length)
    h5r, _, _ = _run(ds.decode_step_reference, state, 70, enc_length=enc_length)
    _close(((h5, h5r),), dtype)
    plan = fs.plan_frame(CFG, enc_length, False)
    assert plan.barriers == CFG.dec_layers * (8 if enc_length <= 64 else 10)


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 64])
def test_streams_q8_bit_equal_dense_int8_match_plain(states, dtype, pos):
    """The Q8_0 stream bit-equal to dense on its dequantized weights; int8
    against its plain version (codes exact, floats within the bar)."""
    state = states[dtype]
    q8, deq, int8 = _streams(state[0])
    samp = dict(seed=4, temperature=0.7, top_k=8, forbid_eos=False, enc_length=ENC)
    q = _run(fs.frame_step, state, pos, deq, q8, **samp)
    d = _run(fs.frame_step, state, pos, deq, None, **samp)
    assert all(torch.equal(a, b) for a, b in zip(q[0][:3] + q[1:], d[0][:3] + d[1:]))
    i = _run(fs.frame_step, state, pos, None, int8, **samp)
    r = _run(fs.frame_step_reference, state, pos, None, int8, **samp)
    assert torch.equal(i[0][0], r[0][0]) and torch.equal(i[0][1], r[0][1])
    _close(((i[0][2], r[0][2]), (i[1][:, pos], r[1][:, pos])), dtype)
    emb = magpie_mod.audio_frame_embedding(r[0][0], state[0], CFG)
    e_state = (state[0], state[1], state[2], emb) + state[4:]
    q5 = _run(ds.decode_step, e_state, pos, deq, q8, enc_length=ENC)
    d5 = _run(ds.decode_step, e_state, pos, deq, None, enc_length=ENC)
    assert all(torch.equal(a, b) for a, b in zip(q5, d5))
    i5 = _run(ds.decode_step, e_state, pos, None, int8, enc_length=ENC)
    r5 = _run(ds.decode_step_reference, e_state, pos, None, int8, enc_length=ENC)
    _close(((i5[0], r5[0]), (i5[1][:, pos], r5[1][:, pos])), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["dense", "q8"])
def test_bits_do_not_depend_on_the_grid(states, dtype, mode):
    """66 blocks, 132 blocks and the co-resident maximum give the same bits
    (the plan's sum order depends on (K, N) only)."""
    state = states[dtype]
    weights, stream = (None, None) if mode == "dense" else _streams(state[0])[1::-1]
    samp = dict(seed=21, temperature=0.7, top_k=8, forbid_eos=False, enc_length=ENC)
    runs = [_run(fs.frame_step, state, 63, weights, stream, grid=g, **samp)
            for g in (None, 66, 132)]
    runs5 = [_run(ds.decode_step, state, 63, weights, stream, grid=g, enc_length=ENC)
             for g in (None, 66, 132)]
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0][0][:3] + runs[0][1:],
                                                      other[0][:3] + other[1:]))
    for other in runs5[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs5[0], other))


def test_500_frames_replayed_from_one_graph(states):
    """A captured frame replayed 500 times (the barrier's count re-zeroed by
    the captured workspace before every replay) gives the eager bits."""
    w, xa_k, xa_v, hidden, k0, v0 = states[torch.float32]
    args = (hidden, 40, xa_k, xa_v)
    kw = dict(seed=3, temperature=0.7, top_k=8, forbid_eos=False, enc_length=ENC)
    ke, ve = k0.clone(), v0.clone()
    kg, vg = k0.clone(), v0.clone()
    with torch.no_grad():
        want = fs.frame_step(*args, ke, ve, w, CFG, **kw)
        fs.frame_step(*args, kg.clone(), vg.clone(), w, CFG, **kw)  # warm-up
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fs.frame_step(*args, kg, vg, w, CFG, **kw)
        for _ in range(500):
            graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    assert torch.equal(kg, ke) and torch.equal(vg, ve)
    del graph


@pytest.mark.parametrize("fused", [True, False])
def test_phase_stamps_count_the_plan_barriers(states, fused):
    """The kernel's phase stamps: one record a phase, barriers = the plan's,
    times in order, the kinds of the phase table."""
    state = states[torch.float32]
    pos = 40
    plan = fs.plan_frame(CFG, ENC, fused)
    stamps = torch.zeros(1 + fs.STAMP_WORDS * 512, dtype=torch.int64, device=state[3].device)
    if fused:
        _run(fs.frame_step, state, pos, seed=1, temperature=0.7, top_k=8, forbid_eos=False,
             enc_length=ENC, stamps=stamps)
    else:
        _run(ds.decode_step, state, pos, enc_length=ENC, stamps=stamps)
    recs = fs.read_stamps(stamps)
    assert len(recs) == len(plan.phases) == plan.barriers + 1
    assert [r["work"] for r in recs] == [ph.work for ph in plan.phases]
    for r, nxt in zip(recs, recs[1:] + [None]):
        assert r["start"] <= r["pro_end"] <= r["end"]
        if nxt:
            assert r["end"] <= nxt["start"]


def test_a_grid_that_cannot_be_co_resident_is_refused(states):
    """The refused launch raises, and the next launch, at the co-resident
    grid, runs: the refusal does not linger as the next call's error."""
    state = states[torch.float32]
    props = torch.cuda.get_device_properties(state[3].device)
    samp = dict(seed=1, temperature=0.0, top_k=8, forbid_eos=False)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _run(fs.frame_step, state, 10, grid=props.multi_processor_count * 64, **samp)
    (sk, _, hk, _, _), _, _ = _run(fs.frame_step, state, 10, **samp)
    (sr, _, hr, _, _), _, _ = _run(fs.frame_step_reference, state, 10, **samp)
    assert torch.equal(sk, sr) and float((hk - hr).abs().max()) < TOL
    with pytest.raises(RuntimeError, match="CUDA error"):
        _run(ds.decode_step, state, 10, grid=props.multi_processor_count * 64)
    _run(ds.decode_step, state, 10)
