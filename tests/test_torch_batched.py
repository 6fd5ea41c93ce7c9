"""PyTorch port, batched serving: the masked decoder step, the batched frame
kernel's plain version and the lockstep engine against the JAX package, on
the CPU. The JAX batched frame kernel runs in interpret mode, as
tests/test_pallas_kernels.py runs it; the CUDA kernel itself is tested on the
card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magpie_tts_tpu.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu.models import decoder as jdecoder
from magpie_tts_tpu.ops.pallas_kernels.frame_step_batched import frame_step_batched_pallas
from magpie_tts_tpu.parallel.serving import BatchedMagpieEngine as JaxBatchedEngine
from magpie_tts_tpu_torch.models import decoder as tdecoder
from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
from magpie_tts_tpu_torch.parallel.serving import BatchedMagpieEngine
from tests.test_torch_support import port_magpie_weights, t
from tests.utils import tiny_magpie_config

CONFIG = tiny_magpie_config()
B, ENC = 8, 16
WRITE_ROW = 40
EMPTY_SLOT = 7   # never admitted: valid all False


@pytest.fixture(scope="module")
def weights():
    jw = random_magpie_weights(CONFIG, seed=11)
    return jw, port_magpie_weights(jw)


def _ring_masks(rng) -> np.ndarray:
    """Per-slot valid rows as the ring cache leaves them: runs of different
    lengths starting at different rows, some wrapping past max_seq - 1,
    none covering WRITE_ROW, and one empty slot."""
    S = CONFIG.max_seq
    valid = np.zeros((B, S), bool)
    for b in range(B):
        if b == EMPTY_SLOT:
            continue
        start = (WRITE_ROW + 1 + 3 * b) % S
        n = 6 + 2 * b
        valid[b, (start + np.arange(n)) % S] = True
    assert valid[:, -1].any() and valid[:, 0].any() and not valid[:, WRITE_ROW].any()
    return valid


@pytest.fixture(scope="module")
def frame_inputs(weights):
    jw, _ = weights
    rng = np.random.default_rng(5)
    L, S, D = CONFIG.dec_layers, CONFIG.max_seq, CONFIG.d_model
    return dict(
        hidden=rng.normal(0, 1, (B, D)).astype(np.float32),
        valid=_ring_masks(rng),
        may_continue=np.array([1, 1, 0, 1, 1, 1, 0, 1], bool),
        posemb=np.asarray(jw.decoder.pos_emb)[rng.integers(0, CONFIG.max_pos, B)],
        xa_k=rng.normal(0, 0.5, (B, L, ENC, CONFIG.d_xa)).astype(np.float32),
        xa_v=rng.normal(0, 0.5, (B, L, ENC, CONFIG.d_xa)).astype(np.float32),
        k_cache=rng.normal(0, 0.5, (B, L, S, D)).astype(np.float32),
        v_cache=rng.normal(0, 0.5, (B, L, S, D)).astype(np.float32),
        enc_lengths=rng.integers(1, ENC + 1, B).astype(np.int32),
        seeds=rng.integers(-2**31, 2**31, B).astype(np.int32),
        forbid_eos=np.array([0, 1, 0, 0, 1, 0, 1, 0], bool))


@pytest.mark.parametrize("slot", [0, 3, 6])
def test_decode_step_masked_matches_jax(weights, frame_inputs, slot):
    """Ring-style masks (staggered, wrapped) with a logical position apart
    from the write row; the new row is written in place."""
    jw, pw = weights
    x = frame_inputs
    mask = x["valid"][slot].copy()
    mask[WRITE_ROW] = True
    emb = x["hidden"][slot] * 0.1
    lp = 20 + slot
    h_j, k_j, v_j = jdecoder.decode_step_masked(
        jnp.asarray(emb), jnp.int32(lp), jnp.int32(WRITE_ROW), jnp.asarray(mask),
        jnp.asarray(x["xa_k"][slot]), jnp.asarray(x["xa_v"][slot]),
        jnp.asarray(x["k_cache"][slot]), jnp.asarray(x["v_cache"][slot]), jw, CONFIG,
        enc_length=jnp.int32(x["enc_lengths"][slot]))
    k_p, v_p = t(x["k_cache"][slot]), t(x["v_cache"][slot])
    with torch.no_grad():
        h_p = tdecoder.decode_step_masked(t(emb), lp, WRITE_ROW, t(mask), t(x["xa_k"][slot]),
                                          t(x["xa_v"][slot]), k_p, v_p, pw, CONFIG,
                                          enc_length=int(x["enc_lengths"][slot]))
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(k_p.numpy(), np.asarray(k_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(v_p.numpy(), np.asarray(v_j), atol=1e-5, rtol=0)


# One interpret call each (~3 s). Codes exact for every slot (they depend
# only on the incoming hidden); hidden and caches to 1e-5 for live slots and
# finite for all: an empty slot attends uniformly over a window that differs
# between the two (the TPU kernel's, the whole masked cache here).
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_frame_step_batched_reference_matches_pallas_interpret(weights, frame_inputs,
                                                               temperature):
    jw, pw = weights
    x = frame_inputs
    s_j, a_j, h_j, k_j, v_j = frame_step_batched_pallas(
        jnp.asarray(x["hidden"]), jnp.int32(WRITE_ROW), jnp.asarray(x["valid"]),
        jnp.asarray(x["may_continue"]), jnp.asarray(x["posemb"]), jnp.asarray(x["xa_k"]),
        jnp.asarray(x["xa_v"]), jnp.asarray(x["k_cache"]), jnp.asarray(x["v_cache"]), jw,
        CONFIG, jnp.asarray(x["enc_lengths"]), jnp.asarray(x["seeds"]),
        jnp.float32(temperature), 8, jnp.asarray(x["forbid_eos"]), interpret=True)
    k_p, v_p = t(x["k_cache"]), t(x["v_cache"])
    with torch.no_grad():
        s_p, a_p, h_p, _, _ = fsb.frame_step_batched(
            t(x["hidden"]), WRITE_ROW, t(x["valid"]), t(x["may_continue"]), t(x["posemb"]),
            t(x["xa_k"]), t(x["xa_v"]), k_p, v_p, pw, CONFIG, t(x["enc_lengths"]),
            t(x["seeds"]), temperature, 8, t(x["forbid_eos"]))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
    live = [b for b in range(B) if b != EMPTY_SLOT]
    np.testing.assert_allclose(h_p.numpy()[live], np.asarray(h_j)[live], atol=1e-5, rtol=0)
    np.testing.assert_allclose(k_p.numpy()[live], np.asarray(k_j)[live], atol=1e-5, rtol=0)
    np.testing.assert_allclose(v_p.numpy()[live], np.asarray(v_j)[live], atol=1e-5, rtol=0)
    for got in (h_p, k_p, v_p):
        assert torch.isfinite(got).all()


def test_batched_wrapper_counts_no_cpu_launch(weights, frame_inputs):
    """On CPU tensors the wrapper runs the plain version: no launch counted."""
    _, pw = weights
    x = frame_inputs
    fsb.launches = 0
    with torch.no_grad():
        fsb.frame_step_batched(t(x["hidden"]), WRITE_ROW, t(x["valid"]), t(x["may_continue"]),
                               t(x["posemb"]), t(x["xa_k"]), t(x["xa_v"]), t(x["k_cache"]),
                               t(x["v_cache"]), pw, CONFIG, t(x["enc_lengths"]), t(x["seeds"]),
                               0.0, 8, t(x["forbid_eos"]))
    assert fsb.launches == 0


# ---------------------------------------------------------------- lockstep

def _tokens(rng, n):
    return [CONFIG.text_bos_id] + [int(v) for v in rng.integers(2, 30, size=n)] + \
        [CONFIG.text_eos_id]


@pytest.fixture(scope="module")
def lockstep(weights):
    """Both engines at B=4; the JAX one compiles once per token bucket."""
    jw, pw = weights
    buckets = (16, 32)
    return (JaxBatchedEngine(jw, CONFIG, batch_size=4, token_buckets=buckets),
            BatchedMagpieEngine(pw, CONFIG, batch_size=4, device="cpu", token_buckets=buckets))


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_lockstep_codes_equal_jax(lockstep, temperature):
    """Three requests padded to B=4 (keys fold_in(PRNGKey(seed), i))."""
    jeng, teng = lockstep
    rng = np.random.default_rng(3)
    reqs = [_tokens(rng, n) for n in (4, 9, 12)]
    want = jeng.synthesize_batch(reqs, temperature=temperature, top_k=8, seed=5,
                                 speaker_ids=[0, 1, 0])
    got = teng.synthesize_batch(reqs, temperature=temperature, top_k=8, seed=5,
                                speaker_ids=[0, 1, 0])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_lockstep_chunked_waves_equal_jax(lockstep):
    """An over-long input splits at word boundaries into chunks that join the
    lockstep batch as extra rows (keys fold_in(fold_in(base, r), k)); its
    codes are re-concatenated in order."""
    jeng, teng = lockstep
    rng = np.random.default_rng(4)
    long = _tokens(rng, 70)
    for i in range(6, 70, 7):
        long[i] = 93   # the split token
    reqs = [long, _tokens(rng, 20)]
    want = jeng.synthesize_batch(reqs, temperature=0.7, top_k=8, seed=9)
    got = teng.synthesize_batch(reqs, temperature=0.7, top_k=8, seed=9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
