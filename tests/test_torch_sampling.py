"""PyTorch port, sampling: the int32 hash, noise, exact top-k, masks and the
host threefry key chain against the JAX package (jax 0.9, partitionable
threefry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magpie_tts_tpu.ops import sampling as js
from magpie_tts_tpu_torch.ops import sampling as ts

SEEDS = [0, 1, 3, 12345, -7, 2**31 - 1]


def _key(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_key_chain_matches_jax(seed):
    """PRNGKey -> 20 x split (the decode loop's per-frame chain) ->
    seed_from_key, and fold_in (chunks > 0), equal jax.random."""
    key = jax.random.PRNGKey(seed)
    pkey = ts.prng_key(seed)
    assert _key(key) == pkey
    want = []
    for _ in range(20):
        key, sub = jax.random.split(key)
        pkey, psub = ts.split(pkey)
        assert _key(key) == pkey and _key(sub) == psub
        want.append(int(js.seed_from_key(sub)))
    assert ts.frame_seeds(ts.prng_key(seed), 20) == want
    for i in (1, 2, 7):
        assert _key(jax.random.fold_in(jax.random.PRNGKey(seed), i)) == \
            ts.fold_in(ts.prng_key(seed), i)


def test_frame_seeds_batch_matches_jax_per_slot():
    """The serving engines' per-slot chain: fold_in(PRNGKey(seed), id), then
    one split per frame, for all slots at once, equals jax.random's."""
    keys = [jax.random.fold_in(jax.random.PRNGKey(s), i) for i, s in enumerate(SEEDS)]
    seeds, after = ts.frame_seeds_batch(np.array([_key(k) for k in keys], np.uint32), 12)
    for b, key in enumerate(keys):
        for j in range(12):
            key, sub = jax.random.split(key)
            assert seeds[j, b] == int(js.seed_from_key(sub))
        assert tuple(int(v) for v in after[b]) == _key(key)


def test_prng_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        ts.prng_key(2**31)


def test_fmix32_and_phase_seed_match_jax():
    x = np.random.default_rng(0).integers(-2**31, 2**31, size=4096).astype(np.int32)
    np.testing.assert_array_equal(
        ts._fmix32(torch.from_numpy(x).long()).numpy(),
        np.asarray(js._fmix32(jnp.asarray(x))))
    for seed in (0, -5, 2**31 - 1, -2**31):
        for phase in range(8):
            assert int(ts.phase_seed(seed, phase)) == \
                int(js.phase_seed(jnp.int32(seed), phase))


@pytest.mark.parametrize("seed", [0, 5, -123456789])
def test_gumbel_noise_matches_jax(seed):
    """The uniforms are bit-equal; the noise agrees to float32 log rounding
    (XLA's CPU log and torch's differ by up to 1 ulp per log)."""
    cols = np.arange(2024, dtype=np.int32)
    for phase in range(8):
        base = js.phase_seed(jnp.int32(seed), phase)
        h = js._fmix32(base + jnp.asarray(cols) * jnp.int32(js._GOLDEN))
        u = jnp.clip(jax.lax.shift_right_logical(h, 8).astype(jnp.float32)
                     * (1.0 / (1 << 24)), 1e-10, 1.0 - 1e-7)
        pbase = ts.phase_seed(seed, phase)
        np.testing.assert_array_equal(
            ts.uniform_from_seed(pbase, torch.from_numpy(cols)).numpy(), np.asarray(u))
        np.testing.assert_allclose(
            ts.gumbel_from_seed(pbase, torch.from_numpy(cols)).numpy(),
            np.asarray(js.gumbel_from_seed(base, jnp.asarray(cols))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 5, 80, 2024])
def test_exact_topk_mask_matches_jax(k):
    rng = np.random.default_rng(k)
    logits = rng.normal(size=(6, 2024)).astype(np.float32)
    logits[0] = np.round(logits[0] * 4) / 4          # many exact ties
    logits[1, :100] = -1e30                          # masked entries
    logits[2] = -logits[2]
    got = ts.exact_topk_mask(torch.from_numpy(logits), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(js.exact_topk_mask(jnp.asarray(logits), k)))
    assert (got.sum(-1) >= k).all()


@pytest.mark.parametrize("forbid_eos", [False, True])
def test_masks_match_jax(forbid_eos):
    vocab, bos, eos = 2024, 2016, 2017
    static = ts.forbidden_token_mask(vocab, bos)
    jstatic = js.forbidden_token_mask(vocab, bos, eos)
    np.testing.assert_array_equal(static.numpy(), np.asarray(jstatic))
    logits = np.random.default_rng(1).normal(size=vocab).astype(np.float32)
    np.testing.assert_array_equal(
        ts.mask_logits(torch.from_numpy(logits), static, forbid_eos, eos).numpy(),
        np.asarray(js.mask_logits(jnp.asarray(logits), jstatic, jnp.bool_(forbid_eos), eos)))


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_top_k_deterministic_matches_jax(temperature):
    rng = np.random.default_rng(2)
    static = js.forbidden_token_mask(2024, 2016, 2017)
    for trial in range(6):
        logits = np.array(js.mask_logits(
            jnp.asarray(rng.normal(0, 2, size=2024).astype(np.float32)), static,
            jnp.bool_(trial % 2 == 0), 2017))
        seed = int(rng.integers(-2**31, 2**31))
        for phase in (0, 7):
            got = ts.sample_top_k_deterministic(seed, phase, torch.from_numpy(logits),
                                                temperature, 80)
            want = js.sample_top_k_deterministic(jnp.int32(seed), phase, jnp.asarray(logits),
                                                 jnp.float32(temperature), 80)
            assert [int(x) for x in got] == [int(x) for x in want]


def test_argmax_ties_take_lowest_index():
    logits = torch.zeros(50)
    logits[[7, 20, 33]] = 3.0
    sampled, amax = ts.sample_top_k_deterministic(0, 0, logits, 0.0, 80)
    assert int(amax) == 7 == int(sampled)


def test_frame_has_eos():
    eos = 2017
    none = torch.zeros(8, dtype=torch.int32)
    some = none.clone()
    some[3] = eos
    assert not ts.frame_has_eos(none, none, eos)
    assert ts.frame_has_eos(some, none, eos) and ts.frame_has_eos(none, some, eos)
