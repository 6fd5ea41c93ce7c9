"""PyTorch port, batched admission: ``prepare_batch`` against the JAX
package's ``jax.vmap(prepare)`` (mixed encoder lengths, two speakers; bf16 in
a child process without XLA's excess precision, as tests/test_torch_bf16.py),
against each request's ``prepare`` alone, and as one pass (its products
counted); bf16 ``prepare`` on ``float32_products`` against the widening
form; the continuous engine's grouped admission against the JAX engine's
``_admit_fn`` (state, (bucket, m) groups, a placement across the ring's
wrap) and its codes against the JAX engine's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magpie_tts_tpu.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu.models import magpie as jmagpie
from magpie_tts_tpu.parallel.continuous import ContinuousBatchingEngine as JaxContinuous
from magpie_tts_tpu_torch.models import decoder as tdecoder
from magpie_tts_tpu_torch.models import magpie as tmagpie
from magpie_tts_tpu_torch.ops import attention as tattention
from magpie_tts_tpu_torch.ops import conv_ffn as tconv_ffn
from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
from tests.test_torch_support import jax_reference_without_excess_precision, port_magpie_weights
from tests.utils import tiny_magpie_config

CONFIG = tiny_magpie_config()
SEED = 6
BUCKET = 16
ATOL = 1e-5   # tests/test_torch_models.py: only summation order and libm differ
N_ROWS = CONFIG.context_frames + 1
BF = torch.bfloat16
# Encoder lengths of each group: 1 and the full bucket among them.
LENGTHS = {1: [BUCKET], 3: [1, BUCKET, 9], 4: [BUCKET, 1, 5, 11]}


def _group(m: int):
    """Tokens [m, BUCKET] (zero-padded past each length), lengths, speakers
    (both of the tiny config's two)."""
    rng = np.random.default_rng(m)
    lens = LENGTHS[m]
    tokens = np.zeros((m, BUCKET), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(2, CONFIG.text_vocab_size - 2, n)
    return tokens, lens, [(i + 1) % CONFIG.num_speakers for i in range(m)]


def _jax_vmap_prepare(jw, m: int):
    tokens, lens, spk = _group(m)
    xa_k, xa_v, st = jax.vmap(lambda t, el, sp: jmagpie.prepare(t, el, sp, jw, CONFIG))(
        jnp.asarray(tokens), jnp.asarray(lens, jnp.int32), jnp.asarray(spk, jnp.int32))
    return xa_k, xa_v, st.k_cache, st.v_cache, st.hidden


def jax_vmap_prepare_bf16(seed: int) -> dict:
    """``jax.vmap(prepare)`` of every group of LENGTHS in bfloat16 (run in the
    child process of jax_reference_without_excess_precision)."""
    jw = random_magpie_weights(CONFIG, seed=seed).astype(jnp.bfloat16)
    out = {}
    for m in LENGTHS:
        for name, v in zip(("xa_k", "xa_v", "k", "v", "hidden"), _jax_vmap_prepare(jw, m)):
            out[f"{name}_{m}"] = np.asarray(jnp.asarray(v, jnp.float32))
    return out


@pytest.fixture(scope="module")
def weights():
    jw = random_magpie_weights(CONFIG, seed=SEED)
    return jw, port_magpie_weights(jw)


def _port_prepare(pw, m: int):
    tokens, lens, spk = _group(m)
    with torch.no_grad():
        return tmagpie.prepare_batch(torch.from_numpy(tokens).long(), lens, spk, pw, CONFIG)


def _check_against_jax(got, want, close):
    xa_k, xa_v, k_rows, v_rows, hidden = got
    j_xa_k, j_xa_v, j_k, j_v, j_hidden = (np.asarray(a, np.float32) for a in want)
    assert k_rows.shape[2] == N_ROWS
    assert not j_k[:, :, N_ROWS:].any() and not j_v[:, :, N_ROWS:].any()
    for name, g, w in (("xa_k", xa_k, j_xa_k), ("xa_v", xa_v, j_xa_v),
                       ("k_rows", k_rows, j_k[:, :, :N_ROWS]),
                       ("v_rows", v_rows, j_v[:, :, :N_ROWS]), ("hidden", hidden, j_hidden)):
        assert g.shape == w.shape, name
        close(name, g, w)


@pytest.mark.parametrize("m", sorted(LENGTHS))
def test_prepare_batch_matches_jax_vmap(weights, m):
    """float32, within 1e-5 of ``jax.vmap(prepare)``: per-row encoder
    lengths (1 and the full bucket) and two speakers in one group."""
    jw, pw = weights

    def close(name, g, w):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0, err_msg=name)
    _check_against_jax(_port_prepare(pw, m), _jax_vmap_prepare(jw, m), close)


def test_prepare_batch_bf16_matches_jax_vmap(weights):
    """bfloat16, against ``jax.vmap(prepare)`` without excess precision. The
    groups of 1 and 4 meet it bit for bit but for one element; in the group
    of 3 the port's encoder summation order moves a normed xa row by an ulp
    (tests/test_torch_bf16.py bounds xa by 1 ulp at its input) and the
    prefill's cross-attention carries it into the caches: 1.5 scaled ulps
    in xa, 2 in the caches, 1 in hidden, on under 15% of the elements. The
    bound: 2 scaled ulps (hidden 1) on at most 15%."""
    from tests.test_torch_bf16 import ulps

    _, pw = weights
    ref = jax_reference_without_excess_precision(
        "tests.test_torch_admission:jax_vmap_prepare_bf16", seed=SEED)
    pw_bf = pw.to(dtype=BF)
    for m in LENGTHS:
        def close(name, g, w):
            assert g.dtype == BF, name
            d = ulps(g, w)
            assert d.max() <= (1 if name == "hidden" else 2), f"{name} M={m}: {d.max()}"
            assert (d > 0).mean() <= 0.15, f"{name} M={m}: {(d > 0).mean()}"
        _check_against_jax(_port_prepare(pw_bf, m),
                           [ref[f"{k}_{m}"] for k in ("xa_k", "xa_v", "k", "v", "hidden")], close)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_prepare_batch_rows_equal_request_alone(weights, dtype):
    """Row i of a group of 4 against request i's ``prepare`` (M = 1): the
    encoder and cross-attention K/V bit-equal; the prefill and BOS rows and
    hidden within 1e-6 in float32 (the CPU's M x d_model products of the
    BOS step sum in another order than its 1 x d_model ones; bf16 rounds
    them away: bit-equal)."""
    _, pw = weights
    pw = pw.to(dtype=dtype)
    tokens, lens, spk = _group(4)
    got = _port_prepare(pw, 4)
    with torch.no_grad():
        for i in range(4):
            xa_k, xa_v, st = tmagpie.prepare(torch.from_numpy(tokens[i]).long(), lens[i], spk[i],
                                             pw, CONFIG)
            assert st.pos == N_ROWS and not st.k_cache[:, N_ROWS:].any()
            assert torch.equal(got[0][i], xa_k) and torch.equal(got[1][i], xa_v)
            for g, w in ((got[2][i], st.k_cache[:, :N_ROWS]), (got[3][i], st.v_cache[:, :N_ROWS]),
                         (got[4][i], st.hidden)):
                if dtype == BF:
                    assert torch.equal(g, w)
                else:
                    torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


def _count_products(monkeypatch, seen: list):
    """Route every ``matmul_f32`` of the plain modules through a recorder of
    its operands."""
    real = tattention.matmul_f32

    def recording(a, b):
        seen.append((a, b))
        return real(a, b)
    for mod in (tattention, tconv_ffn, tdecoder):
        monkeypatch.setattr(mod, "matmul_f32", recording)


def test_prepare_batch_is_one_pass(weights, monkeypatch):
    """The same number of products at M = 1 and M = 4: no loop over requests."""
    _, pw = weights
    counts = {}
    for m in (1, 4):
        seen = []
        with monkeypatch.context() as mp:
            _count_products(mp, seen)
            _port_prepare(pw, m)
        counts[m] = len(seen)
    assert counts[1] == counts[4] > 0, counts


def test_bf16_prepare_on_float32_products(weights, monkeypatch):
    """bf16 ``prepare_batch`` on ``float32_products`` is bit-equal to the
    widening form (bf16 weights widened per product), and there no bf16
    weight reaches ``matmul_f32``: every weight operand is a float32 copy."""
    _, pw = weights
    pw_bf = pw.to(dtype=BF)
    copy = tmagpie.float32_products(pw_bf)
    assert tmagpie.float32_products(pw) is pw           # float32: no copy
    assert copy.text_emb is pw_bf.text_emb and copy.decoder.pos_emb is pw_bf.decoder.pos_emb
    widened = _port_prepare(pw_bf, 4)
    seen = []
    with monkeypatch.context() as mp:
        _count_products(mp, seen)
        got = _port_prepare(copy, 4)
    for g, w in zip(got, widened):
        assert g.dtype == w.dtype == BF and torch.equal(g, w)

    def storages(weights):
        return {t.untyped_storage().data_ptr()
                for part, names in tmagpie.PREPARE_PRODUCTS.items()
                for t in (getattr(getattr(weights, part), n) for n in names)}
    bf16_weights, copies = storages(pw_bf), storages(copy)
    weight_operands = [b for _, b in seen if b.untyped_storage().data_ptr() in copies]
    assert weight_operands and all(b.dtype == torch.float32 for b in weight_operands)
    assert not [b for _, b in seen if b.untyped_storage().data_ptr() in bf16_weights]


# ------------------------------------------------ the continuous engine

def _tokens(rng, n):
    return [CONFIG.text_bos_id] + [int(v) for v in rng.integers(2, 30, size=n)] + \
        [CONFIG.text_eos_id]


# Bursts: lengths of the requests submitted before one admission.
BURSTS = {"five": [4, 9, 6, 12, 5],            # one bucket: chunks 4 + 1 (4 at 4 slots)
          "two_buckets": [4, 20, 5]}           # buckets 16, 32, 16: chunks (16, 2), (32, 1)
# (slots, burst, ring_p before admission; None: the engine's start)
ADMISSIONS = [(4, "five", None), (8, "five", None), (4, "two_buckets", None),
              (8, "two_buckets", None), (8, "five", 3)]


@pytest.mark.parametrize("slots,burst,ring_p", ADMISSIONS)
def test_admission_state_equals_jax(weights, monkeypatch, slots, burst, ring_p):
    """After one admission the engine's state equals the JAX engine's after
    its ``_admit_fn`` calls: caches at the rolled rows, XA K/V, hidden,
    valid, encoder lengths, logical positions, frame counts and keys; the
    (bucket, m) groups are the JAX engine's. ``ring_p = 3`` places the rows
    across the ring's wrap (the attention bound then covers every row)."""
    jw, pw = weights
    rng = np.random.default_rng(slots)
    reqs = [(_tokens(rng, n - 2), 5 + i) for i, n in enumerate(BURSTS[burst])]
    kw = dict(n_slots=slots, token_buckets=(16, 32), segment_frames=5)
    jeng = JaxContinuous(jw, CONFIG, **kw)
    teng = ContinuousBatchingEngine(pw, CONFIG, device="cpu", **kw)
    want_groups, got_groups = [], []
    admit_fn = jeng._admit_fn
    jeng._admit_fn = lambda bucket, m: (want_groups.append((bucket, m)), admit_fn(bucket, m))[1]
    real = tmagpie.prepare_batch

    def recording(tokens, *a, **k):
        got_groups.append(tuple(tokens.shape[::-1]))
        return real(tokens, *a, **k)
    monkeypatch.setattr(tmagpie, "prepare_batch", recording)
    for eng in (jeng, teng):
        for tok, seed in reqs:
            eng.submit(tok, seed=seed)
        if ring_p is not None:
            eng.ring_p = ring_p
        eng._admit_pending()
    assert got_groups == want_groups and want_groups
    for name in ("k_cache", "v_cache", "xa_k", "xa_v", "hidden"):
        np.testing.assert_allclose(getattr(teng, name).numpy(), np.asarray(getattr(jeng, name)),
                                   atol=ATOL, rtol=0, err_msg=name)
    for name in ("valid", "enc_lengths", "logical_pos", "frame_count"):
        np.testing.assert_array_equal(getattr(teng, name).numpy(), np.asarray(getattr(jeng, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(teng.keys, np.asarray(jeng.keys))
    np.testing.assert_array_equal(teng.active, jeng.active)
    assert teng._slot_req == jeng._slot_req
    if ring_p is not None:
        assert teng._rows_hi == CONFIG.max_seq


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_grouped_admission_codes_equal_jax(weights, temperature):
    """Six requests through four slots (a group of 4 first, the rest
    admitted after retirements, with a later wave) give the JAX engine's
    codes exactly."""
    jw, pw = weights
    rng = np.random.default_rng(21)
    waves = [[(_tokens(rng, n), 3 + i) for i, n in enumerate((4, 9, 6, 12, 5, 7))],
             [(_tokens(rng, 8), 11)]]
    kw = dict(n_slots=4, token_buckets=(16, 32), segment_frames=5)
    got = []
    for eng in (JaxContinuous(jw, CONFIG, **kw),
                ContinuousBatchingEngine(pw, CONFIG, device="cpu", **kw)):
        ids = [eng.submit(tok, seed=seed) for tok, seed in waves[0]]
        finished = dict(eng.step(temperature=temperature, top_k=8))
        ids += [eng.submit(tok, seed=seed) for tok, seed in waves[1]]
        while eng.pending:
            finished.update(eng.step(temperature=temperature, top_k=8))
        got.append([finished[i] for i in ids])
    for i, (t, j) in enumerate(zip(got[1], got[0])):
        np.testing.assert_array_equal(t, j, err_msg=f"request {i}")
