"""Kernel 4 as one persistent launch a frame (csrc/frame_persistent.cuh
``lt_persistent_kernel``) and the LT samplers' draw, on the CPU.

What of it lives in Python is checked here: kernel 4's phase table
(``frame_step.plan_lt``: kernel A's 8 LT phases, 6 grid barriers each, then
the last draw) with A's products, so the split path's logits have A's sum
order; items that cover every column once over any grid, in a sum order of
(K, N) alone; a model of that order against float64 and bit-equal across
grids; shared memory that fits. The draw's exact top-k
(``ops/sampling.radix_topk_mask``, the kernels' radix select's twin) against
both bisections and, inside a whole draw, against the JAX package's
sampler; and the plain versions kernels 4 and 7 are held against on the
card, against the Pallas kernels they replace in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magpie_tts_tpu.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu.ops import sampling as jax_sampling
from magpie_tts_tpu.ops.pallas_kernels.lt_sampler import sample_frame_codes_pallas
from magpie_tts_tpu.ops.pallas_kernels.lt_sampler_batched import sample_frame_codes_batched_pallas
from magpie_tts_tpu_torch.config import MagpieConfig
from magpie_tts_tpu_torch.ops import sampling
from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts
from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
from tests.test_torch_support import port_magpie_weights, t
from tests.utils import tiny_magpie_config

PROD = MagpieConfig()
TINY = tiny_magpie_config()
CONFIGS = {"357M": PROD, "tiny": TINY}
GRIDS = (33, 66, 132)   # a third, half and all of an H100's SMs
TOP_K = 8
LT_PRODUCTS = ("lt_in", "lt_qkv", "lt_sa_out", "lt_ff_proj", "lt_ff_out", "lt_out")


@pytest.mark.parametrize("name", CONFIGS)
def test_plan_counts_barriers_and_phases(name):
    """6 grid barriers a codebook and none after the last draw (48 at
    357M); the phases are kernel A's LT phases, in A's order, with A's
    products and splits."""
    c = CONFIGS[name]
    plan = fs.plan_lt(c)
    fused = fs.plan_frame(c, 20, True)
    n_lt = 6 * c.num_codebooks
    assert plan.barriers == n_lt and len(plan.phases) == n_lt + 1
    assert plan.phases[:n_lt] == fused.phases[:n_lt]
    assert plan.phases[-1] == fs.Phase("draw", "none", False)
    assert [p.name for p in plan.products] == list(LT_PRODUCTS)
    assert all(p == fused.product(p.name) for p in plan.products)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("grid", GRIDS)
def test_items_cover_every_column_once_in_an_order_of_k_and_n(name, grid):
    """Dealt round-robin over ``grid`` blocks, the items of every LT product
    cover each (split, column) once, each split's rows once; a column's sum
    order is the product's, a function of (K, N) only."""
    c = CONFIGS[name]
    for p in fs.plan_lt(c).products:
        seen = np.zeros((p.split, p.N), dtype=np.int32)
        rows = np.zeros(p.K, dtype=np.int32)
        for block in range(grid):
            for i in range(block, p.items, grid):
                (k0, k1), (c0, c1) = p.item(i)
                seen[i // p.tiles, c0:c1] += 1
                if c0 == 0:
                    rows[k0:k1] += 1
        assert (seen == 1).all() and (rows == 1).all(), p.name
        again = fs.Product(p.name, p.K, p.N, fs.product_split(p.K, p.N))
        for col in (0, p.N // 2, p.N - 1):
            order = p.sum_order(col)
            assert sorted(k for sp in order for g in sp for k in g) == list(range(p.K))
            assert order == again.sum_order(col)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_product_model_matches_float64_and_keeps_bits_over_grids(name, dtype):
    """A model of kernel 4's products (frame_step.gemv_model) against x @ W
    in float64, and bit-equal over grids of 33, 66 and 132 blocks."""
    c = CONFIGS[name]
    for p in fs.plan_lt(c).products:
        rng = np.random.default_rng(p.K + p.N)
        x = torch.tensor(rng.standard_normal(p.K), dtype=torch.float32).to(dtype).float()
        w = torch.tensor(rng.standard_normal((p.K, p.N)) * 0.02,
                         dtype=torch.float32).to(dtype).float()
        outs = [fs.gemv_model(x, p, grid, dense=w) for grid in GRIDS]
        assert all(torch.equal(o, outs[0]) for o in outs[1:]), p.name
        assert float((outs[0].double() - x.double() @ w.double()).abs().max()) < 1e-4, p.name


@pytest.mark.parametrize("name", CONFIGS)
def test_shared_memory_fits_and_config_passes(name):
    """Kernel 4's block takes kernel A's shared memory, which fits an H100
    block; check_config takes the config."""
    c = CONFIGS[name]
    assert fs.smem_bytes(c) <= fs.SMEM_LIMIT
    fs.check_config("test", c, TOP_K)


def test_cpu_tensor_runs_the_plain_version():
    """On a CPU tensor kernel 4's wrapper runs its plain version and counts
    no launch."""
    jw = random_magpie_weights(TINY, seed=3)
    pw = port_magpie_weights(jw)
    hidden = t(np.random.default_rng(3).normal(0, 0.5, TINY.d_model).astype(np.float32))
    before = lts.launches
    with torch.no_grad():
        got = lts.sample_frame_codes(hidden, pw, TINY, 9, 0.7, TOP_K, False)
        want = lts.sample_frame_codes_reference(hidden, pw, TINY, 9, 0.7, TOP_K, False)
    assert lts.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------ the draw's exact top-k

def _frame_logits(rng, rows, V=2024, bos=2016):
    lg = rng.standard_normal((rows, V)).astype(np.float32)
    lg[:, bos] = sampling.NEG_INF
    lg[:, bos + 2:bos + 8] = sampling.NEG_INF
    return lg


def _masks_agree(lg, k):
    t_lg = torch.from_numpy(lg)
    got = sampling.radix_topk_mask(t_lg, k)
    assert torch.equal(got, sampling.exact_topk_mask(t_lg, k))
    want = np.asarray(jax_sampling.exact_topk_mask(jnp.asarray(lg), k))
    assert np.array_equal(got.numpy(), want)
    return got


@pytest.mark.parametrize("k", [1, 2, 80, 2015, 2024, 5000])
def test_radix_topk_on_frame_logits(k):
    """At the LT's width: k = 1, 80, all the allowed logits, V and past V."""
    lg = _frame_logits(np.random.default_rng(k), 12)
    got = _masks_agree(lg, k)
    assert int(got.sum(-1).min()) >= min(k, 2024)


@pytest.mark.parametrize("k", [1, 40, 80, 300])
def test_radix_topk_with_ties_at_the_kth_key(k):
    """Ties straddling the k-th key (40 and 600 equal logits), +-0 and a row
    that is one value but for its forbidden entries."""
    rng = np.random.default_rng(100 + k)
    lg = _frame_logits(rng, 8)
    order = np.argsort(-lg, axis=-1)
    for r in range(4):
        tie = order[r, max(0, k - 20):k + 20]
        lg[r, tie] = lg[r, order[r, k - 1]]
    lg[4, order[4, :600]] = np.float32(2.5)
    lg[5, :300] = np.float32(0.0)
    lg[5, 300:600] = np.float32(-0.0)
    lg[6, :2016] = np.float32(1.0)
    lg[7, 100:900] = np.float32(-1.75)
    _masks_agree(lg, k)


def _draw(logits, seed, phase, temperature, top_k):
    """The kernels' draw in plain torch: argmax; at temperature >= 0.01 the
    radix top-k set and the Gumbel-max draw."""
    amax = torch.argmax(logits).to(torch.int32)
    if temperature < sampling.GREEDY_TEMP_THRESHOLD:
        return amax, amax
    keep = sampling.radix_topk_mask(logits, min(top_k, logits.shape[-1]))
    cols = torch.arange(logits.shape[-1])
    g = sampling.gumbel_from_seed(sampling.phase_seed(seed, phase), cols)
    z = torch.where(keep, logits / max(temperature, sampling.GREEDY_TEMP_THRESHOLD) + g,
                    torch.full_like(logits, sampling.NEG_INF))
    return torch.argmax(z).to(torch.int32), amax


@pytest.mark.parametrize("temperature", [0.0, 0.005, 0.7, 1.3])
@pytest.mark.parametrize("top_k", [1, 80, 4096])
@pytest.mark.parametrize("forbid_eos", [False, True])
def test_draw_matches_the_jax_sampler(temperature, top_k, forbid_eos):
    """The draw with the radix top-k against the JAX package's
    sample_top_k_deterministic on the same masked logits and seeds: codes
    and argmax equal; temperature < 0.01 is the argmax; a forbidden EOS is
    never drawn."""
    c = PROD
    rng = np.random.default_rng(int(temperature * 100) + top_k + forbid_eos)
    static = sampling.forbidden_token_mask(c.vocab_per_cb, c.audio_bos_id)
    jstatic = jax_sampling.forbidden_token_mask(c.vocab_per_cb, c.audio_bos_id, c.audio_eos_id)
    for phase in range(4):
        raw = (rng.standard_normal(c.vocab_per_cb) * 2).astype(np.float32)
        raw[c.audio_eos_id] = raw.max() + 1.0      # EOS the argmax unless forbidden
        seed = int(rng.integers(-2**31, 2**31))
        lg = sampling.mask_logits(torch.from_numpy(raw), static, forbid_eos, c.audio_eos_id)
        code, amax = _draw(lg, seed, phase, temperature, top_k)
        jlg = jax_sampling.mask_logits(jnp.asarray(raw), jstatic, jnp.bool_(forbid_eos),
                                       c.audio_eos_id)
        assert np.array_equal(lg.numpy(), np.asarray(jlg))
        jcode, jamax = jax_sampling.sample_top_k_deterministic(
            jnp.int32(seed), phase, jlg, jnp.float32(temperature), top_k)
        assert (int(code), int(amax)) == (int(jcode), int(jamax))
        assert (int(amax) == c.audio_eos_id) != forbid_eos
        if forbid_eos:
            assert int(code) != c.audio_eos_id
        if temperature < 0.01:
            assert int(code) == int(amax)


# ------------------------------------- the plain versions against the Pallas kernels

@pytest.fixture(scope="module")
def weights():
    jw = random_magpie_weights(TINY, seed=11)
    return jw, port_magpie_weights(jw)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_plain_kernel4_matches_pallas_interpret(weights, temperature):
    """B = 1: kernel 4's plain version against sample_frame_codes_pallas,
    EOS forbidden and not, codes exact."""
    jw, pw = weights
    rng = np.random.default_rng(40 + int(temperature * 10))
    for forbid in (False, True):
        hidden = rng.normal(0, 0.5, TINY.d_model).astype(np.float32)
        seed = int(rng.integers(-2**31, 2**31))
        s_j, a_j = sample_frame_codes_pallas(
            jnp.asarray(hidden), jw, TINY, jnp.int32(seed), jnp.float32(temperature), TOP_K,
            jnp.bool_(forbid), interpret=True)
        with torch.no_grad():
            s_p, a_p = lts.sample_frame_codes(t(hidden), pw, TINY, seed, temperature, TOP_K,
                                              forbid)
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))


@pytest.mark.parametrize("B", [1, 3, 13])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_plain_kernel7_matches_pallas_interpret(weights, B, temperature):
    """Kernel 7's plain version against sample_frame_codes_batched_pallas at
    B = 1, 3 and 13 (interpret mode takes any B), per-slot seeds and EOS
    flags, codes exact."""
    jw, pw = weights
    rng = np.random.default_rng(70 + B + int(temperature * 10))
    hidden = rng.normal(0, 0.5, (B, TINY.d_model)).astype(np.float32)
    seeds = rng.integers(-2**31, 2**31, B).astype(np.int32)
    forbid = rng.random(B) < 0.4
    s_j, a_j = sample_frame_codes_batched_pallas(
        jnp.asarray(hidden), jw, TINY, jnp.asarray(seeds), jnp.float32(temperature), TOP_K,
        jnp.asarray(forbid), interpret=True)
    with torch.no_grad():
        s_p, a_p = ltsb.sample_frame_codes_batched(t(hidden), pw, TINY, t(seeds), temperature,
                                                   TOP_K, t(forbid))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
