"""The persistent frame kernels' plan and numerics on the CPU (no card).

Kernels A and 5 run as one cooperative launch a frame
(magpie_tts_tpu_torch/csrc/frame_persistent.cuh). What of them lives in
Python is checked here at the tiny and 357M widths: the plan covers every
column of every product once, its sum order depends on (K, N) only, the
barrier count is PERF.md's, the workspace and shared memory fit; a model of
the tile sums against x @ W in float64 and, for the Q8_0 stream, bit-equal to
dense on the dequantized weights over two grid sizes; the radix select's
plain twin against the bisection's top-k mask of the port and of the JAX
package.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from magpie_tts_tpu.ops import sampling as jax_sampling
from magpie_tts_tpu_torch.config import MagpieConfig
from magpie_tts_tpu_torch.ops import sampling
from magpie_tts_tpu_torch.ops.kernels import decode_attention as da
from magpie_tts_tpu_torch.ops.kernels import frame_step as fs

FRAME_TOL = 1e-4  # chip_smoke.FRAME_TOL: float32 sums in another order than float64's
TINY = MagpieConfig(
    d_model=64, d_ffn=128, d_head=16, enc_layers=2, enc_heads=4, enc_kernel=3,
    dec_layers=2, dec_sa_heads=4, dec_xa_heads=1, dec_xa_d_head=32, dec_kernel=1,
    lt_dim=32, lt_ffn_dim=64, lt_layers=1, lt_heads=1, text_vocab_size=100,
    num_codebooks=8, codebook_size=32, vocab_per_cb=40, num_speakers=2,
    context_frames=6, text_bos_id=98, text_eos_id=99, audio_bos_id=32, audio_eos_id=33,
    context_bos_id=34, context_eos_id=35, mask_token_id=36, max_dec_steps=64,
    min_generated_frames=2, max_pos=128)
CONFIGS = {"357M": MagpieConfig(), "tiny": TINY}
MODES = ("dense", "int8", "q8")
DTYPES = (torch.float32, torch.bfloat16)
GRIDS = (66, 132, 264)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plan_covers_every_column_once(name, fused, mode, dtype):
    """Every (row, column) of every product of A and 5 is summed by exactly
    one item, and every item lands on exactly one block, at every grid."""
    c = CONFIGS[name]
    plan = fs.plan_frame(c, 20, fused)
    names = {p.name for p in plan.products}
    assert names >= {"qkv", "sa_out", "xa_q", "xa_out", "ff_proj", "ff_out"}
    assert fused == ("lt_out" in names)
    for p in plan.products:
        seen = np.zeros((p.K, p.N), dtype=np.int32)
        for i in range(p.items):
            (k0, k1), (c0, c1) = p.item(i)
            assert c1 - c0 <= fs.TILE_COLS and 0 <= k0 < k1 <= p.K
            seen[k0:k1, c0:c1] += 1
        assert (seen == 1).all(), (p.name, mode, dtype)
        for grid in GRIDS:
            owners = [i % grid for i in range(p.items)]
            assert sorted(set(range(p.items))) == sorted(
                i for b in range(grid) for i in range(b, p.items, grid))
            assert all(0 <= o < grid for o in owners)


@pytest.mark.parametrize("name", CONFIGS)
def test_sum_order_depends_on_k_and_n_only(name):
    """A column's sum order is the same whatever the grid, the dtype, the
    weight stream or the encoder rows: plan_frame takes none of the first
    three, and its products do not change with the last."""
    c = CONFIGS[name]
    a = fs.plan_frame(c, 1, True)
    b = fs.plan_frame(c, c.max_seq, True)
    for pa, pb in zip(a.products, b.products):
        assert (pa.K, pa.N, pa.split, pa.kc) == (pb.K, pb.N, pb.split, pb.kc)
        assert pa.split == fs.product_split(pa.K, pa.N)
        for col in (0, pa.N // 2, pa.N - 1):
            assert pa.sum_order(col) == pb.sum_order(col)
            rows = sorted(k for sp in pa.sum_order(col) for g in sp for k in g)
            assert rows == list(range(pa.K))
    d5 = fs.plan_frame(c, 3, False)
    for p in d5.products:
        assert p.sum_order(p.N - 1) == a.product(p.name).sum_order(p.N - 1)


def test_barrier_count_is_perf_mds():
    """The phase table's barriers (6 an LT phase, 8 a decoder layer with the
    cross-attention in one chunk, 10 past it) are the figures PERF.md gives
    for kernels A and 5 at 357M."""
    c = MagpieConfig()
    a, five = fs.plan_frame(c, 20, True), fs.plan_frame(c, 20, False)
    assert a.barriers == 6 * c.num_codebooks + 8 * c.dec_layers
    assert five.barriers == 8 * c.dec_layers
    assert fs.plan_frame(c, 33, False).barriers == 10 * c.dec_layers
    text = (Path(__file__).resolve().parents[1] / "PERF.md").read_text()
    m = re.search(r"grid\s+barriers\s+a\s+frame:\s+A\s+(\d+),\s+5\s+(\d+)", text)
    assert m, "PERF.md states the barrier counts"
    assert (int(m.group(1)), int(m.group(2))) == (a.barriers, five.barriers)
    assert len(a.phases) == a.barriers + 1 and a.phases[-1].work == "none"


@pytest.mark.parametrize("name", CONFIGS)
def test_workspace_and_shared_memory_fit(name):
    """The grid's blocks an SM fit the H100's shared memory; part / part2 hold every
    product's split partials and every output row; the attention workspace
    holds every step's scores and chunk partials."""
    c = CONFIGS[name]
    smem = fs.smem_bytes(c)
    assert fs.BLOCKS_PER_SM * smem <= 228 * 1024 and smem <= fs.SMEM_LIMIT
    sizes = fs.workspace_sizes(c)
    for rows in (1, 64, 65, c.max_seq):
        plan = fs.plan_frame(c, 20, True)
        for p in plan.products:
            assert p.split * p.N <= min(sizes["part"], sizes["part2"])
            assert p.split <= fs.MAX_SPLIT
        att = da.frame_workspace_sizes(c, 1, rows, 20)
        for heads, r, dh in ((c.dec_sa_heads, rows, c.d_model // c.dec_sa_heads),
                             (c.dec_xa_heads, 20, c.d_xa // c.dec_xa_heads)):
            chunks = da.plan_attention(r, dh).chunks
            assert heads * r <= att["sc"] and heads * chunks * dh <= att["po"]
    assert c.num_codebooks <= da.plan_attention(c.num_codebooks, c.lt_dim).chunk
    fs.check_config("test", c)


def _round(x, dtype):
    return x.to(dtype).float()


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("product", ["sa_out", "xa_q", "ff_out", "lt_in"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_tile_sum_model_matches_float64(name, product, dtype):
    """The model of the tile sums (fmaf chains of 64 row groups, butterfly,
    warps in order, splits in order) against x @ W in float64."""
    c = CONFIGS[name]
    p = fs.plan_frame(c, 20, True).product(product)
    rng = np.random.default_rng(p.K + p.N)
    x = _round(torch.tensor(rng.standard_normal(p.K), dtype=torch.float32), dtype)
    w = _round(torch.tensor(rng.standard_normal((p.K, p.N)) * 0.02, dtype=torch.float32), dtype)
    got = fs.gemv_model(x, p, 132, dense=w, dtype=dtype)
    want = x.double() @ w.double()
    assert float((got.double() - want).abs().max()) < FRAME_TOL


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("product", ["qkv", "ff_out"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_tile_sum_model_q8_bit_equal_dense_over_grids(name, product, dtype):
    """The Q8_0 form of the model (each weight rnd(scale * q) as it loads)
    is bit-equal to the dense model on the dequantized weights, at 66 and
    132 blocks; int8 columns scale the sum."""
    c = CONFIGS[name]
    p = fs.plan_frame(c, 20, True).product(product)
    rng = np.random.default_rng(7)
    x = _round(torch.tensor(rng.standard_normal(p.K), dtype=torch.float32), dtype)
    q = torch.tensor(rng.integers(-127, 128, size=(p.K, p.N)), dtype=torch.int8)
    scales = torch.tensor(rng.uniform(1e-4, 1e-3, size=(p.K // 32, p.N)),
                          dtype=torch.float16).float()
    deq = (torch.repeat_interleave(scales, 32, dim=0) * q.float()).to(dtype).float()
    outs = [fs.gemv_model(x, p, g, q=q, scales=scales, dtype=dtype) for g in (66, 132)]
    dense = [fs.gemv_model(x, p, g, dense=deq, dtype=dtype) for g in (66, 132)]
    assert all(torch.equal(o, dense[0]) for o in outs + dense[1:])
    cs = torch.tensor(rng.uniform(0.5, 2.0, size=p.N), dtype=torch.float32)
    int8 = fs.gemv_model(x, p, 66, q=q, col_scale=cs, dtype=dtype)
    assert torch.equal(int8, fs.gemv_model(x, p, 132, dense=q.float(), dtype=dtype) * cs)


_floats = st.one_of(st.sampled_from([0.0, -0.0, -1e30, 1e30, 1.0, -1.0, 3.5]),
                    st.floats(-50, 50, width=32))


@settings(max_examples=150, deadline=None)
@given(st.lists(_floats, min_size=1, max_size=64), st.sampled_from([1, 2, 8, 80, "V", "V+3"]))
def test_radix_select_equals_the_bisection(values, k):
    """The radix select's admitted set equals exact_topk_mask's (port and
    JAX) on the same values: ties, +-0, forbidden -1e30 logits, k = 1 / 80 /
    V / > V."""
    V = len(values)
    k = V if k == "V" else V + 3 if k == "V+3" else k
    arr = np.asarray(values, dtype=np.float32)[None]
    got = sampling.radix_topk_mask(torch.from_numpy(arr), k)
    assert torch.equal(got, sampling.exact_topk_mask(torch.from_numpy(arr), k))
    assert np.array_equal(got.numpy(), np.asarray(jax_sampling.exact_topk_mask(jnp.asarray(arr),
                                                                               k)))


@pytest.mark.parametrize("k", [1, 80, 2024, 4000])
def test_radix_select_on_frame_logits(k):
    """At the LT's width (2024 logits a codebook, 9 forbidden at -1e30,
    repeated values) for a batch of rows: the same masks as the bisection's."""
    rng = np.random.default_rng(k)
    lg = rng.standard_normal((16, 2024)).astype(np.float32)
    lg[:, 2016] = -1e30
    lg[:, 2018:2024] = -1e30
    lg[:4, :40] = np.float32(1.25)        # ties across the k-th value
    lg[4:8, 100:400:3] = -0.0
    t = torch.from_numpy(lg)
    assert torch.equal(sampling.radix_topk_mask(t, k), sampling.exact_topk_mask(t, k))
