"""The batched frame kernels' redesigned families, on the CPU: the launch
plans of the split-row attention and the tensor-core GEMM
(ops/kernels/decode_attention.py, ops/kernels/batched_gemm.py), a CPU model of
the chunked two-pass attention against the plain attention and, inside the
plain decoder step, against the Pallas kernel ``decode_step_batched_pallas``
in interpret mode (float32 here; bfloat16 in a child process without XLA's
excess precision, as tests/test_torch_bf16.py), and a model of the float32
GEMM's split-TF32 products at the decoder's shapes. The kernels themselves
run on the card (tests/test_torch_families_cuda.py)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magpie_tts_tpu.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu.ops.pallas_kernels.decoder_step_batched import decode_step_batched_pallas
from magpie_tts_tpu_torch.config import MagpieConfig
from magpie_tts_tpu_torch.models import decoder as tdecoder
from magpie_tts_tpu_torch.ops import attention as tattention
from magpie_tts_tpu_torch.ops.attention import attn_scale
from magpie_tts_tpu_torch.ops.kernels import batched_gemm as bg
from magpie_tts_tpu_torch.ops.kernels import decode_attention as da
from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
from magpie_tts_tpu_torch.ops.precision import matmul_f32
from tests.test_torch_support import (jax_reference_without_excess_precision,
                                      port_magpie_weights, t)
from tests.utils import tiny_magpie_config

CONFIG = tiny_magpie_config()
PROD = MagpieConfig()
BF = torch.bfloat16
FRAME_TOL = 1e-4   # the frame kernels' float32 bar (chip_smoke.py)
TOL = 1e-4         # the plain decoder step against the Pallas kernel (test_torch_split.py)
MAX_SMEM = 232448  # an H100 block's shared memory (227 KB)


# ------------------------------------------------------------ the plans

@pytest.mark.parametrize("d_head", [16, 32, 64, 128, 256])
def test_attention_chunks_cover_rows_once(d_head):
    """Every row of [0, rows) in exactly one chunk; chunks of 16..64 rows, a
    multiple of 16, at most 16 KB of float32 K; the same chunk at every row
    count (a bounded attention keeps the bits of an unbounded one)."""
    chunk = da.plan_attention(1, d_head).chunk
    for rows in range(1, 1100):
        plan = da.plan_attention(rows, d_head)
        bounds = plan.bounds(rows)
        covered = np.zeros(rows, int)
        for r0, r1 in bounds:
            covered[r0:r1] += 1
        assert (covered == 1).all() and len(bounds) == plan.chunks
        assert plan.chunk == chunk
    assert chunk % 16 == 0 and 16 <= chunk <= 64
    assert chunk * d_head * 4 <= 16384


@pytest.mark.parametrize("config", [PROD, CONFIG], ids=["357M", "tiny"])
def test_gemm_splits_cover_k_once(config):
    """Each product's splits cover [0, K) once, whole 32-row stages of at
    most 256 rows, within the partial cap and the kernel's plan table."""
    for name, (K, N) in bg.frame_products(config).items():
        plan = bg.plan_gemm(K, N)
        covered = np.zeros(K, int)
        for k0, k1 in plan.bounds(K):
            covered[k0:k1] += 1
        assert (covered == 1).all() and len(plan.bounds(K)) == plan.splits, name
        assert plan.kchunk % bg.KT == 0 and bg.KT <= plan.kchunk <= bg.KCHUNK_MAX, name
        assert plan.splits <= bg.PART_CAP and plan.tiles == -(-N // bg.TILE_N), name
    table, n = bg.plan_table(config)
    assert n <= bg.MAX_PLANS
    assert {(table[i].K, table[i].N) for i in range(n)} == set(bg.frame_products(config).values())


def test_plans_depend_on_no_batch_mode_or_dtype():
    """The plans' only inputs are the shapes (and the partial cap): no
    argument for B, the weight stream or the dtype, so a slot's chunks and
    splits are the same whatever runs beside it."""
    assert list(inspect.signature(da.plan_attention).parameters) == ["rows", "d_head"]
    assert list(inspect.signature(bg.plan_gemm).parameters) == ["K", "N", "part_cap"]
    chunks = da.frame_chunks(PROD, 301, 64)
    for B in (1, 8, 64):
        sizes = da.frame_workspace_sizes(PROD, B, 301, 64)
        assert sizes["tk"] == B * PROD.dec_sa_heads
        assert da.frame_chunks(PROD, 301, 64) == chunks


def test_shared_memory_and_workspace_fit():
    """The GEMM block's dynamic shared memory, in both dtypes, every stream
    and every B, and the attention blocks' static shared memory fit an H100
    block's 227 KB; the group sums fit their 1024 floats."""
    for K, N in bg.frame_products(PROD).values():
        plan = bg.plan_gemm(K, N)
        for dtype in (torch.float32, BF):
            for mode in bg.MODES:
                for B in range(1, 65):
                    assert bg.gemm_smem(dtype, mode, B, plan.kchunk) <= MAX_SMEM
        assert bg.gemm_smem(torch.float32, "dense", 64, bg.KCHUNK_MAX) <= MAX_SMEM
    for d_head in (16, 32, 64, 128, 256):
        for dtype in (torch.float32, BF):
            assert da.group_sums_floats(d_head, dtype) <= 1024
    assert da.SMEM_BYTES <= 48 * 1024
    sizes = da.frame_workspace_sizes(PROD, 64, PROD.max_seq, 128)
    assert sizes["sc"] >= 64 * PROD.dec_sa_heads * PROD.max_seq
    assert sizes["po"] >= 64 * PROD.dec_sa_heads * da.plan_attention(PROD.max_seq, 64).chunks * 64


# ------------------------------------------- the chunked attention model

def _attention_inputs(B, rows, heads, d_head, dtype, seed):
    rng = np.random.default_rng(seed)
    S, W = rows + 5, heads * d_head
    q = torch.tensor(rng.normal(0, 1, (B, W)), dtype=torch.float32)
    k = torch.tensor(rng.normal(0, 0.5, (B, S, W)), dtype=torch.float32).to(dtype)
    v = torch.tensor(rng.normal(0, 0.5, (B, S, W)), dtype=torch.float32).to(dtype)
    valid = np.zeros((B, S), bool)
    for b in range(B - 1):                     # runs that wrap; the last slot empty
        valid[b, (rng.integers(0, rows) + np.arange(rng.integers(1, rows + 1))) % rows] = True
    return dict(q=q, k=k, v=v, heads=heads, scale=attn_scale(d_head), rows=rows,
                valid=torch.tensor(valid), write_row=rows - 1,
                new_valid=torch.tensor(rng.random(B) < 0.7, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("rows,heads,d_head", [(17, 4, 16), (300, 12, 64), (100, 1, 128)])
def test_chunked_model_matches_plain_attention(dtype, rows, heads, d_head):
    """The model of the two launches against the plain attention: float32
    within 1e-6 (sums in another order); bf16 outputs within 1 ulp, and the
    probabilities bit-equal to plain's wherever the two row sums agree."""
    x = _attention_inputs(5, rows, heads, d_head, dtype, seed=rows)
    got, probs = da.chunked_attention_model(**x, return_probs=True)
    want = da.decode_attention_reference(**x)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-6
        return
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert float(((got - want).abs() / ulp).max()) <= 1
    # plain's probabilities and sums, (slot, head) by (slot, head)
    qr, kk, _, n_rows, mask = da._inputs(x["q"], x["k"], x["v"], heads, rows, None,
                                         x["valid"], x["write_row"], x["new_valid"])
    agree = 0
    for b in range(5):
        kh = kk[b, :rows].reshape(rows, heads, d_head).transpose(0, 1)
        s = matmul_f32(qr[b][:, None, :], kh.transpose(-1, -2))[:, 0] * x["scale"]
        s = torch.where(mask[b][None, :], s, torch.full_like(s, da.NEG))
        e = torch.exp(s - s.max(-1, keepdim=True).values)
        plain_sum = e.sum(-1)
        model_sum = da.block_sum_order(e)
        same = plain_sum == model_sum
        plain_p = (e / plain_sum[:, None]).to(dtype).float()
        assert torch.equal(probs[b, same], plain_p[same])
        agree += int(same.sum())
    assert agree > 0


def _model_attend(q, k, v, mask=None):
    """ops.attention.attend's signature (q [H, 1, d], k / v [H, S, d], mask
    broadcast to [H, 1, S]) through the chunked model."""
    H, _, d = q.shape
    S = k.shape[1]
    valid = None if mask is None else mask.reshape(-1, S)[:1].expand(1, S)
    out = da.chunked_attention_model(q.reshape(1, H * d).float(),
                                     k.transpose(0, 1).reshape(1, S, H * d),
                                     v.transpose(0, 1).reshape(1, S, H * d), H,
                                     attn_scale(d), valid=valid)
    return out.reshape(H, 1, d).to(v.dtype)


def _ring_inputs(B, seed, dtype=np.float32):
    c = CONFIG
    rng = np.random.default_rng(seed)
    S, L, D, X, E = c.max_seq, c.dec_layers, c.d_model, c.d_xa, 16
    valid = np.zeros((B, S), bool)
    for b in range(B - 1):
        valid[b, (3 - np.arange(4 + 3 * b % 40)) % S] = True
    return dict(x=rng.normal(0, 0.1, (B, D)).astype(dtype),
                lp=rng.integers(c.context_frames + 1, c.max_pos, B), valid=valid,
                k=rng.normal(0, 0.5, (B, L, S, D)).astype(dtype),
                v=rng.normal(0, 0.5, (B, L, S, D)).astype(dtype),
                xa_k=rng.normal(0, 0.5, (B, L, E, X)).astype(dtype),
                xa_v=rng.normal(0, 0.5, (B, L, E, X)).astype(dtype),
                enc=rng.integers(1, E + 1, B).astype(np.int32))


def test_chunked_model_in_the_decoder_matches_pallas_interpret(monkeypatch):
    """The plain batched decoder step with its self- and cross-attention run
    by the chunked model, against decode_step_batched_pallas in interpret
    mode at B = 8: the live slots within TOL."""
    jw = random_magpie_weights(CONFIG, seed=11)
    pw = port_magpie_weights(jw)
    d = _ring_inputs(8, seed=18)
    x_pe = d["x"] + pw.decoder.pos_emb.numpy()[d["lp"]]
    monkeypatch.setattr(tdecoder, "attend", _model_attend)
    monkeypatch.setattr(tattention, "attend", _model_attend)
    k_p, v_p = t(d["k"]), t(d["v"])
    with torch.no_grad():
        h = dsb.decode_step_batched(t(x_pe), 3, t(d["valid"]), t(d["xa_k"]), t(d["xa_v"]), k_p,
                                    v_p, pw, CONFIG, t(d["enc"]))
    h_j, k_j, v_j = decode_step_batched_pallas(
        jnp.asarray(x_pe), jnp.int32(3), jnp.asarray(d["valid"]), jnp.asarray(d["xa_k"]),
        jnp.asarray(d["xa_v"]), jnp.asarray(d["k"]), jnp.asarray(d["v"]), jw, CONFIG,
        jnp.asarray(d["enc"]), interpret=True)
    live = slice(0, 7)
    for got, want in ((h.numpy(), h_j), (k_p.numpy(), k_j), (v_p.numpy(), v_j)):
        np.testing.assert_allclose(got[live], np.asarray(want)[live], atol=TOL, rtol=0)


def jax_k8_bf16_reference(seed: int) -> dict:
    """decode_step_batched_pallas in bfloat16 at B = 8 on _ring_inputs(seed)
    (run in the child of jax_reference_without_excess_precision)."""
    import jax.numpy as jnp

    bf = jnp.bfloat16
    jw = random_magpie_weights(CONFIG, seed=11).astype(bf)
    d = _ring_inputs(8, seed)
    x_pe = jnp.asarray(d["x"]).astype(bf) + jw.decoder.pos_emb[d["lp"]]
    h, _, _ = decode_step_batched_pallas(
        x_pe, jnp.int32(3), jnp.asarray(d["valid"]), jnp.asarray(d["xa_k"]).astype(bf),
        jnp.asarray(d["xa_v"]).astype(bf), jnp.asarray(d["k"]).astype(bf),
        jnp.asarray(d["v"]).astype(bf), jw, CONFIG, jnp.asarray(d["enc"]), interpret=True)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return {"x_pe": f32(x_pe), "hidden": f32(h)}


def test_chunked_model_in_the_decoder_matches_pallas_interpret_bf16(monkeypatch):
    """The same in bfloat16 against the Pallas kernel with every rounding
    the JAX source writes: the live slots' hidden rows at most 1 ulp apart
    on at most 1% of the elements (sums in another order), as the plain
    decoder step is held (tests/test_torch_bf16.py)."""
    ref = jax_reference_without_excess_precision(
        "tests.test_torch_families:jax_k8_bf16_reference", seed=18)
    pw = port_magpie_weights(random_magpie_weights(CONFIG, seed=11)).to(dtype=BF)
    d = _ring_inputs(8, seed=18)
    x_pe = torch.tensor(ref["x_pe"]).to(BF)
    monkeypatch.setattr(tdecoder, "attend", _model_attend)
    monkeypatch.setattr(tattention, "attend", _model_attend)
    bt = lambda a: t(a).to(BF)
    with torch.no_grad():
        h = dsb.decode_step_batched(x_pe, 3, t(d["valid"]), bt(d["xa_k"]), bt(d["xa_v"]),
                                    bt(d["k"]), bt(d["v"]), pw, CONFIG, t(d["enc"]))
    want = torch.tensor(ref["hidden"])[:7]
    got = h[:7].float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    n_ulps = ((got - want).abs() / ulp)
    assert float(n_ulps.max()) <= 1 and float((n_ulps > 0).float().mean()) <= 0.01


# ---------------------------------------------------- the GEMM's products

@pytest.mark.parametrize("name", ["qkv", "sa_out", "xa_q", "xa_out", "ff_proj", "ff_out"])
def test_split_tf32_products_within_frame_tol(name):
    """The float32 kernel's products (split TF32: lo*hi + hi*lo + hi*hi) at
    the 357M decoder's shapes and B = 8, against float64: within FRAME_TOL,
    and within 4x plain float32's own error."""
    K, N = bg.frame_products(PROD)[name]
    rng = np.random.default_rng(K + N)
    x = torch.tensor(rng.normal(0, 1, (8, K)), dtype=torch.float32)
    w = torch.tensor(rng.normal(0, 0.02, (K, N)), dtype=torch.float32)
    exact = x.double() @ w.double()
    model = bg.split_tf32_products(x, w)
    err = float((model - exact).abs().max())
    plain = float((matmul_f32(x, w).double() - exact).abs().max())
    assert err <= FRAME_TOL and err <= 4 * plain + 1e-7, (err, plain)


def test_gemm_plain_partials_sum_to_the_product():
    """batched_gemm on CPU tensors (the plain version): partials [S, B, N]
    over the plan's splits, summing to x @ W; Q8_0 values dequantized as
    load_w4."""
    K, N = bg.frame_products(PROD)["ff_out"]
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(0, 1, (3, K)), dtype=torch.float32)
    w = torch.tensor(rng.normal(0, 0.02, (K, N)), dtype=torch.float32)
    part = bg.batched_gemm(x, K, N, w=w)
    assert part.shape == (bg.plan_gemm(K, N).splits, 3, N)
    torch.testing.assert_close(part.sum(0), x @ w, atol=1e-4, rtol=0)
    q = torch.tensor(rng.integers(-127, 128, (K, N)), dtype=torch.int8)
    s = torch.tensor(rng.normal(0, 0.01, (K // 32, N)), dtype=torch.float32)
    part = bg.batched_gemm(x, K, N, q=q, s=s, dtype=BF)
    wv = (s.repeat_interleave(32, 0) * q.float()).to(BF).float()
    torch.testing.assert_close(part.sum(0), x.to(BF).float() @ wv, atol=1e-3, rtol=0)
