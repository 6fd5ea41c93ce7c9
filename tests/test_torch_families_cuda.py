"""The redesigned families of the batched frame kernels on the card: the
split-row attention (csrc/frame_kernels.cuh ``attend``, shared by kernels A,
5, C and 8) and the tensor-core batched GEMM (csrc/frame_step_batched.cu,
kernels C, 7 and 8), each against its plain version, and a slot's results
independent of the batch it runs in. Marked ``cuda``: they skip without a
card. This module imports no JAX (the card's machine has none); run it there
with ``MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_families_cuda.py -q
-m cuda``."""

import dataclasses

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.config import MagpieConfig
from magpie_tts_tpu_torch.io.magpie_weights import (q8_dequantized_decoder, q8_stream_from_arrays,
                                                     random_magpie_weights)
from magpie_tts_tpu_torch.ops.attention import attn_scale
from magpie_tts_tpu_torch.ops.kernels import batched_gemm as bg
from magpie_tts_tpu_torch.ops.kernels import decode_attention as da
from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
from magpie_tts_tpu_torch.runtime import engine as engine_mod

pytestmark = pytest.mark.cuda

PROD = MagpieConfig()
BF = torch.bfloat16
# One attention alone: its float32 sums run in another order than plain's.
ATTN_TOL = 1e-5
# A product's partials: float32 sums in another order; float32 products carry
# split TF32's ~21 bits a operand (2^-21 of a product), far inside the frame's
# 1e-4 on O(1) values.
GEMM_REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return engine_mod.resolve_device("cuda")


def _scaled_ulps(got, want):
    """|got - want| in bf16 ulps of max(|want|, its row's RMS)."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    mag = torch.maximum(want.abs(), rms).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got - want).abs() / ulp).flatten()


def _bf16_close(got, want, share=0.95, most=8.0):
    d = _scaled_ulps(got, want)
    assert float((d <= 1).float().mean()) >= share and float(d.max()) <= most, \
        f"{float((d <= 1).float().mean()):.4f} within 1 ulp, max {float(d.max())}"


def _self_inputs(B, rows, dtype, dev, seed=0):
    """Cache layer 1 of [B, 2, 640, 768] caches, ring masks over [0, rows)
    that wrap (runs that restart at row 0), the last slot with no valid
    row; the write row taken from new_valid."""
    rng = np.random.default_rng(seed + B + rows)
    S, D = PROD.max_seq, PROD.d_model
    f = lambda *s, sd=0.5: torch.tensor(rng.normal(0, sd, s), dtype=torch.float32,
                                        device=dev).to(dtype)
    k, v = f(B, 2, S, D), f(B, 2, S, D)
    valid = np.zeros((B, S), bool)
    for b in range(B - 1 if B > 1 else B):
        start, n = int(rng.integers(0, rows)), int(rng.integers(1, rows + 1))
        valid[b, (start + np.arange(n)) % rows] = True
    write_row = rows - 1
    new_valid = torch.tensor(rng.random(B) < 0.8, dtype=torch.int32, device=dev)
    if B > 1:
        new_valid[-1] = 0
    q = torch.tensor(rng.normal(0, 1, (B, D)), dtype=torch.float32, device=dev)
    return dict(q=q, k=k[:, 1], v=v[:, 1], heads=PROD.dec_sa_heads,
                scale=attn_scale(D // PROD.dec_sa_heads), rows=rows,
                valid=torch.tensor(valid, device=dev), write_row=write_row, new_valid=new_valid)


def _cross_inputs(B, dtype, dev, E=64):
    """Cross-attention: one head of 128, q as 3 partials, enc_lengths 1..E."""
    rng = np.random.default_rng(B)
    X = PROD.d_xa
    f = lambda *s: torch.tensor(rng.normal(0, 0.5, s), dtype=torch.float32, device=dev)
    kx, vx = f(B, 2, E, X).to(dtype), f(B, 2, E, X).to(dtype)
    enc = torch.tensor(np.linspace(1, E, B).round(), dtype=torch.int32, device=dev)
    return dict(q=f(3, B, X), k=kx[:, 0], v=vx[:, 0], heads=PROD.dec_xa_heads,
                scale=attn_scale(X // PROD.dec_xa_heads), rows=E, rows_dev=enc)


def _close(got, want, dtype):
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= ATTN_TOL
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("rows", [1, 17, 300, 640])
@pytest.mark.parametrize("B", [1, 3, 8, 32, 64])
def test_attention_kernel_matches_plain(cuda, B, rows, dtype):
    """Self-attention over [0, rows) of a 640-row cache, masks that wrap, a
    slot with no valid row, the write row from new_valid: against plain."""
    x = _self_inputs(B, rows, dtype, cuda)
    got = da.decode_attention(**x)
    torch.cuda.synchronize()
    want = da.decode_attention_reference(**x)
    assert torch.isfinite(got).all()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("B", [1, 3, 8, 32, 64])
def test_cross_attention_kernel_matches_plain(cuda, B, dtype):
    """Cross-attention: q from split partials, each slot's enc_lengths rows
    (1 to E)."""
    x = _cross_inputs(B, dtype, cuda)
    got = da.decode_attention(**x)
    torch.cuda.synchronize()
    _close(got, da.decode_attention_reference(**x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_attention_bound_keeps_the_bits(cuda, dtype):
    """No valid row lies past the bound: an attention bounded to 217 rows
    gives the bits of one over all max_seq rows (the slots with a valid
    row; the empty one attends uniformly over its window)."""
    x = _self_inputs(8, 217, dtype, cuda)
    got = da.decode_attention(**x)
    full = da.decode_attention(**dict(x, rows=PROD.max_seq))
    torch.cuda.synchronize()
    assert torch.equal(got[:7], full[:7])


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_attention_slot_independent_of_batch(cuda, dtype):
    """Slots 0..2 give the same bits at B = 3, 8 and 32."""
    big = _self_inputs(32, 300, dtype, cuda)
    outs = []
    for B in (3, 8, 32):
        x = dict(big, q=big["q"][:B].contiguous(), k=big["k"][:B], v=big["v"][:B],
                 valid=big["valid"][:B].contiguous(), new_valid=big["new_valid"][:B].contiguous())
        outs.append(da.decode_attention(**x)[:3])
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def _product_inputs(K, N, B, dtype, dev, seed=0):
    rng = np.random.default_rng(seed + K + N + B)
    x = torch.tensor(rng.normal(0, 1, (B, K)), dtype=torch.float32, device=dev)
    w = torch.tensor(rng.normal(0, 0.02, (K, N)), dtype=torch.float32, device=dev).to(dtype)
    return x, w


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("B", [1, 8, 33, 64])
def test_gemm_kernel_matches_plain_dense(cuda, B, dtype):
    """Every product class of the 357M frame, dense, against plain."""
    for name, (K, N) in bg.frame_products(PROD).items():
        x, w = _product_inputs(K, N, B, dtype, cuda)
        got = bg.batched_gemm(x, K, N, w=w)
        torch.cuda.synchronize()
        want = bg.batched_gemm_reference(x, K, N, dtype, w=w)
        err = float((got - want).abs().max())
        assert err <= GEMM_REL * float(want.abs().max()) + 1e-7, (name, err)


@pytest.fixture(scope="module")
def prod_q8():
    """A Q8_0 stream of random 357M decoder weights and its dequantized copy."""
    w = random_magpie_weights(PROD, seed=3)
    q8 = q8_stream_from_arrays(w.decoder)
    return q8, q8_dequantized_decoder(w.decoder, q8)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("B", [3, 32])
def test_gemm_streams_q8_bit_equal_dense_int8_match_plain(cuda, prod_q8, B, dtype):
    """The four streamed products: Q8_0 bit-equal to dense on the weights
    dequantized in T and against plain; int8 (column scales left to the
    reducer) against plain."""
    q8, deq = prod_q8
    for name, (K, N) in bg.frame_products(PROD).items():
        if name not in ("qkv", "sa_out", "ff_proj", "ff_out"):
            continue
        q = getattr(q8, f"{name}_q")[0].to(cuda)
        bs = getattr(q8, f"{name}_bs")[0].to(cuda)
        dense = getattr(deq, name)[0].to(cuda, dtype)
        x = torch.randn(B, K, generator=torch.Generator().manual_seed(K + N)).to(cuda)
        got_q8 = bg.batched_gemm(x, K, N, q=q, s=bs, dtype=dtype)
        got_dense = bg.batched_gemm(x, K, N, w=dense)
        cs = torch.rand(N, device=cuda)
        got_i8 = bg.batched_gemm(x, K, N, q=q, s=cs, dtype=dtype)
        torch.cuda.synchronize()
        assert torch.equal(got_q8, got_dense), name
        want = bg.batched_gemm_reference(x, K, N, dtype, q=q, s=bs, mode="q8")
        assert float((got_q8 - want).abs().max()) <= GEMM_REL * float(want.abs().max()), name
        want = bg.batched_gemm_reference(x, K, N, dtype, q=q, s=cs, mode="int8")
        err = float((got_i8 - want).abs().max())
        assert err <= GEMM_REL * float(want.abs().max()), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_gemm_slot_independent_of_batch(cuda, dtype):
    """A slot's partials are bit-equal at B = 3, 8, 32 and 64."""
    K, N = bg.frame_products(PROD)["ff_out"]
    x, w = _product_inputs(K, N, 64, dtype, cuda)
    outs = [bg.batched_gemm(x[:B].contiguous(), K, N, w=w)[:, :3] for B in (3, 8, 32, 64)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


SMALL = MagpieConfig(
    d_model=64, d_ffn=128, d_head=16, enc_layers=2, enc_heads=4, enc_kernel=3,
    dec_layers=2, dec_sa_heads=4, dec_xa_heads=1, dec_xa_d_head=32, dec_kernel=1,
    lt_dim=32, lt_ffn_dim=64, lt_layers=1, lt_heads=1, text_vocab_size=100,
    num_codebooks=8, codebook_size=32, vocab_per_cb=40, num_speakers=2,
    context_frames=6, text_bos_id=98, text_eos_id=99, audio_bos_id=32, audio_eos_id=33,
    context_bos_id=34, context_eos_id=35, mask_token_id=36, max_dec_steps=16,
    min_generated_frames=2, max_pos=128)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_frame_slot_independent_of_batch(cuda, dtype):
    """Kernels C and 8: slots 0..2's codes, hidden rows and cache rows are
    bit-equal whether they run at B = 3, 8 or 32."""
    c = SMALL
    w = random_magpie_weights(c, seed=11).to(device=cuda, dtype=dtype)
    rng = np.random.default_rng(0)
    Bmax, L, S, D, E, write_row = 32, c.dec_layers, c.max_seq, c.d_model, 16, 20
    f = lambda *s, sd=0.5: torch.tensor(rng.normal(0, sd, s), dtype=torch.float32,
                                        device=cuda).to(dtype)
    valid = np.zeros((Bmax, S), bool)
    for b in range(Bmax):
        valid[b, (write_row + 1 + b + np.arange(6 + b % 9)) % S] = True
    valid[:, write_row] = False
    full = dict(hidden=f(Bmax, D, sd=1.0), valid=torch.tensor(valid, device=cuda),
                may_continue=torch.ones(Bmax, dtype=torch.bool, device=cuda),
                posemb=w.decoder.pos_emb[torch.tensor(rng.integers(0, 100, Bmax), device=cuda)],
                xa_k=f(Bmax, L, E, c.d_xa), xa_v=f(Bmax, L, E, c.d_xa),
                enc_lengths=torch.tensor(rng.integers(1, E + 1, Bmax), dtype=torch.int32,
                                         device=cuda),
                seeds=torch.tensor(rng.integers(-2**31, 2**31, Bmax), dtype=torch.int32,
                                   device=cuda),
                forbid_eos=torch.zeros(Bmax, dtype=torch.bool, device=cuda))
    k0, v0 = f(Bmax, L, S, D), f(Bmax, L, S, D)
    runs = []
    for B in (3, 8, 32):
        x = {key: t[:B].contiguous() for key, t in full.items()}
        kc, vc, k8, v8 = (t[:B].clone() for t in (k0, v0, k0, v0))
        with torch.no_grad():
            s, a, h, _, _ = fsb.frame_step_batched(write_row=write_row, k_cache=kc, v_cache=vc,
                                                   weights=w, config=c, temperature=0.7,
                                                   top_k=8, rows=S, **x)
            valid8 = x["valid"].clone()
            valid8[:, write_row] = True
            h8 = dsb.decode_step_batched(x["hidden"], write_row, valid8, x["xa_k"], x["xa_v"],
                                         k8, v8, w, c, x["enc_lengths"])
        runs.append((s[:3], a[:3], h[:3], kc[:3, :, write_row], vc[:3, :, write_row], h8[:3],
                     k8[:3, :, write_row], v8[:3, :, write_row]))
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(p, q) for p, q in zip(runs[0], other))


def test_family_wrappers_reject_bad_inputs(cuda):
    x = _self_inputs(2, 17, torch.float32, cuda)
    with pytest.raises(ValueError):    # rows past the cache
        da.decode_attention(**dict(x, rows=PROD.max_seq + 1))
    with pytest.raises(ValueError):    # k / v rows must be contiguous
        da.decode_attention(**dict(x, k=x["k"].transpose(1, 2)))
    K, N = bg.frame_products(PROD)["qkv"]
    xx, w = _product_inputs(K, N, 2, torch.float32, cuda)
    with pytest.raises(ValueError):    # x must be [B, K]
        bg.batched_gemm(xx[:, :K - 4].contiguous(), K, N, w=w)
    with pytest.raises(ValueError):    # at most 64 slots
        bg.batched_gemm(torch.zeros(65, K, device=cuda), K, N, w=w)

def test_gemm_refuses_a_plan_it_does_not_take(cuda, monkeypatch):
    """kchunk not a whole number of 32-row stages: the kernel refuses it."""
    K, N = bg.frame_products(PROD)["qkv"]
    x, w = _product_inputs(K, N, 2, torch.float32, cuda)
    bad = dataclasses.replace(bg.plan_gemm(K, N), kchunk=48, splits=16)
    monkeypatch.setattr(bg, "plan_gemm", lambda *a, **k: bad)
    with pytest.raises(RuntimeError):
        bg.batched_gemm(x, K, N, w=w)
