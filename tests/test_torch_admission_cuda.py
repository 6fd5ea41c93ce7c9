"""Batched admission (``models.magpie.prepare_batch``) on the card, at 357M.

Each test needs a CUDA device and skips without one; the file imports neither
jax nor the JAX package:
    MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_admission_cuda.py -q -m cuda

Row i of a group of M = 2, 8, 32 (mixed encoder lengths, 1 and the full
bucket among them, and every speaker) against request i's ``prepare`` alone,
in float32 and bf16: cuBLAS picks its algorithm by shape, so a row may differ
from the request alone in the last bits (float32 ~2e-6 of the largest
value; in bf16 every later rounding spreads a flipped value). The bars are
chip_smoke's: ROW_REL (float32), and ROW_ULP_SHARE within 1 scaled ulp and
none past ROW_ULP_MAX (bf16, scaled ulps as chip_smoke.scaled_ulps). A group
of 8 or 32 launches about as much device work as a group of 1 (one pass, no
loop over requests), and float32 serve codes at temp 0 are the same whether
the continuous engine admits in groups or one request a group (each inside
the group's CUDA graph).
"""

import dataclasses

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.config import MagpieConfig
from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu_torch.models import magpie as magpie_mod
from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
from magpie_tts_tpu_torch.runtime import engine as engine_mod

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
BUCKET = 32
M_MAX = 32
# A row of a group against the request alone: float32 max |diff| over the
# tensor's max |value|; bf16 share within 1 scaled ulp and max scaled ulps.
ROW_REL = 1e-5
ROW_ULP_SHARE, ROW_ULP_MAX = 0.5, 16.0


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return engine_mod.resolve_device("cuda")


@pytest.fixture(scope="module")
def weights(card):
    c = MagpieConfig()
    w = random_magpie_weights(c, seed=0).to(device=card)
    return c, {torch.float32: w, BF: magpie_mod.float32_products(w.to(dtype=BF))}


def _requests(c, card):
    rng = np.random.default_rng(14)
    lens = [int(n) for n in rng.integers(1, BUCKET + 1, M_MAX)]
    lens[0], lens[1] = 1, BUCKET
    tokens = np.zeros((M_MAX, BUCKET), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(2, c.text_vocab_size - 2, n)
    return torch.from_numpy(tokens).to(card), lens, [i % c.num_speakers for i in range(M_MAX)]


def scaled_ulps(got, want):
    """|got - want| in bf16 ulps of max(|want|, the RMS of want's row)."""
    g, w = got.float(), want.float()
    ref = torch.maximum(w.abs(), w.pow(2).mean(-1, keepdim=True).sqrt()).clamp_min(1e-30)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(ref)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["float32", "bf16"])
def test_rows_against_request_alone(card, weights, dtype):
    c, ws = weights
    w = ws[dtype]
    tokens, lens, spk = _requests(c, card)
    with torch.no_grad():
        alone = [magpie_mod.prepare_batch(tokens[i:i + 1], lens[i:i + 1], spk[i:i + 1], w, c)
                 for i in range(M_MAX)]
        for m in (2, 8, 32):
            got = magpie_mod.prepare_batch(tokens[:m], lens[:m], spk[:m], w, c)
            for k, name in enumerate(("xa_k", "xa_v", "k_rows", "v_rows", "hidden")):
                g = got[k]
                a = torch.cat([alone[i][k] for i in range(m)])
                assert g.dtype == dtype and g.shape == a.shape and torch.isfinite(g).all()
                if dtype == BF:
                    d = scaled_ulps(g, a)
                    share, worst = float((d <= 1).float().mean()), float(d.max())
                    assert share >= ROW_ULP_SHARE and worst <= ROW_ULP_MAX, \
                        f"{name} M={m}: {share} within 1 ulp, max {worst}"
                else:
                    rel = float((g - a).abs().max() / a.abs().max())
                    assert rel <= ROW_REL, f"{name} M={m}: {rel}"


def _device_work(fn) -> int:
    """Device kernels, copies and fills of one fn() call (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def test_device_work_does_not_grow_with_the_group(card, weights):
    """One pass, not a loop over requests: a group of 8 or 32 launches within
    10% of the device work of a group of 1 (a loop would launch 8x and 32x).
    The counts are not equal: cuBLAS picks split-K (a reduce kernel and a
    fill) or GEMV kernels by shape, and PyTorch copies some M = 1 views with
    a memcpy where M > 1 takes a copy kernel (1846 / 1949 kernels at M = 1
    / 8, float32, H100)."""
    c, ws = weights
    tokens, lens, spk = _requests(c, card)
    with torch.no_grad():
        n = {m: _device_work(lambda: magpie_mod.prepare_batch(
            tokens[:m], lens[:m], spk[:m], ws[torch.float32], c)) for m in (1, 8, 32)}
    assert n[1] > 0 and all(abs(n[m] - n[1]) <= 0.1 * n[1] for m in (8, 32)), n


def test_serve_codes_grouped_equal_one_a_group(card, weights, monkeypatch):
    """float32, temp 0: eight requests admitted as one group of 8 (one call
    of the engine's ``PrepareGraphs``, replaying the graph of (bucket, 8))
    against the same requests, slots and ring rows with each row's
    ``prepare_rows`` run alone inside that graph."""
    c, ws = weights
    cfg = dataclasses.replace(c, max_dec_steps=48)
    tokens, lens, spk = _requests(c, card)
    reqs = [tokens[i, :lens[i]].tolist() for i in range(8)]

    def run():
        eng = ContinuousBatchingEngine(ws[torch.float32], cfg, n_slots=8, device=card,
                                       token_buckets=(BUCKET,), segment_frames=16)
        ids = [eng.submit(r, speaker_id=spk[i], seed=i) for i, r in enumerate(reqs)]
        done = {}
        while eng.pending:
            done.update(eng.step(temperature=0.0, top_k=1))
        assert dict(eng._prepare.calls) == {(BUCKET, 8): 1}
        return [done[i] for i in ids]

    grouped = run()
    real = magpie_mod.prepare_rows

    def one_a_group(tok, enc, sp, w, config):
        rows = [real(tok[i:i + 1], enc[i:i + 1], sp[i:i + 1], w, config)
                for i in range(tok.shape[0])]
        return tuple(torch.cat(parts) for parts in zip(*rows))
    monkeypatch.setattr(magpie_mod, "prepare_rows", one_a_group)
    alone = run()
    for i, (g, a) in enumerate(zip(grouped, alone)):
        assert g.shape[0] > 0
        np.testing.assert_array_equal(g, a, err_msg=f"request {i}")
