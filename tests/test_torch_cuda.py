"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, and the decode loop / codec through the kernels, at small shapes.

Every test here needs a CUDA device and skips without one. This file imports
neither jax nor the JAX package, so it also runs where jax is not installed:
    MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q -m cuda
(``MAGPIE_TEST_TPU=1`` keeps tests/conftest.py from importing jax.)
"""

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.config import CodecConfig, MagpieConfig
from magpie_tts_tpu_torch.io.codec_weights import random_codec_weights
from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu_torch.models import magpie as magpie_mod
from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
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


def test_wrappers_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        cc.snake_causal_conv(torch.zeros(8, 4, device=cuda, dtype=torch.float64),
                             torch.zeros(3, 4, 4, device=cuda), torch.zeros(4, device=cuda),
                             None)
    with pytest.raises(ValueError):
        cc.snake_causal_conv(torch.zeros(8, 4, device=cuda), torch.zeros(3, 5, 4, device=cuda),
                             torch.zeros(4, device=cuda), None)
