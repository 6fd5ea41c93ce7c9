"""PyTorch port, kernels: each kernel's plain PyTorch version against the
Pallas TPU kernel it replaces, run in interpret mode on the CPU (as
tests/test_pallas_kernels.py runs them). The CUDA kernels themselves are
tested on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magpie_tts_tpu.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu.models import magpie as jmagpie
from magpie_tts_tpu.ops.pallas_kernels import codec_conv as jcc
from magpie_tts_tpu.ops.pallas_kernels.frame_step import frame_step_pallas
from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
from tests.test_torch_support import port_magpie_weights, t
from tests.utils import tiny_magpie_config

CONFIG = tiny_magpie_config()
ENC_LEN = 6


@pytest.fixture(scope="module")
def frame_inputs():
    """JAX weights + the state after prepare() (BOS step done), and the
    same as port tensors."""
    rng = np.random.default_rng(7)
    jw = random_magpie_weights(CONFIG, seed=11)
    tokens = jnp.asarray(rng.integers(2, CONFIG.text_vocab_size - 2, size=8), jnp.int32)
    xa_k, xa_v, st = jmagpie.prepare(tokens, jnp.int32(ENC_LEN), jnp.int32(0), jw, CONFIG)
    return jw, port_magpie_weights(jw), xa_k, xa_v, st


# Frame step: 2 interpret calls (~10 s each); codes exact, floats to 1e-5
# (the Pallas kernel's GELU uses an erf approximation, |err| < 1.5e-7).
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_frame_step_reference_matches_pallas_interpret(frame_inputs, temperature):
    jw, pw, xa_k, xa_v, st = frame_inputs
    seed = 3
    s_j, a_j, h_j, k_j, v_j = frame_step_pallas(
        st.hidden, st.pos, xa_k, xa_v, st.k_cache, st.v_cache, jw, CONFIG, jnp.int32(seed),
        jnp.float32(temperature), 8, jnp.bool_(False), enc_length=jnp.int32(ENC_LEN),
        interpret=True)
    k_p, v_p = t(st.k_cache), t(st.v_cache)
    with torch.no_grad():
        s_p, a_p, h_p, _, _ = fs.frame_step(t(st.hidden), int(st.pos), t(xa_k), t(xa_v), k_p,
                                            v_p, pw, CONFIG, seed, temperature, 8, False,
                                            enc_length=ENC_LEN)
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(k_p.numpy(), np.asarray(k_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(v_p.numpy(), np.asarray(v_j), atol=1e-5, rtol=0)


def _conv_case(rng, T, cin, cout, k, alpha_n, residual):
    x = rng.normal(0, 0.5, size=(T, cin)).astype(np.float32)
    w = rng.normal(0, 0.1, size=(k, cin, cout)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    alpha = None if alpha_n is None else rng.uniform(0.4, 1.4, size=(alpha_n,)).astype(np.float32)
    res = rng.normal(0, 0.5, size=(T, cout)).astype(np.float32) if residual else None
    return x, w, b, alpha, res


def _opt(x, fn):
    return None if x is None else fn(x)


# atol 1e-4: the Pallas kernel's sine is a polynomial (_fast_sin), the plain
# version's is libm sin.
@pytest.mark.parametrize("T,cin,cout,k,d,alpha_n,residual", [
    (100, 27, 27, 11, 5, 13, False),
    (64, 32, 864, 7, 1, None, False),      # pre-conv: no activation
    (300, 108, 108, 7, 3, 54, True),       # res-block skip conv with the residual
    (30, 432, 432, 3, 1, 216, False),
])
def test_conv_reference_matches_pallas_interpret(T, cin, cout, k, d, alpha_n, residual):
    x, w, b, alpha, res = _conv_case(np.random.default_rng(T), T, cin, cout, k, alpha_n,
                                     residual)
    want = jcc.snake_causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                 _opt(alpha, jnp.asarray), dilation=d, tile=128,
                                 interpret=True, residual=_opt(res, jnp.asarray))
    got = cc.snake_causal_conv(t(x), t(w), t(b), _opt(alpha, t), d, 0.01,
                               residual=_opt(res, t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("T,cin,cout,k,d,alpha_n,residual", [
    (259, 54, 54, 11, 5, 27, False),
    (200, 27, 27, 7, 3, 13, True),
    (301, 27, 1, 3, 1, 13, False),         # post-conv 27 -> 1
])
def test_conv_reference_matches_packed_pallas_interpret(T, cin, cout, k, d, alpha_n,
                                                        residual):
    """The TPU's time-packed variant (C <= 64) is the same function: the port
    runs it unpacked."""
    x, w, b, alpha, res = _conv_case(np.random.default_rng(T), T, cin, cout, k, alpha_n,
                                     residual)
    p = jcc.pick_pack(cin, cout)
    assert p > 1
    y = jcc.snake_causal_conv_packed(
        jcc.pack_time(jnp.asarray(x), p), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(alpha), cin, p, dilation=d, interpret=True,
        residual=_opt(res, lambda r: jcc.pack_time(jnp.asarray(r), p)))
    want = jcc.unpack_time(y, p, T, cout)
    got = cc.snake_causal_conv(t(x), t(w), t(b), t(alpha), d, 0.01, residual=_opt(res, t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_kernel_wrappers_count_no_cpu_launches(frame_inputs):
    """On CPU tensors the wrappers run the plain versions: no kernel launch
    is counted, so a main-path count can only come from the card."""
    _, pw, xa_k, xa_v, st = frame_inputs
    fs.launches = cc.launches = 0
    with torch.no_grad():
        fs.frame_step(t(st.hidden), int(st.pos), t(xa_k), t(xa_v), t(st.k_cache),
                      t(st.v_cache), pw, CONFIG, 1, 0.0, 8, True, enc_length=ENC_LEN)
        cc.snake_causal_conv(torch.zeros(5, 4), torch.zeros(3, 4, 4), torch.zeros(4), None)
    assert fs.launches == 0 and cc.launches == 0
