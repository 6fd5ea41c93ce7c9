"""PyTorch port, models: encoder, decoder (prefill / step), LT sampler,
decode loop and codec against the JAX package's XLA functions, at the tiny
test configs. Floats agree to 1e-5 (codec 5e-5): only summation order and
the float32 libm of the two backends differ."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magpie_tts_tpu.io.codec_weights import random_codec_weights as j_random_codec
from magpie_tts_tpu.io.magpie_weights import random_magpie_weights as j_random_magpie
from magpie_tts_tpu.models import codec as jcodec
from magpie_tts_tpu.models import decoder as jdec
from magpie_tts_tpu.models import local_transformer as jlt
from magpie_tts_tpu.models import magpie as jmagpie
from magpie_tts_tpu.models.encoder import run_encoder as j_run_encoder
from magpie_tts_tpu.ops import sampling as js
from magpie_tts_tpu_torch.models import codec as tcodec
from magpie_tts_tpu_torch.models import decoder as tdec
from magpie_tts_tpu_torch.models import local_transformer as tlt
from magpie_tts_tpu_torch.models import magpie as tmagpie
from magpie_tts_tpu_torch.models.encoder import run_encoder
from magpie_tts_tpu_torch.ops import sampling as ts
from tests.test_torch_support import port_codec_weights, port_magpie_weights, t
from tests.utils import tiny_codec_config, tiny_magpie_config

C = tiny_magpie_config()
ENC_LEN = 9
ATOL = 1e-5


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def model():
    jw = j_random_magpie(C, seed=4)
    tokens = np.random.default_rng(4).integers(2, C.text_vocab_size - 2, size=16)
    return jw, port_magpie_weights(jw), tokens


@pytest.fixture(scope="module")
def prepared(model):
    jw, pw, tokens = model
    jout = jmagpie.prepare(jnp.asarray(tokens, jnp.int32), jnp.int32(ENC_LEN),
                           jnp.int32(1), jw, C)
    with torch.no_grad():
        tout = tmagpie.prepare(torch.from_numpy(tokens), ENC_LEN, 1, pw, C)
    return jout, tout


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_encoder_matches_jax(model, gelu):
    jw, pw, tokens = model
    c = dataclasses.replace(C, gelu_flavor=gelu)
    with torch.no_grad():
        got = run_encoder(torch.from_numpy(tokens), pw, c)
    close(got, j_run_encoder(jnp.asarray(tokens, jnp.int32), jw, c))


def test_encoder_padding_is_prefix_exact(model):
    """The encoder is causal: right-padding to a bucket leaves the valid rows."""
    _, pw, tokens = model
    padded = torch.cat([torch.from_numpy(tokens), torch.zeros(16, dtype=torch.int64)])
    with torch.no_grad():
        short = run_encoder(torch.from_numpy(tokens), pw, C)
        long = run_encoder(padded, pw, C)
    torch.testing.assert_close(long[:len(tokens)], short, atol=1e-6, rtol=0)


def test_prepare_matches_jax(prepared):
    """XA K/V precompute, context prefill + BOS step: xa_k/xa_v, caches and
    the first hidden."""
    (jxk, jxv, jst), (xk, xv, st) = prepared
    close(xk, jxk)
    close(xv, jxv)
    close(st.k_cache, jst.k_cache)
    close(st.v_cache, jst.v_cache)
    close(st.hidden, jst.hidden)
    assert st.pos == int(jst.pos) == C.context_frames + 1


@pytest.mark.parametrize("pos", [C.context_frames + 1, 30])
def test_decode_step_matches_jax(model, prepared, pos):
    jw, pw, _ = model
    (jxk, jxv, jst), _ = prepared
    x = np.random.default_rng(pos).normal(0, 0.02, size=C.d_model).astype(np.float32)
    jh, jk, jv = jdec.decode_step(jnp.asarray(x), jnp.int32(pos), jxk, jxv, jst.k_cache,
                                  jst.v_cache, jw, C, enc_length=jnp.int32(ENC_LEN))
    k, v = t(jst.k_cache), t(jst.v_cache)
    with torch.no_grad():
        h = tdec.decode_step(torch.from_numpy(x), pos, t(jxk), t(jxv), k, v, pw, C,
                             enc_length=ENC_LEN)
    close(h, jh)
    close(k, jk)
    close(v, jv)


@pytest.mark.parametrize("temperature,forbid", [(0.0, True), (0.0, False), (0.7, False)])
def test_lt_sampler_matches_jax(model, prepared, temperature, forbid):
    jw, pw, _ = model
    (_, _, jst), _ = prepared
    key = jax.random.PRNGKey(9)
    static = js.forbidden_token_mask(C.vocab_per_cb, C.audio_bos_id, C.audio_eos_id)
    js_, ja = jlt.sample_frame_codes(jst.hidden, jw, C, key, jnp.float32(temperature), 8,
                                     jnp.bool_(forbid), static)
    with torch.no_grad():
        s, a = tlt.sample_frame_codes(t(jst.hidden), pw, C, int(js.seed_from_key(key)),
                                      temperature, 8, forbid,
                                      ts.forbidden_token_mask(C.vocab_per_cb, C.audio_bos_id))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js_))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


def test_audio_frame_embedding_matches_jax(model):
    jw, pw, _ = model
    codes = np.random.default_rng(0).integers(0, C.vocab_per_cb, size=(3, 8)).astype(np.int32)
    close(tmagpie.audio_frame_embedding(torch.from_numpy(codes), pw, C),
          jmagpie.audio_frame_embedding(jnp.asarray(codes), jw, C), atol=1e-7)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_decode_loop_matches_jax(model, prepared, temperature):
    """The port's frame loop (host key chain, EOS rule, forbid_eos window)
    against the JAX XLA while_loop: same codes and frame count."""
    jw, pw, _ = model
    (jxk, jxv, jst), (xk, xv, st) = prepared
    jout = jmagpie.decode_loop(jxk, jxv, jst, jnp.int32(ENC_LEN), jw, C,
                               jax.random.PRNGKey(2), jnp.float32(temperature), 8,
                               use_pallas_lt=False, use_pallas_decoder=False,
                               use_fused=False)
    st = copy.copy(st)
    st.k_cache, st.v_cache, st.codes = st.k_cache.clone(), st.v_cache.clone(), st.codes.copy()
    with torch.no_grad():
        out = tmagpie.decode_loop(xk, xv, st, ENC_LEN, pw, C, ts.prng_key(2), temperature, 8)
    n = int(jout.frame_idx)
    assert out.frame_idx == n and out.done == bool(jout.done)
    np.testing.assert_array_equal(out.codes[:n], np.asarray(jout.codes[:n]))


@pytest.fixture(scope="module")
def codec():
    cfg = tiny_codec_config()
    jw = j_random_codec(cfg, seed=2)
    return cfg, jw, port_codec_weights(jw)


def test_fsq_dequantize_exact(codec):
    cfg, _, _ = codec
    codes = np.random.default_rng(1).integers(0, cfg.codebook_size, size=(8, 13)).astype(np.int32)
    np.testing.assert_array_equal(
        tcodec.fsq_dequantize(torch.from_numpy(codes), cfg).numpy(),
        np.asarray(jcodec.fsq_dequantize(jnp.asarray(codes), cfg)))


def test_half_snake_and_conv_transpose_match_jax(codec):
    cfg, jw, pw = codec
    stage, jstage = pw.stages[0], jw.stages[0]
    x = np.random.default_rng(3).normal(size=(1, 11, cfg.base_channels)).astype(np.float32)
    close(tcodec.half_snake(torch.from_numpy(x), stage.act_alpha),
          jcodec.half_snake(jnp.asarray(x), jstage.act_alpha))
    close(tcodec.grouped_conv_transpose1d(torch.from_numpy(x), stage.convt_w, stage.convt_b,
                                          cfg.up_sample_rates[0]),
          jcodec.grouped_conv_transpose1d(jnp.asarray(x), jstage.convt_w, jstage.convt_b,
                                          cfg.up_sample_rates[0]))


def test_codec_frame_bucket_padding_is_prefix_exact(codec):
    """CodecEngine pads to a frame bucket; the codec is causal, so the
    samples of the real frames equal an unpadded decode."""
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine

    cfg, _, pw = codec
    codes = np.random.default_rng(6).integers(0, cfg.codebook_size, size=(9, 8)).astype(np.int32)
    got = CodecEngine(pw, cfg, device="cpu", frame_buckets=(32,)).decode(codes)
    with torch.no_grad():
        want = tcodec.codec_decode(torch.from_numpy(codes.T.copy()), pw, cfg)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6, rtol=0)


def test_codec_decode_matches_jax(codec):
    cfg, jw, pw = codec
    codes = np.random.default_rng(5).integers(0, cfg.codebook_size, size=(8, 24)).astype(np.int32)
    want = jax.jit(lambda w, c: jcodec.codec_decode(c, w, cfg, use_pallas=False))(
        jw, jnp.asarray(codes))
    with torch.no_grad():
        got = tcodec.codec_decode(torch.from_numpy(codes), pw, cfg)
    assert got.shape == (24 * cfg.hop_length,)
    close(got, want, atol=5e-5)
