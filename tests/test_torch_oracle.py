"""PyTorch port, the verification oracle: golden files, the uncached standard
path and its building blocks, and the per-layer traces, against the JAX
package on the CPU at the tiny configs (inputs and weights made from seeds
with numpy)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magpie_tts_tpu.io import golden as jgolden
from magpie_tts_tpu.io import trace_forward as jtrace
from magpie_tts_tpu.io.codec_weights import random_codec_weights as j_random_codec
from magpie_tts_tpu.io.magpie_weights import random_magpie_weights as j_random_magpie
from magpie_tts_tpu.models import decoder as jdec
from magpie_tts_tpu.models import encoder as jenc
from magpie_tts_tpu.models import magpie as jmagpie
from magpie_tts_tpu.models import standard as jstd
from magpie_tts_tpu_torch.io import golden
from magpie_tts_tpu_torch.io import trace_forward as ttrace
from magpie_tts_tpu_torch.models import decoder as tdec
from magpie_tts_tpu_torch.models import encoder as tenc
from magpie_tts_tpu_torch.models import magpie as tmagpie
from magpie_tts_tpu_torch.models import standard as tstd
from magpie_tts_tpu_torch.runtime.engine import MagpieEngine
from tests.test_torch_support import port_codec_weights, port_magpie_weights, t
from tests.utils import tiny_codec_config, tiny_magpie_config

C = tiny_magpie_config()
CC = tiny_codec_config()
ATOL = 1e-5        # float32 traces and blocks
CODEC_ATOL = 5e-5  # codec intermediates
TOKENS = [C.text_bos_id, 5, 9, 17, 3, 41, 22, C.text_eos_id]


@pytest.fixture(scope="module")
def model():
    jw = j_random_magpie(C, seed=11)
    return jw, port_magpie_weights(jw)


@pytest.fixture(scope="module")
def codec():
    jw = j_random_codec(CC, seed=2)
    return jw, port_codec_weights(jw)


def _close(got, want, atol=ATOL, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


# ------------------------------------------------------------------ golden

@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4), (2, 1, 3, 5), (4, 1), ()])
def test_golden_bytes_equal_jax_and_round_trip(tmp_path, shape):
    x = np.random.default_rng(sum(shape) + 1).normal(size=shape).astype(np.float32)
    golden.write_golden(str(tmp_path / "t.bin"), x)
    jgolden.write_golden(str(tmp_path / "j.bin"), x)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    back = golden.read_golden(str(tmp_path / "t.bin"))
    np.testing.assert_array_equal(back, jgolden.read_golden(str(tmp_path / "j.bin")))
    # trailing 1-dims are dropped, as the JAX reader drops them
    kept = list(shape) or [1]
    while len(kept) > 1 and kept[-1] == 1:
        kept.pop()
    assert back.shape == tuple(kept)
    np.testing.assert_array_equal(back, x.reshape(kept))


def test_golden_refuses_five_dims(tmp_path):
    with pytest.raises(ValueError):
        golden.write_golden(str(tmp_path / "x.bin"), np.zeros((1, 1, 1, 1, 2)))


# ---------------------------------------------------------- building blocks

def test_encoder_layer_matches_jax(model):
    jw, pw = model
    x = np.random.default_rng(0).normal(size=(12, C.d_model)).astype(np.float32)
    for l in range(C.enc_layers):
        e = jw.encoder
        jl = jenc.encoder_layer(jnp.asarray(x), (e.norm_self[l], e.qkv[l], e.sa_out[l],
                                                 e.norm_ff[l], e.ff_proj[l], e.ff_out[l]), C)
        tl = tenc.encoder_layer(t(x), tenc.layer_weights(pw.encoder, l), C)
        _close(tl, jl, name=f"layer {l}")


def test_run_encoder_is_its_layers(model):
    _, pw = model
    tok = torch.tensor(TOKENS)
    x = pw.text_emb[tok] + pw.encoder.pos_emb[:len(TOKENS)]
    for l in range(C.enc_layers):
        x = tenc.encoder_layer(x, tenc.layer_weights(pw.encoder, l), C)
    from magpie_tts_tpu_torch.ops.norms import layer_norm

    assert torch.equal(tenc.run_encoder(tok, pw, C), layer_norm(x, pw.encoder.norm_out, C.eps))


@pytest.mark.parametrize("speaker", [0, 1])
def test_speaker_context_matches_jax(model, speaker):
    jw, pw = model
    np.testing.assert_array_equal(tmagpie.speaker_context(pw, speaker).numpy(),
                                  np.asarray(jmagpie.speaker_context(jw, jnp.int32(speaker))))


@pytest.mark.parametrize("enc_length", [None, 5])
def test_decode_full_matches_jax(model, enc_length):
    jw, pw = model
    rng = np.random.default_rng(3)
    dec_input = rng.normal(size=(C.context_frames + 4, C.d_model)).astype(np.float32)
    enc_out = rng.normal(size=(len(TOKENS), C.d_model)).astype(np.float32)
    want = jdec.decode_full(jnp.asarray(dec_input), jnp.asarray(enc_out), jw, C,
                            None if enc_length is None else jnp.int32(enc_length))
    got = tdec.decode_full(t(dec_input), t(enc_out), pw, C, enc_length)
    _close(got, want)


def test_final_projection_matches_jax(model):
    jw, pw = model
    h = np.random.default_rng(5).normal(size=(3, C.d_model)).astype(np.float32)
    got = tstd.final_projection(t(h), pw)
    assert got.dtype == torch.float32
    assert got.shape == (3, C.num_codebooks * C.vocab_per_cb)
    _close(got, jstd.final_projection(jnp.asarray(h), jw))


def test_decode_full_bos_row_is_prepare_hidden(model):
    """Row context_frames of decode_full over [context; BOS] is the BOS-step
    hidden that prepare computes with its cache: within 1e-6 (the CPU BLAS
    sums a one-row product in another order than a seven-row one)."""
    _, pw = model
    tok = torch.tensor(TOKENS)
    with torch.no_grad():
        _, _, state = tmagpie.prepare(tok, len(TOKENS), 1, pw, C)
        bos = torch.full((C.num_codebooks,), C.audio_bos_id, dtype=torch.int32)
        dec_input = torch.cat([tmagpie.speaker_context(pw, 1),
                               tmagpie.audio_frame_embedding(bos, pw, C)[None]])
        full = tdec.decode_full(dec_input, tenc.run_encoder(tok, pw, C), pw, C)
    assert full.shape == (C.context_frames + 1, C.d_model)
    _close(full[-1], state.hidden, atol=1e-6)


# ------------------------------------------------------------ standard path

@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_standard_path_codes_equal_jax(model, temperature):
    jw, pw = model
    want = jstd.synthesize_codes_standard(TOKENS, jw, C, speaker_id=1, temperature=temperature,
                                          seed=6, max_steps=3)
    got = tstd.synthesize_codes_standard(TOKENS, pw, C, speaker_id=1, temperature=temperature,
                                         seed=6, max_steps=3)
    assert got.dtype == np.int32 and len(got) == 3
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.7, 6)])
def test_standard_path_equals_cached_engine(model, temperature, seed):
    """At temperature 0 the oracle's codes are the cached engine's; at 0.7
    too, since both draw step i's noise from the same key chain."""
    _, pw = model
    std = tstd.synthesize_codes_standard(TOKENS, pw, C, temperature=temperature, seed=seed,
                                         max_steps=8)
    engine = MagpieEngine(pw, C, device="cpu", token_buckets=(len(TOKENS),))
    fast = engine.synthesize_codes(TOKENS, temperature=temperature, seed=seed)
    assert len(std) == min(fast.n_frames, 8) and len(std) >= 3
    np.testing.assert_array_equal(std, fast.codes[:len(std)])


def test_standard_path_dequantizes_q8_blocks(model):
    """Block-stored weights are materialized first: the codes are those of
    the same weights dequantized at load."""
    from magpie_tts_tpu_torch.io.magpie_weights import Q8Blocks, materialize_weights
    from magpie_tts_tpu_torch.io.quant import quantize_q8_0, split_q8_0

    _, pw = model
    w = pw.final_proj_w.T.contiguous().numpy()                       # torch [out, in]
    q, s = split_q8_0(np.frombuffer(quantize_q8_0(w), np.uint8), w.size)
    blocks = Q8Blocks(q=torch.from_numpy(q.reshape(-1, 32)), s=torch.from_numpy(s[:, None]),
                      torch_shape=w.shape, transform="linear")
    import dataclasses

    wq = dataclasses.replace(pw, final_proj_w=blocks)
    dense = materialize_weights(wq)
    h = torch.randn(C.d_model, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tstd.final_projection(h, wq), tstd.final_projection(h, dense))
    assert np.array_equal(tstd.synthesize_codes_standard(TOKENS, wq, C, max_steps=3),
                          tstd.synthesize_codes_standard(TOKENS, dense, C, max_steps=3))


# ------------------------------------------------------------------- traces

def test_trace_encoder_matches_jax(model):
    jw, pw = model
    want = jtrace.trace_encoder(jnp.asarray(TOKENS, jnp.int32), jw, C)
    got = ttrace.trace_encoder(torch.tensor(TOKENS), pw, C)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.float32
        _close(got[name], want[name], name=name)


@pytest.mark.parametrize("n_frames", [0, 3])
def test_trace_decoder_matches_jax(model, n_frames):
    jw, pw = model
    rng = np.random.default_rng(9)
    enc_out = rng.normal(size=(len(TOKENS), C.d_model)).astype(np.float32)
    frames = rng.integers(0, C.codebook_size, size=(n_frames, C.num_codebooks)).astype(np.int32)
    want = jtrace.trace_decoder(jnp.asarray(enc_out), jw, C, speaker_id=1, frames=frames)
    got = ttrace.trace_decoder(torch.from_numpy(enc_out), pw, C, speaker_id=1, frames=frames)
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], name=name)
    assert got["decoder_input"].shape == (C.context_frames + 1 + n_frames, C.d_model)


def test_trace_local_transformer_matches_jax(model):
    jw, pw = model
    hidden = np.random.default_rng(4).normal(size=(C.d_model,)).astype(np.float32)
    want = jtrace.trace_local_transformer(jnp.asarray(hidden), jw, C)
    got = ttrace.trace_local_transformer(torch.from_numpy(hidden), pw, C)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["lt_greedy_codes"], want["lt_greedy_codes"])
    for cb in range(C.num_codebooks):
        _close(got[f"lt_logits_cb{cb}"], want[f"lt_logits_cb{cb}"], name=f"cb{cb}")


@pytest.mark.parametrize("layout", ["cb_first", "frame_first"])
def test_trace_codec_matches_jax(codec, layout):
    jw, pw = codec
    codes = np.random.default_rng(6).integers(0, CC.codebook_size, size=(CC.num_codebooks, 5))
    codes = codes if layout == "cb_first" else codes.T
    want = jtrace.trace_codec(codes, jw, CC)
    got = ttrace.trace_codec(codes, pw, CC)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["codec_latent"], want["codec_latent"])
    assert got["codec_latent"].shape == (CC.latent_dim, 5)
    for name in want:
        _close(got[name], want[name], atol=CODEC_ATOL, name=name)
    assert got["codec_audio"].shape == (5 * CC.hop_length,)
