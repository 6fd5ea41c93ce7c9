"""PyTorch port in bfloat16 against the JAX package in bfloat16, on the CPU.

The reference is the JAX source's own rounding points, so every JAX value
here comes from ``jax_reference_without_excess_precision``
(tests/test_torch_support.py): a child process with
``XLA_FLAGS=--xla_allow_excess_precision=false``. Jitted JAX with the flag on
(XLA's default) keeps bfloat16 intermediates of a fusion in float32 and drops
the ``.astype(bfloat16)`` the source writes; ``jax.disable_jit()`` would
remove that too, but not inside the Pallas kernels in interpret mode and the
``scan`` bodies, which still compile whole. One child per module computes
every reference below from seeded numpy inputs and hands them back as
float32 (bf16 values are exact in float32).

Bars: values that are sums may differ by the order of summation, which
moves a bfloat16 result by one ulp where the float32 sum sits near a
rounding boundary: at most 1 ulp, on at most 1% of the elements; values
with no sum involved are bit-equal; codes are exact. The CUDA kernels are
held against these plain versions on the card (tests/test_torch_cuda.py).
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch import cli
from magpie_tts_tpu_torch.io.magpie_weights import (STREAMED, int8_stream_from_numpy,
                                                     q8_dequantized_decoder, q8_stream_from_arrays,
                                                     quantize_decoder_stream)
from magpie_tts_tpu_torch.io.wav import read_wav
from magpie_tts_tpu_torch.models import decoder as tdecoder
from magpie_tts_tpu_torch.models import local_transformer as tlt
from magpie_tts_tpu_torch.models import magpie as tmagpie
from magpie_tts_tpu_torch.models.encoder import run_encoder
from magpie_tts_tpu_torch.ops import attention as tattention
from magpie_tts_tpu_torch.ops import conv_ffn as tconv_ffn
from magpie_tts_tpu_torch.ops import sampling as ts
from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts
from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
from magpie_tts_tpu_torch.ops.kernels import q8_dequant
from magpie_tts_tpu_torch.pipeline import MagpiePipeline
from tests import fixtures
from tests.test_torch_support import (jax_reference_without_excess_precision, jax_params,
                                      port_magpie_weights)
from tests.utils import tiny_magpie_config

BF = torch.bfloat16
CONFIG = tiny_magpie_config()
SEED = 4        # weights of the module's reference
ENC = 13        # tokens of the utterance
TOP_K = 8
B = 8           # slots of the batched kernels (the TPU kernels take B % 8 == 0)
TEXT = "hello world"


# ------------------------------------------------------ the JAX reference

def _inputs(seed: int) -> dict:
    """Seeded numpy inputs of every reference (float32 arrays hold bf16
    values)."""
    c = CONFIG
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(torch.tensor(a, dtype=torch.float32).to(BF).float())
    S, L, D, X = c.max_seq, c.dec_layers, c.d_model, c.d_xa
    valid = np.zeros((B, S), bool)
    for b in range(B - 1):
        valid[b, (40 - 1 - np.arange(5 + 4 * b)) % S] = True
    return dict(
        tokens=np.concatenate([[c.text_bos_id], rng.integers(2, 30, ENC - 2),
                               [c.text_eos_id]]).astype(np.int32),
        ffn_x=bf(rng.normal(0, 1, (16, D))),
        xattn_q=bf(rng.normal(0, 1, (2, D))),
        lt_seq=bf(rng.normal(0, 0.5, (9, c.lt_dim))),
        lt_hidden=bf(rng.normal(0, 1, (D,))),
        codes=rng.integers(0, c.codebook_size, c.num_codebooks).astype(np.int32),
        b_hidden=bf(rng.normal(0, 1, (B, D))), b_valid=valid,
        b_may_continue=rng.random(B) < 0.8, b_forbid=rng.random(B) < 0.3,
        b_posemb_rows=rng.integers(20, 60, B),
        b_xa_k=bf(rng.normal(0, 0.5, (B, L, 16, X))), b_xa_v=bf(rng.normal(0, 0.5, (B, L, 16, X))),
        b_k=bf(rng.normal(0, 0.5, (B, L, S, D))), b_v=bf(rng.normal(0, 0.5, (B, L, S, D))),
        b_enc=rng.integers(1, 17, B).astype(np.int32),
        b_seeds=rng.integers(-2**31, 2**31, B).astype(np.int32),
        q8_q=rng.integers(-127, 128, size=(64, 192)).astype(np.int8),
        q8_s=rng.normal(0, 0.01, size=(2, 192)).astype(np.float16).astype(np.float32))


def jax_bf16_reference(seed: int, gguf: str) -> dict:
    """Every JAX value the tests compare with, in bfloat16 (run in the child
    process of jax_reference_without_excess_precision)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from magpie_tts_tpu.io.magpie_weights import (quantize_decoder_stream as jquant,
                                                  random_magpie_weights)
    from magpie_tts_tpu.models import decoder as jdecoder
    from magpie_tts_tpu.models import local_transformer as jlt
    from magpie_tts_tpu.models import magpie as jmagpie
    from magpie_tts_tpu.models.encoder import run_encoder as jrun_encoder
    from magpie_tts_tpu.ops.attention import cross_attention
    from magpie_tts_tpu.ops.conv_ffn import conv_ffn
    from magpie_tts_tpu.ops.pallas_kernels.decoder_step import decode_step_pallas
    from magpie_tts_tpu.ops.pallas_kernels.decoder_step_batched import decode_step_batched_pallas
    from magpie_tts_tpu.ops.pallas_kernels.frame_step import frame_step_pallas
    from magpie_tts_tpu.ops.pallas_kernels.frame_step_batched import frame_step_batched_pallas
    from magpie_tts_tpu.ops.pallas_kernels.lt_sampler import sample_frame_codes_pallas
    from magpie_tts_tpu.ops.pallas_kernels.lt_sampler_batched import (
        sample_frame_codes_batched_pallas)
    from magpie_tts_tpu.pipeline import MagpiePipeline as JaxPipeline

    c, x = CONFIG, _inputs(seed)
    bf, f32 = jnp.bfloat16, lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    jw = random_magpie_weights(c, seed=seed).astype(bf)
    out = {}
    tokens = jnp.asarray(x["tokens"])
    out["enc"] = f32(jrun_encoder(tokens, jw, c))
    xa_k, xa_v, st = jmagpie.prepare(tokens, jnp.int32(ENC), jnp.int32(0), jw, c)
    for k, v in dict(xa_k=xa_k, xa_v=xa_v, k=st.k_cache, v=st.v_cache, hidden=st.hidden).items():
        out[f"prep_{k}"] = f32(v)
    emb = jmagpie.audio_frame_embedding(jnp.asarray(x["codes"]), jw, c).astype(bf)
    h, k2, v2 = jdecoder.decode_step(emb, st.pos, xa_k, xa_v, st.k_cache, st.v_cache, jw, c,
                                     enc_length=jnp.int32(ENC))
    out.update(step_hidden=f32(h), step_k=f32(k2[:, st.pos]), step_v=f32(v2[:, st.pos]))
    for temp in (0.0, 0.7):
        s = jmagpie.decode_loop(xa_k, xa_v, st, jnp.int32(ENC), jw, c, jax.random.PRNGKey(3),
                                jnp.float32(temp), TOP_K)
        out[f"loop_codes_{temp}"] = np.asarray(s.codes)[:int(s.frame_idx)]
    out["conv_ffn"] = f32(conv_ffn(jnp.asarray(x["ffn_x"], bf), jw.encoder.ff_proj[0],
                                   jw.encoder.ff_out[0]))
    out["xattn"] = f32(cross_attention(jnp.asarray(x["xattn_q"], bf), xa_k[0], xa_v[0],
                                       jw.decoder.xa_q[0], jw.decoder.xa_out[0], c.dec_xa_heads,
                                       enc_length=jnp.int32(ENC), out_dtype=jnp.float32))
    out["lt_out"] = f32(jlt._lt_layer_f32(jnp.asarray(x["lt_seq"], bf), jw.lt, c))
    hid = jnp.asarray(x["lt_hidden"], bf)
    seq = jnp.zeros((9, c.lt_dim), bf).at[0].set(jlt._in_proj(hid, jw.lt, bf))
    row = jlt._lt_layer_f32(seq, jw.lt, c)[0]
    out["lt_logits0"] = f32(jnp.dot(row.astype(bf), jw.lt.out_proj_w[0],
                                    preferred_element_type=jnp.float32)
                            + jw.lt.out_proj_b[0].astype(jnp.float32))

    # The Pallas kernels in interpret mode, in bf16.
    for temp in (0.0, 0.7):
        s_, a_, h_, k_, v_ = frame_step_pallas(
            st.hidden, st.pos, xa_k, xa_v, st.k_cache, st.v_cache, jw, c, jnp.int32(5),
            jnp.float32(temp), TOP_K, jnp.bool_(False), enc_length=jnp.int32(ENC),
            interpret=True)
        out.update({f"k1_{temp}_sampled": np.asarray(s_), f"k1_{temp}_argmax": np.asarray(a_),
                    f"k1_{temp}_hidden": f32(h_), f"k1_{temp}_k": f32(k_[:, st.pos]),
                    f"k1_{temp}_v": f32(v_[:, st.pos])})
    s_, a_ = sample_frame_codes_pallas(st.hidden, jw, c, jnp.int32(9), jnp.float32(0.7), TOP_K,
                                       jnp.bool_(True), interpret=True)
    out.update(k4_sampled=np.asarray(s_), k4_argmax=np.asarray(a_))
    streams = {"dense": None, "int8": jquant(jw.decoder)}
    out.update({f"int8_{k}": np.asarray(getattr(streams["int8"], k), np.float32)
                for k in ("qkv_s", "sa_out_s", "ff_proj_s", "ff_out_s")})
    out.update({f"int8_{k}": np.asarray(getattr(streams["int8"], k))
                for k in ("qkv_q", "sa_out_q", "ff_proj_q", "ff_out_q")})
    for name, stream in streams.items():
        h_, k_, v_ = decode_step_pallas(emb, st.pos, xa_k, xa_v, st.k_cache, st.v_cache, jw, c,
                                        enc_length=jnp.int32(ENC), interpret=True,
                                        int8_stream=stream)
        out.update({f"k5_{name}_hidden": f32(h_), f"k5_{name}_k": f32(k_[:, st.pos]),
                    f"k5_{name}_v": f32(v_[:, st.pos])})
    write_row = 40
    posemb = jw.decoder.pos_emb[jnp.asarray(x["b_posemb_rows"])]
    bx = {k: jnp.asarray(x[f"b_{k}"], bf) for k in ("hidden", "xa_k", "xa_v", "k", "v")}
    seeds, enc = jnp.asarray(x["b_seeds"]), jnp.asarray(x["b_enc"])
    s_, a_, h_, k_, v_ = frame_step_batched_pallas(
        bx["hidden"], jnp.int32(write_row), jnp.asarray(x["b_valid"]),
        jnp.asarray(x["b_may_continue"]), posemb, bx["xa_k"], bx["xa_v"], bx["k"], bx["v"], jw,
        c, enc, seeds, jnp.float32(0.7), TOP_K, jnp.asarray(x["b_forbid"]), interpret=True)
    out.update(k6_sampled=np.asarray(s_), k6_argmax=np.asarray(a_), k6_hidden=f32(h_),
               k6_k=f32(k_[:, :, write_row]), k6_v=f32(v_[:, :, write_row]))
    s_, a_ = sample_frame_codes_batched_pallas(bx["hidden"], jw, c, seeds, jnp.float32(0.7),
                                               TOP_K, jnp.asarray(x["b_forbid"]), interpret=True)
    out.update(k7_sampled=np.asarray(s_), k7_argmax=np.asarray(a_))
    valid8 = jnp.asarray(x["b_valid"]).at[:, write_row].set(jnp.asarray(x["b_may_continue"]))
    x_pe = bx["hidden"] * jnp.asarray(0.1, bf) + posemb
    h_, k_, v_ = decode_step_batched_pallas(x_pe, jnp.int32(write_row), valid8, bx["xa_k"],
                                            bx["xa_v"], bx["k"], bx["v"], jw, c, enc,
                                            interpret=True)
    out.update(k8_x_pe=f32(x_pe), k8_hidden=f32(h_), k8_k=f32(k_[:, :, write_row]),
               k8_v=f32(v_[:, :, write_row]))

    def tile(q_ref, s_ref, o_ref):
        o_ref[...] = (jnp.repeat(s_ref[...].astype(jnp.float32), 32, axis=0)
                      * q_ref[...].astype(jnp.float32)).astype(bf)

    out["k10"] = f32(pl.pallas_call(tile, out_shape=jax.ShapeDtypeStruct((64, 192), bf),
                                    interpret=True)(jnp.asarray(x["q8_q"]),
                                                    jnp.asarray(x["q8_s"])))

    # The pipeline and the codec end to end on a GGUF, in bf16.
    jp = JaxPipeline.from_gguf(gguf + ".magpie", gguf + ".codec", compute_dtype=bf)
    for temp, s in ((0.0, 0), (0.7, 3)):
        out[f"pipe_codes_{temp}"] = np.asarray(jp.synthesize_codes(TEXT, temperature=temp,
                                                                   seed=s))
    out["pipe_audio"] = np.asarray(jp.codec.decode(out["pipe_codes_0.7"]), np.float32)
    return out


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_bf16")
    base = str(tmp / "tiny")
    fixtures.write_tiny_magpie_gguf(base + ".magpie", seed=0)
    fixtures.write_tiny_codec_gguf(base + ".codec", seed=1)
    return base


@pytest.fixture(scope="module")
def ref(paths):
    return jax_reference_without_excess_precision("tests.test_torch_bf16:jax_bf16_reference",
                                                  seed=SEED, gguf=paths)


@pytest.fixture(scope="module")
def pw():
    """The port's weights of the reference's seed, cast to bf16 (as the JAX
    weights' astype: round to nearest even)."""
    from magpie_tts_tpu.io.magpie_weights import random_magpie_weights

    return port_magpie_weights(random_magpie_weights(CONFIG, seed=SEED)).to(dtype=BF)


X = _inputs(SEED)


def bt(a) -> torch.Tensor:
    """A float32 array of bf16 values as a bf16 tensor (exact)."""
    return torch.tensor(np.asarray(a, np.float32)).to(BF)


def ulps(got: torch.Tensor, want) -> np.ndarray:
    """|got - want| in bf16 ulps of max(|want|, the RMS of want's row): an
    element's own ulp, or the ulp at its row's scale when it is smaller (a
    near-zero result of cancellation carries the float32 noise of its
    terms, many of its own ulps); as chip_smoke.scaled_ulps."""
    g, w = got.float().numpy(), bt(want).float().numpy()
    rms = np.sqrt(np.mean(w * w, axis=-1, keepdims=True))
    ref = np.maximum(np.maximum(np.abs(w), rms), 1e-30)
    return np.abs(g - w) / np.exp2(np.floor(np.log2(ref)) - 7)


def assert_sum_close(got: torch.Tensor, want, name: str = "", share: float = 0.01):
    """At most 1 bf16 ulp apart, on at most ``share`` of the elements."""
    d = ulps(got, want)
    assert d.max() <= 1, f"{name}: {d.max()} ulps"
    assert (d > 0).mean() <= share, f"{name}: {(d > 0).mean():.4f} of the elements differ"


def prepared(ref):
    """JAX's prepared state as port tensors."""
    st = tmagpie.DecodeState(k_cache=bt(ref["prep_k"]), v_cache=bt(ref["prep_v"]),
                             hidden=bt(ref["prep_hidden"]), pos=CONFIG.context_frames + 1,
                             frame_idx=0, codes=np.zeros((CONFIG.max_dec_steps, 8), np.int32),
                             done=False)
    return bt(ref["prep_xa_k"]), bt(ref["prep_xa_v"]), st


# ----------------------------------------- the repaired rounding points

def test_conv_ffn_sums_its_terms_in_float32(ref, pw):
    """ops/conv_ffn.py: the k=3 terms are float32 products summed in float32
    and rounded once (each term rounded to bf16 and summed in bf16 put
    ~64% of the outputs off)."""
    with torch.no_grad():
        got = tconv_ffn.conv_ffn(bt(X["ffn_x"]), pw.encoder.ff_proj[0], pw.encoder.ff_out[0])
    assert got.dtype == BF
    assert_sum_close(got, ref["conv_ffn"], "conv_ffn")


def test_stream_matmul_keeps_float32_products(pw):
    """models/decoder.py stream_matmul: dense, int8 and Q8 products of a bf16
    row are float32 sums of exact float32 products, left unrounded (the
    dense one was rounded to bf16; int8 and Q8 raised on a bf16 row)."""
    dec = pw.decoder
    x = bt(X["b_hidden"][0])
    dense = tdecoder.stream_matmul(x, dec, None, "qkv", 1)
    want = x.double() @ dec.qkv[1].double()
    assert dense.dtype == torch.float32
    assert not torch.equal(dense, dense.to(BF).float())     # not rounded to bf16
    assert float((dense.double() - want).abs().max()) < 1e-5
    int8 = quantize_decoder_stream(dec)
    f = bt(np.tile(X["b_hidden"][0], 2))    # a d_ffn-wide row
    got = tdecoder.stream_matmul(f, dec, int8, "ff_out", 0)
    torch.testing.assert_close(got, (f.float() @ int8.ff_out_q[0].float()) * int8.ff_out_s[0],
                               rtol=0, atol=0)
    q8 = q8_stream_from_arrays(dec)
    got = tdecoder.stream_matmul(x, dec, q8, "sa_out", 1)
    w = (torch.repeat_interleave(q8.sa_out_bs[1], 32, dim=0) * q8.sa_out_q[1].float()).to(BF)
    torch.testing.assert_close(got, x.float() @ w.float(), rtol=0, atol=0)


def test_cross_attention_output_stays_float32(ref, pw):
    """ops/attention.py cross_attention(out_dtype=float32), what the decode
    step adds to its float32 residual (it was rounded to bf16 first)."""
    xa_k, xa_v, _ = prepared(ref)
    with torch.no_grad():
        got = tattention.cross_attention(bt(X["xattn_q"]), xa_k[0], xa_v[0], pw.decoder.xa_q[0],
                                         pw.decoder.xa_out[0], CONFIG.dec_xa_heads,
                                         enc_length=ENC, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref["xattn"], rtol=1e-5, atol=1e-6)


def test_lt_layer_keeps_jax_rounding_points(ref, pw):
    """models/local_transformer.py: the in-projection, scores, sa_out,
    ff_proj and ff_out stay float32 (each was rounded to bf16), so the
    layer's float32 output matches JAX to float32 summation order."""
    with torch.no_grad():
        got = tlt._lt_layer_f32(bt(X["lt_seq"]), pw.lt, CONFIG)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref["lt_out"], rtol=1e-5, atol=1e-5)
    assert_sum_close(got.to(BF), ref["lt_out"], "lt layer rounded")


def test_lt_logits_are_not_rounded(ref, pw, monkeypatch):
    """models/local_transformer.py: the logits are a float32 product plus
    the float32 bias (rounding the product to bf16 first manufactured ties)."""
    seen = []
    real = ts.sample_top_k_deterministic

    def spy(seed, phase, logits, temperature, top_k):
        seen.append(logits.clone())
        return real(seed, phase, logits, temperature, top_k)

    monkeypatch.setattr(ts, "sample_top_k_deterministic", spy)
    mask = ts.forbidden_token_mask(CONFIG.vocab_per_cb, CONFIG.audio_bos_id)
    with torch.no_grad():
        tlt.sample_frame_codes(bt(X["lt_hidden"]), pw, CONFIG, 1, 0.0, TOP_K, False, mask)
    want = ref["lt_logits0"]
    got = seen[0].numpy()
    keep = got > -1e29     # the forbidden ids are masked
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=1e-6)


# ------------------------------------------ the plain modules end to end

def test_encoder_matches_jax(ref, pw):
    with torch.no_grad():
        got = run_encoder(torch.tensor(X["tokens"], dtype=torch.int64), pw, CONFIG)
    assert_sum_close(got, ref["enc"], "encoder")


def test_prepare_matches_jax(ref, pw):
    """prepare() (encoder, cross-attention K/V, prefill, BOS step): K/V
    caches and hidden state bit-equal to JAX; xa_k / xa_v within 1 ulp (the
    encoder's order of summation; a 1-ulp encoder difference moves a whole
    normed row)."""
    with torch.no_grad():
        xa_k, xa_v, st = tmagpie.prepare(torch.tensor(X["tokens"], dtype=torch.int64), ENC, 0,
                                         pw, CONFIG)
    for got, key in ((st.k_cache, "prep_k"), (st.v_cache, "prep_v"),
                     (st.hidden, "prep_hidden")):
        assert got.dtype == BF
        np.testing.assert_array_equal(got.float().numpy(), ref[key], err_msg=key)
    for got, key in ((xa_k, "prep_xa_k"), (xa_v, "prep_xa_v")):
        assert ulps(got, ref[key]).max() <= 1, key


def test_decode_step_matches_jax(ref, pw):
    """One plain decoder step from JAX's prepared state (float32 residual,
    the JAX source's rounding points)."""
    xa_k, xa_v, st = prepared(ref)
    emb = tmagpie.audio_frame_embedding(torch.tensor(X["codes"]), pw, CONFIG)
    k, v = st.k_cache.clone(), st.v_cache.clone()
    with torch.no_grad():
        h = tdecoder.decode_step(emb, st.pos, xa_k, xa_v, k, v, pw, CONFIG, enc_length=ENC)
    assert h.dtype == BF
    assert_sum_close(h, ref["step_hidden"], "hidden")
    assert_sum_close(k[:, st.pos], ref["step_k"], "k row")
    assert_sum_close(v[:, st.pos], ref["step_v"], "v row")


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_decode_loop_from_jax_state_gives_jax_codes(ref, pw, temperature):
    xa_k, xa_v, st = prepared(ref)
    with torch.no_grad():
        out = tmagpie.decode_loop(xa_k, xa_v, st, ENC, pw, CONFIG, ts.prng_key(3), temperature,
                                  TOP_K)
    want = ref[f"loop_codes_{temperature}"]
    assert want.shape[0] > 0
    np.testing.assert_array_equal(out.codes[:out.frame_idx], want)


# ------------------------- the kernels' plain versions vs Pallas (interpret)

@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_frame_step_plain_matches_pallas_bf16(ref, pw, temperature):
    """Kernel 1 (frame_step_pallas): codes exact, hidden and the new K/V
    rows within 1 ulp."""
    xa_k, xa_v, st = prepared(ref)
    k, v = st.k_cache.clone(), st.v_cache.clone()
    with torch.no_grad():
        s, a, h, _, _ = fs.frame_step(st.hidden, st.pos, xa_k, xa_v, k, v, pw, CONFIG, 5,
                                      temperature, TOP_K, False, enc_length=ENC)
    key = f"k1_{temperature}"
    np.testing.assert_array_equal(s.numpy(), ref[f"{key}_sampled"])
    np.testing.assert_array_equal(a.numpy(), ref[f"{key}_argmax"])
    assert h.dtype == BF
    assert_sum_close(h, ref[f"{key}_hidden"], "hidden")
    assert_sum_close(k[:, st.pos], ref[f"{key}_k"], "k row")
    assert_sum_close(v[:, st.pos], ref[f"{key}_v"], "v row")


def test_lt_sampler_plain_matches_pallas_bf16(ref, pw):
    """Kernel 4 (sample_frame_codes_pallas): codes exact."""
    _, _, st = prepared(ref)
    with torch.no_grad():
        s, a = lts.sample_frame_codes(st.hidden, pw, CONFIG, 9, 0.7, TOP_K, True)
    np.testing.assert_array_equal(s.numpy(), ref["k4_sampled"])
    np.testing.assert_array_equal(a.numpy(), ref["k4_argmax"])


def _int8_stream(ref):
    return int8_stream_from_numpy({k[5:]: ref[k] for k in ref if k.startswith("int8_")})


@pytest.mark.parametrize("stream", ["dense", "int8"])
def test_decode_step_plain_matches_pallas_bf16(ref, pw, stream):
    """Kernel 5 (decode_step_pallas), dense and with the int8 stream (the
    same stream JAX quantized from its bf16 weights): within 1 ulp."""
    xa_k, xa_v, st = prepared(ref)
    emb = tmagpie.audio_frame_embedding(torch.tensor(X["codes"]), pw, CONFIG)
    k, v = st.k_cache.clone(), st.v_cache.clone()
    s = None if stream == "dense" else _int8_stream(ref)
    if s is not None:
        ours = quantize_decoder_stream(pw.decoder)
        for name in STREAMED:   # the port quantizes the bf16 weights to the same stream
            assert torch.equal(getattr(ours, f"{name}_q"), getattr(s, f"{name}_q"))
            assert torch.equal(getattr(ours, f"{name}_s"), getattr(s, f"{name}_s"))
    with torch.no_grad():
        h = ds.decode_step(emb, st.pos, xa_k, xa_v, k, v, pw, CONFIG, enc_length=ENC, stream=s)
    assert_sum_close(h, ref[f"k5_{stream}_hidden"], "hidden")
    assert_sum_close(k[:, st.pos], ref[f"k5_{stream}_k"], "k row")
    assert_sum_close(v[:, st.pos], ref[f"k5_{stream}_v"], "v row")


def _batched(pw):
    return dict(hidden=bt(X["b_hidden"]), valid=torch.tensor(X["b_valid"]),
                may_continue=torch.tensor(X["b_may_continue"]),
                posemb=pw.decoder.pos_emb[torch.tensor(X["b_posemb_rows"])],
                xa_k=bt(X["b_xa_k"]), xa_v=bt(X["b_xa_v"]), k_cache=bt(X["b_k"]),
                v_cache=bt(X["b_v"]), enc_lengths=torch.tensor(X["b_enc"]),
                seeds=torch.tensor(X["b_seeds"]), forbid_eos=torch.tensor(X["b_forbid"]))


def test_frame_step_batched_plain_matches_pallas_bf16(ref, pw):
    """Kernel 6 (frame_step_batched_pallas) at B = 8 with ring masks (the
    last slot empty): codes exact, hidden and new K/V rows within 1 ulp on
    the slots with a valid row."""
    x = _batched(pw)
    with torch.no_grad():
        s, a, h, k, v = fsb.frame_step_batched(write_row=40, weights=pw, config=CONFIG,
                                               temperature=0.7, top_k=TOP_K, **x)
    np.testing.assert_array_equal(s.numpy(), ref["k6_sampled"])
    np.testing.assert_array_equal(a.numpy(), ref["k6_argmax"])
    live = slice(0, B - 1)
    assert_sum_close(h[live], ref["k6_hidden"][live], "hidden")
    assert_sum_close(k[live, :, 40], ref["k6_k"][live], "k row")
    assert_sum_close(v[live, :, 40], ref["k6_v"][live], "v row")


def test_lt_sampler_batched_plain_matches_pallas_bf16(ref, pw):
    """Kernel 7 (sample_frame_codes_batched_pallas) at B = 8: codes exact."""
    x = _batched(pw)
    with torch.no_grad():
        s, a = ltsb.sample_frame_codes_batched(x["hidden"], pw, CONFIG, x["seeds"], 0.7, TOP_K,
                                               x["forbid_eos"])
    np.testing.assert_array_equal(s.numpy(), ref["k7_sampled"])
    np.testing.assert_array_equal(a.numpy(), ref["k7_argmax"])


def test_decode_step_batched_plain_matches_pallas_bf16(ref, pw):
    """Kernel 8 (decode_step_batched_pallas) at B = 8: within 1 ulp on the
    slots with a valid row."""
    x = _batched(pw)
    valid = x["valid"].clone()
    valid[:, 40] = x["may_continue"]
    x_pe = x["hidden"] * torch.tensor(0.1, dtype=BF) + x["posemb"]
    np.testing.assert_array_equal(x_pe.float().numpy(), ref["k8_x_pe"])
    k, v = x["k_cache"], x["v_cache"]
    with torch.no_grad():
        h = dsb.decode_step_batched(x_pe, 40, valid, x["xa_k"], x["xa_v"], k, v, pw, CONFIG,
                                    x["enc_lengths"])
    live = slice(0, B - 1)
    assert_sum_close(h[live], ref["k8_hidden"][live], "hidden")
    assert_sum_close(k[live, :, 40], ref["k8_k"][live], "k row")
    assert_sum_close(v[live, :, 40], ref["k8_v"][live], "v row")


def test_q8_dequant_plain_matches_pallas_tile_bf16(ref):
    """Kernel 10's plain version writing bf16 against the dequant tile in
    bf16 (the exact f32 product rounded once): bit-equal."""
    q, s = X["q8_q"], X["q8_s"]
    blocks_q = np.ascontiguousarray(q.T).reshape(-1, 32)
    blocks_s = np.ascontiguousarray(s.T).reshape(-1, 1)
    got = q8_dequant.dequantize(torch.tensor(blocks_q), torch.tensor(blocks_s), (192, 64),
                                "linear", BF)
    assert got.dtype == BF
    np.testing.assert_array_equal(got.float().numpy(), ref["k10"])


def test_q8_stream_bit_equal_bf16_dequant_at_load(pw):
    """The plain Q8 stream steps in bf16 equal the dense steps on the weights
    dequantized at load in bf16, bit for bit (frame and decoder step)."""
    q8 = q8_stream_from_arrays(pw.decoder)
    deq = q8_deq_bf16(pw, q8)
    x = _batched(pw)
    xa_k, xa_v = x["xa_k"][0], x["xa_v"][0]
    runs = []
    for weights, stream in ((pw, q8), (deq, None)):
        k, v = x["k_cache"][0].clone(), x["v_cache"][0].clone()
        with torch.no_grad():
            out = fs.frame_step(x["hidden"][0], 41, xa_k, xa_v, k, v, weights, CONFIG, 3, 0.7,
                                TOP_K, False, enc_length=9, stream=stream)
            h5 = ds.decode_step(x["hidden"][1], 42, xa_k, xa_v, k, v, weights, CONFIG,
                                enc_length=9, stream=stream)
        runs.append((*out[:3], h5, k, v))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def q8_deq_bf16(pw, q8):
    """pw with the streamed matrices dequantized at load in bf16."""
    dec = q8_dequantized_decoder(pw.decoder, q8)
    dec = dataclasses.replace(dec, **{n: getattr(dec, n).to(BF) for n in STREAMED})
    return dataclasses.replace(pw, decoder=dec)


# --------------------------------------------------- the pipeline and the CLI

@pytest.fixture(scope="module")
def pipeline(paths):
    return MagpiePipeline.from_gguf(paths + ".magpie", paths + ".codec", device="cpu",
                                    compute_dtype=BF)


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.7, 3)])
def test_pipeline_bf16_codes_equal_jax(ref, pipeline, temperature, seed):
    got = pipeline.synthesize_codes(TEXT, temperature=temperature, seed=seed)
    want = ref[f"pipe_codes_{temperature}"]
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_array_equal(got, want)


def test_codec_waveform_bf16_near_jax(ref, pipeline):
    """The bf16 codec against the JAX package's bf16 codec (its XLA path):
    the port follows the Pallas kernel's rounding points (bias and residual
    added in float32, rounded once; the LeakyReLU slope in float32), the XLA
    path rounds the conv before the residual and the slope to bf16, so a
    sample may differ by a few bf16 ulps of the waveform's scale: at most
    0.02 (5 ulps at 0.5) anywhere, 0.002 on average."""
    codes = ref["pipe_codes_0.7"]
    got = pipeline.codec.decode(codes)
    want = ref["pipe_audio"]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 0.02
    assert np.abs(got - want).mean() <= 0.002


def test_cli_bf16_synth_and_serve(paths, pipeline, tmp_path, monkeypatch, capsys):
    """cli.main synth with --dtype bfloat16 writes the bf16 pipeline's
    utterance; serve runs in bfloat16 by default (its engines' dtype)."""
    out = str(tmp_path / "out.wav")
    rc = cli.main(["-m", paths + ".magpie", "-c", paths + ".codec", "-t", TEXT, "-o", out,
                   "--device", "cpu", "--dtype", "bfloat16", "--temp", "0.7", "--seed", "3",
                   "-q"])
    assert rc == 0 and capsys.readouterr().out.strip() == out
    samples, sr = read_wav(out)
    codes = pipeline.synthesize_codes(TEXT, temperature=0.7, seed=3)
    want = pipeline.codec.decode(codes, pcm16=True).astype(np.float32) / 32768.0
    assert sr == 22050 and len(samples) == codes.shape[0] * pipeline.codec.config.hop_length
    np.testing.assert_allclose(samples, want, atol=1e-4, rtol=0)

    from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
    dtypes = set()
    real = ContinuousBatchingEngine._segment

    def segment(self, *a, **k):
        dtypes.add((self.k_cache.dtype, self.weights.decoder.qkv.dtype))
        return real(self, *a, **k)

    monkeypatch.setattr(ContinuousBatchingEngine, "_segment", segment)
    monkeypatch.setattr("sys.stdin", io.StringIO('{"id": "a", "text": "hello world"}\nabc\n'))
    rc = cli.main(["serve", "-m", paths + ".magpie", "-c", paths + ".codec", "--out-dir",
                   str(tmp_path / "serve"), "--slots", "2", "--segment-frames", "4",
                   "--device", "cpu", "-q"])
    assert rc == 0 and dtypes == {(BF, BF)}
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert sorted(ln["id"] for ln in lines) == ["1", "a"]
    for ln in lines:
        samples, _ = read_wav(ln["wav"])
        assert len(samples) == ln["frames"] * pipeline.codec.config.hop_length > 0


def test_jax_params_cast_like_the_port():
    """The port's cast of the JAX weights to bf16 equals JAX's astype (round
    to nearest even), the precondition of every comparison here."""
    import jax.numpy as jnp

    from magpie_tts_tpu.io.magpie_weights import random_magpie_weights

    jw = random_magpie_weights(CONFIG, seed=SEED)
    flat = jax_params(jw.astype(jnp.bfloat16))
    ours = port_magpie_weights(jw).to(dtype=BF).flatten()
    for key, arr in flat.items():
        np.testing.assert_array_equal(ours[key].float().numpy(), np.asarray(arr, np.float32),
                                      err_msg=key)
