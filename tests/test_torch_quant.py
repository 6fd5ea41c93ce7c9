"""PyTorch port, quantized weight serving (``--serve-int8``, ``--serve-q8``):
the stream formats and the Q8_0-native load against the JAX package, the
plain versions of the stream kernels and of kernel 10 (the Q8_0 dequant)
against the Pallas TPU kernels in interpret mode (as
tests/test_pallas_kernels.py runs them), and the pipeline, loops and CLI with
a stream, on the CPU. The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py.

On the CPU the JAX package's XLA decode path ignores the int8 stream (its
``decode_loop`` calls ``decoder.decode_step`` without it), so the int8 plain
versions are held against the Pallas kernels, not against the JAX pipeline.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from magpie_tts_tpu.io import magpie_weights as jmw
from magpie_tts_tpu.io.gguf import GGUFReader as JaxReader
from magpie_tts_tpu.models import magpie as jmagpie
from magpie_tts_tpu.ops.pallas_kernels.decoder_step import decode_step_pallas
from magpie_tts_tpu.ops.pallas_kernels.frame_step import frame_step_pallas
from magpie_tts_tpu.ops.pallas_kernels.frame_step_batched import frame_step_batched_pallas
from magpie_tts_tpu.pipeline import MagpiePipeline as JaxPipeline
from magpie_tts_tpu_torch import cli
from magpie_tts_tpu_torch.io import magpie_weights as tmw
from magpie_tts_tpu_torch.io.gguf import GGUFReader
from magpie_tts_tpu_torch.io.wav import read_wav
from magpie_tts_tpu_torch.models import magpie as tmagpie
from magpie_tts_tpu_torch.ops import sampling as ts
from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
from magpie_tts_tpu_torch.ops.kernels import q8_dequant
from magpie_tts_tpu_torch.pipeline import MagpiePipeline
from magpie_tts_tpu_torch.runtime.engine import MagpieEngine
from tests import fixtures
from tests.test_torch_support import jax_params, port_magpie_weights, t
from tests.utils import tiny_magpie_config

CONFIG = tiny_magpie_config()
TOP_K = 8
ENC = 16
Q8_TOL = 4e-6    # the JAX package's own Q8-vs-dequant float tolerance (its kernels)
INT8_TOL = 1e-5  # int8 stream: (x @ q) * s summed in another order than the kernel's
TEXT = "hello world"


@pytest.fixture(scope="module")
def weights():
    jw = jmw.random_magpie_weights(CONFIG, seed=11)
    return jw, port_magpie_weights(jw)


@pytest.fixture(scope="module")
def streams(weights):
    """Each stream kind from the JAX package, carried across, and the
    weights whose decoder holds the Q8 stream's dequantized matrices."""
    jw, _ = weights
    j_int8 = jmw.quantize_decoder_stream(jw.decoder)
    j_q8 = jmw.q8_stream_from_arrays(jw.decoder)
    jw_deq = jw.replace(decoder=jmw.q8_dequantized_decoder(jw.decoder, j_q8))
    return {"int8": (j_int8, tmw.int8_stream_from_numpy(jax_params(j_int8))),
            "q8": (j_q8, tmw.q8_stream_from_numpy(jax_params(j_q8))),
            "deq": (jw_deq, port_magpie_weights(jw_deq))}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_quant")
    q8, f32, codec = (str(tmp / n) for n in ("magpie_q8.gguf", "magpie.gguf", "codec.gguf"))
    fixtures.write_tiny_magpie_gguf(q8, seed=0, quant="q8_0")
    fixtures.write_tiny_magpie_gguf(f32, seed=0)
    fixtures.write_tiny_codec_gguf(codec, seed=1)
    return q8, f32, codec


def _equal(got: torch.Tensor, want, name: str = "") -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


# ------------------------------------------------------------- stream formats

def test_quantize_decoder_stream_bit_equal_jax(weights, streams):
    """Per-column int8: q and s bit for bit, rounding half to even."""
    _, pw = weights
    j_int8, _ = streams["int8"]
    got = tmw.quantize_decoder_stream(pw.decoder)
    for f in dataclasses.fields(got):
        _equal(getattr(got, f.name), getattr(j_int8, f.name), f.name)
    zero = tmw._colquant(torch.zeros(3, 64, 8))
    assert (zero[0] == 0).all() and (zero[1] == 1.0).all()


def test_q8_stream_from_arrays_bit_equal_jax(weights, streams):
    _, pw = weights
    j_q8, _ = streams["q8"]
    got = tmw.q8_stream_from_arrays(pw.decoder)
    for f in dataclasses.fields(got):
        _equal(getattr(got, f.name), getattr(j_q8, f.name), f.name)
    deq = tmw.q8_dequantized_decoder(pw.decoder, got)
    for name in tmw.STREAMED:
        _equal(getattr(deq, name), getattr(streams["deq"][0].decoder, name), name)


def test_q8_stream_from_gguf_bit_equal_jax_and_loader(paths):
    """The file's own blocks: bit-equal to JAX's, and dequantized exactly to
    what the ordinary loader reads; an f32 file is refused."""
    q8_path, f32_path, _ = paths
    config, dense = tmw.load_magpie_weights(q8_path)
    got = tmw.q8_stream_from_gguf(GGUFReader(q8_path), config)
    want = jmw.q8_stream_from_gguf(JaxReader(q8_path), config)
    for f in dataclasses.fields(got):
        _equal(getattr(got, f.name), getattr(want, f.name), f.name)
    deq = tmw.q8_dequantized_decoder(dense.decoder, got)
    for name in tmw.STREAMED:
        assert torch.equal(getattr(deq, name), getattr(dense.decoder, name)), name
    with pytest.raises(ValueError, match="Q8_0"):
        tmw.q8_stream_from_gguf(GGUFReader(f32_path), config)


def _leaf(tree, path):
    for name in path.split("."):
        tree = getattr(tree, name)
    return tree


@pytest.mark.parametrize("transform", ["linear", "conv1", "conv_ffn"])
def test_q8_native_load_materializes_bit_equal(paths, transform):
    """``load_magpie_weights(q8_native=True)`` keeps every allowlisted tensor
    as its blocks (as JAX's does); materialize_weights (kernel 10's plain
    version on the CPU) gives the dense load and JAX's materialize bit for
    bit."""
    q8_path = paths[0]
    _, native = tmw.load_magpie_weights(q8_path, q8_native=True)
    _, dense = tmw.load_magpie_weights(q8_path)
    _, j_native = jmw.load_magpie_weights(q8_path, q8_native=True)
    j_dense = jmw.materialize_weights(j_native)
    nodes = tmw.q8_blocks(native)
    assert len(nodes) == 18 and tmw.has_q8_blocks(native)
    for path, blocks in nodes.items():
        assert isinstance(_leaf(j_native, path), jmw.Q8Blocks), path
        assert blocks.q.dtype == torch.int8 and blocks.s.dtype == torch.float32
    mat = tmw.materialize_weights(native)
    assert not tmw.has_q8_blocks(mat) and tmw.materialize_weights(dense) is dense
    checked = [p for p, b in nodes.items() if b.transform == transform]
    assert checked
    for path in checked:
        got = _leaf(mat, path)
        assert torch.equal(got, _leaf(dense, path)), path
        _equal(got, _leaf(j_dense, path), path)


def test_q8_dequant_plain_matches_pallas_tile(rng):
    """Kernel 10's plain version against the TPU's in-kernel dequant tile
    (tests/test_pallas_kernels.py, In 64, Out 192) in interpret mode: the GGUF
    blocks of W^T [Out, In] dequantize to repeat(s, 32, in-axis) * q
    exactly, in the [In, Out] layout."""
    In, Out = 64, 192
    q = rng.integers(-127, 128, size=(In, Out)).astype(np.int8)
    s = rng.normal(0, 0.01, size=(In // 32, Out)).astype(np.float16).astype(np.float32)

    def kernel(q_ref, s_ref, o_ref):
        o_ref[...] = (jnp.repeat(s_ref[...].astype(jnp.float32), 32, axis=0)
                      * q_ref[...].astype(jnp.float32))

    tile = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((In, Out), jnp.float32),
                          interpret=True)(jnp.asarray(q), jnp.asarray(s))
    blocks_q = np.ascontiguousarray(q.T).reshape(-1, 32)
    blocks_s = np.ascontiguousarray(s.T).reshape(-1, 1)
    q8_dequant.launches = 0
    got = q8_dequant.dequantize(t(blocks_q), t(blocks_s), (Out, In), "linear")
    _equal(got, tile)
    assert q8_dequant.launches == 0
    with pytest.raises(ValueError):
        q8_dequant.dequantize(t(blocks_q), t(blocks_s), (Out, In), "conv1")


# ------------------------------------------------- the stream kernels' plain versions

def _decode_inputs(rng):
    L, S, D, X = CONFIG.dec_layers, CONFIG.max_seq, CONFIG.d_model, CONFIG.d_xa
    return (rng.normal(0, 0.1, D).astype(np.float32),
            rng.normal(0, 0.5, (L, S, D)).astype(np.float32),
            rng.normal(0, 0.5, (L, S, D)).astype(np.float32),
            rng.normal(0, 0.5, (L, ENC, X)).astype(np.float32),
            rng.normal(0, 0.5, (L, ENC, X)).astype(np.float32))


@pytest.mark.parametrize("kind", ["int8", "q8"])
def test_decode_step_stream_reference_matches_pallas_interpret(weights, streams, kind):
    """The plain decoder step with a stream against ``decode_step_pallas``
    with the same stream in interpret mode; rows other than ``pos`` stay
    bitwise as they were."""
    jw, pw = weights
    j_stream, p_stream = streams[kind]
    tol = INT8_TOL if kind == "int8" else Q8_TOL
    pos, enc_len = 40, 11
    x, k, v, xa_k, xa_v = _decode_inputs(np.random.default_rng(len(kind)))
    h_j, k_j, v_j = decode_step_pallas(
        jnp.asarray(x), jnp.int32(pos), jnp.asarray(xa_k), jnp.asarray(xa_v), jnp.asarray(k),
        jnp.asarray(v), jw, CONFIG, enc_length=jnp.int32(enc_len), interpret=True,
        int8_stream=j_stream)
    k_p, v_p = t(k), t(v)
    with torch.no_grad():
        h_p = ds.decode_step(t(x), pos, t(xa_k), t(xa_v), k_p, v_p, pw, CONFIG,
                             enc_length=enc_len, stream=p_stream)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), atol=tol, rtol=0)
    keep = np.arange(CONFIG.max_seq) != pos
    for got, want, before in ((k_p, k_j, k), (v_p, v_j, v)):
        np.testing.assert_allclose(got.numpy()[:, pos], np.asarray(want)[:, pos], atol=tol,
                                   rtol=0)
        np.testing.assert_array_equal(got.numpy()[:, keep], before[:, keep])
        np.testing.assert_array_equal(np.asarray(want)[:, keep], before[:, keep])


@pytest.fixture(scope="module")
def prepared(streams):
    """The state after prepare() on the Q8-dequantized weights (JAX)."""
    jw_deq, _ = streams["deq"]
    tokens = jnp.asarray(np.random.default_rng(7).integers(2, 90, size=8), jnp.int32)
    return jmagpie.prepare(tokens, jnp.int32(6), jnp.int32(0), jw_deq, CONFIG)


# One interpret call each (~10 s).
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_frame_step_q8_reference_matches_pallas_interpret(streams, prepared, temperature):
    jw_deq, pw_deq = streams["deq"]
    j_q8, p_q8 = streams["q8"]
    xa_k, xa_v, st = prepared
    s_j, a_j, h_j, k_j, v_j = frame_step_pallas(
        st.hidden, st.pos, xa_k, xa_v, st.k_cache, st.v_cache, jw_deq, CONFIG, jnp.int32(3),
        jnp.float32(temperature), TOP_K, jnp.bool_(False), enc_length=jnp.int32(6),
        int8_stream=j_q8, interpret=True)
    k_p, v_p = t(st.k_cache), t(st.v_cache)
    with torch.no_grad():
        s_p, a_p, h_p, _, _ = fs.frame_step(t(st.hidden), int(st.pos), t(xa_k), t(xa_v), k_p,
                                            v_p, pw_deq, CONFIG, 3, temperature, TOP_K, False,
                                            enc_length=6, stream=p_q8)
    _equal(s_p, s_j)
    _equal(a_p, a_j)
    for got, want in ((h_p, h_j), (k_p, k_j), (v_p, v_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=Q8_TOL, rtol=0)


B3_WRITE_ROW = 2   # past the ring's wrap


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_frame_step_batched_q8_reference_matches_pallas_interpret(streams, temperature):
    """B = 3 with ring-style masks (one wrapping past max_seq - 1)."""
    jw_deq, pw_deq = streams["deq"]
    j_q8, p_q8 = streams["q8"]
    rng = np.random.default_rng(30)
    B, L, S, D = 3, CONFIG.dec_layers, CONFIG.max_seq, CONFIG.d_model
    valid = np.zeros((B, S), bool)
    for b, n in enumerate((5, 12, 30)):
        valid[b, (B3_WRITE_ROW - 1 - np.arange(n)) % S] = True
    x = dict(hidden=rng.normal(0, 1, (B, D)).astype(np.float32), valid=valid,
             may_continue=np.array([1, 0, 1], bool),
             posemb=np.asarray(jw_deq.decoder.pos_emb)[[20, 31, 47]],
             xa_k=rng.normal(0, 0.5, (B, L, ENC, CONFIG.d_xa)).astype(np.float32),
             xa_v=rng.normal(0, 0.5, (B, L, ENC, CONFIG.d_xa)).astype(np.float32),
             k_cache=rng.normal(0, 0.5, (B, L, S, D)).astype(np.float32),
             v_cache=rng.normal(0, 0.5, (B, L, S, D)).astype(np.float32),
             enc_lengths=np.array([3, 16, 9], np.int32),
             seeds=rng.integers(-2**31, 2**31, B).astype(np.int32),
             forbid_eos=np.array([0, 1, 0], bool))
    order = ("hidden", "valid", "may_continue", "posemb", "xa_k", "xa_v", "k_cache", "v_cache")
    s_j, a_j, h_j, k_j, v_j = frame_step_batched_pallas(
        jnp.asarray(x["hidden"]), jnp.int32(B3_WRITE_ROW),
        *(jnp.asarray(x[n]) for n in order[1:]), jw_deq, CONFIG,
        jnp.asarray(x["enc_lengths"]), jnp.asarray(x["seeds"]), jnp.float32(temperature), TOP_K,
        jnp.asarray(x["forbid_eos"]), int8_stream=j_q8, interpret=True)
    k_p, v_p = t(x["k_cache"]), t(x["v_cache"])
    with torch.no_grad():
        s_p, a_p, h_p, _, _ = fsb.frame_step_batched(
            t(x["hidden"]), B3_WRITE_ROW, *(t(x[n]) for n in order[1:6]), k_p, v_p, pw_deq,
            CONFIG, t(x["enc_lengths"]), t(x["seeds"]), temperature, TOP_K, t(x["forbid_eos"]),
            stream=p_q8)
    _equal(s_p, s_j)
    _equal(a_p, a_j)
    for got, want in ((h_p, h_j), (k_p, k_j), (v_p, v_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=Q8_TOL, rtol=0)


def test_q8_plain_steps_equal_dense_on_dequantized_weights(weights, streams):
    """The Q8 plain step dequantizes exactly before its product: bit-equal to
    the dense plain step on the dequantized weights, single and batched."""
    _, pw_deq = streams["deq"]
    _, p_q8 = streams["q8"]
    x, k, v, xa_k, xa_v = _decode_inputs(np.random.default_rng(4))
    runs = []
    for stream in (p_q8, None):
        k_p, v_p = t(k), t(v)
        with torch.no_grad():
            h = ds.decode_step(t(x), 33, t(xa_k), t(xa_v), k_p, v_p, pw_deq, CONFIG,
                               enc_length=9, stream=stream)
            hb = dsb.decode_step_batched(t(x)[None], 33, torch.ones(1, CONFIG.max_seq, dtype=bool),
                                         t(xa_k)[None], t(xa_v)[None], t(k)[None], t(v)[None],
                                         pw_deq, CONFIG, torch.tensor([9], dtype=torch.int32),
                                         stream=stream)
        runs.append((h, k_p, v_p, hb))
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_bad_stream_raises(weights):
    _, pw = weights
    x, k, v, xa_k, xa_v = _decode_inputs(np.random.default_rng(5))
    with pytest.raises(TypeError):
        fs.stream_mode(pw.decoder)
    with pytest.raises(TypeError), torch.no_grad():
        ds.decode_step(t(x), 20, t(xa_k), t(xa_v), t(k), t(v), pw, CONFIG, stream=pw.decoder)
    assert fs.stream_mode(None) == 0


# ---------------------------------------------------- loops, engine, pipeline

class _StreamSeen:
    """Records the ``stream`` each loop hands the kernels' wrappers."""

    NAMES = ("frame_step", "decode_step", "frame_step_batched", "decode_step_batched")

    def __init__(self, monkeypatch):
        self.seen = {}
        for name in self.NAMES:
            monkeypatch.setattr(tmagpie, name, self._wrap(name, getattr(tmagpie, name)))

    def _wrap(self, name, fn):
        def recorded(*a, stream=None, **k):
            self.seen.setdefault(name, set()).add(type(stream).__name__)
            return fn(*a, stream=stream, **k)
        return recorded


@pytest.mark.parametrize("fused", [True, False])
def test_batched_program_q8_stream_equals_dense(streams, monkeypatch, fused):
    """``synthesize_codes_batched_program(int8_stream=q8)`` (kernels C / 8's
    only caller) gives the codes of the dense program on the dequantized
    weights, fused and split, and hands the stream to the batched kernels."""
    _, pw_deq = streams["deq"]
    _, p_q8 = streams["q8"]
    rng = np.random.default_rng(12)
    tokens = torch.from_numpy(rng.integers(2, 90, size=(2, 16)))
    args = (tokens, [9, 14], [0, 1], [ts.prng_key(3), ts.prng_key(4)], 0.7, pw_deq, CONFIG,
            TOP_K)
    want = tmagpie.synthesize_codes_batched_program(*args, use_fused=fused)
    seen = _StreamSeen(monkeypatch)
    got = tmagpie.synthesize_codes_batched_program(*args, use_fused=fused, int8_stream=p_q8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    names = ("frame_step_batched",) if fused else ("decode_step_batched",)
    assert seen.seen == {n: {"Q8DecoderStream"} for n in names}


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.7, 3)])
def test_pipeline_serve_q8_codes_equal_jax(paths, temperature, seed):
    """``from_gguf(q8 file, serve_q8=True)``: block-stored weights and the Q8
    stream; codes equal the JAX pipeline on the same file (which dequantizes
    at load), greedy and seeded."""
    q8_path, _, codec = paths
    pipe = MagpiePipeline.from_gguf(q8_path, codec, device="cpu", serve_q8=True)
    assert isinstance(pipe.engine.int8_stream, tmw.Q8DecoderStream)
    assert tmw.has_q8_blocks(pipe.engine.weights)
    want = JaxPipeline.from_gguf(q8_path, codec).synthesize_codes(
        TEXT, temperature=temperature, seed=seed)
    got = pipe.synthesize_codes(TEXT, temperature=temperature, seed=seed)
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_array_equal(got, want)


def test_engine_stream_options(weights, streams):
    _, pw = weights
    _, p_q8 = streams["q8"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        MagpieEngine(pw, CONFIG, device="cpu", serve_int8=True, q8_stream=p_q8)
    eng = MagpieEngine(pw, CONFIG, device="cpu", serve_int8=True)
    want = tmw.quantize_decoder_stream(pw.decoder)
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(eng.int8_stream, f.name), getattr(want, f.name))
    assert MagpieEngine(pw, CONFIG, device="cpu").int8_stream is None


# -------------------------------------------------------------------- CLI

def test_cli_serve_int8_and_q8_exclude_each_other(paths, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["-m", paths[0], "-t", "hi", "--serve-int8", "--serve-q8"])
    assert exc.value.code == 2
    assert "not allowed with" in capsys.readouterr().err


def test_cli_serve_q8_on_f32_file_exits_1(paths, tmp_path, capsys):
    out = tmp_path / "never.wav"
    rc = cli.main(["-m", paths[1], "-c", paths[2], "-t", TEXT, "-o", str(out), "--serve-q8",
                   "--device", "cpu"])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 1 and not out.exists()
    assert len(err) == 2 and err[1].startswith("error: failed to load model:")
    assert "Q8_0" in err[1] and not any("Traceback" in ln for ln in err)


def test_cli_serve_q8_wav_equals_dequantized_serving(paths, tmp_path):
    """``--serve-q8`` at temp 0: the WAV is byte-identical to serving the same
    Q8_0 file without the flag (mirrors tests/test_cli.py's JAX check)."""
    q8_path, _, codec = paths
    outs = []
    for flags, name in ((["--serve-q8"], "q8.wav"), ([], "deq.wav")):
        out = str(tmp_path / name)
        rc = cli.main(["-m", q8_path, "-c", codec, "-t", TEXT, "-o", out, "--temp", "0",
                       "--seed", "1", "--device", "cpu", "-q"] + flags)
        assert rc == 0
        outs.append(open(out, "rb").read())
    assert len(outs[0]) > 44 and outs[0] == outs[1]


def test_cli_serve_int8_writes_the_int8_engine_wav(paths, tmp_path):
    """``--serve-int8 --device cpu``: the WAV holds the codes of the int8
    engine (the plain int8 stream), vocoded."""
    _, f32_path, codec = paths
    out = str(tmp_path / "int8.wav")
    rc = cli.main(["-m", f32_path, "-c", codec, "-t", TEXT, "-o", out, "--temp", "0.7",
                   "--seed", "2", "--device", "cpu", "--serve-int8", "-q"])
    assert rc == 0
    pipe = MagpiePipeline.from_gguf(f32_path, codec, device="cpu", serve_int8=True)
    assert isinstance(pipe.engine.int8_stream, tmw.Int8DecoderStream)
    codes = pipe.synthesize_codes(TEXT, temperature=0.7, seed=2)
    samples, sr = read_wav(out)
    pcm = pipe.codec.decode(codes, pcm16=True)
    assert sr == 22050 and codes.shape[0] > 0
    np.testing.assert_array_equal(samples, pcm.astype(np.float32) / 32767.0)
