"""PyTorch port, streaming synthesis and ``warmup``: sentence splitting, the
chunked decode loop (``target_frames``, per-chunk keys) against the JAX
engine's ``decode_chunk``, ``stream_text`` against the JAX package's (float32
here, bfloat16 in a child process without XLA's excess precision), the
streamed audio against the offline decode, the stall and abort rules, the
pipeline surfaces and the CLI (``--stream``, ``warmup``), on the CPU at the
tiny config."""

import jax
import numpy as np
import pytest
import torch

from magpie_tts_tpu.pipeline import MagpiePipeline as JaxPipeline
from magpie_tts_tpu.runtime import streaming as jstreaming
from magpie_tts_tpu.runtime.engine import MagpieEngine as JaxEngine
from magpie_tts_tpu.runtime.engine import split_to_buckets
from magpie_tts_tpu_torch import cli
from magpie_tts_tpu_torch.io.wav import read_wav
from magpie_tts_tpu_torch.models import magpie as tmagpie
from magpie_tts_tpu_torch.ops import sampling
from magpie_tts_tpu_torch.ops.kernels import build
from magpie_tts_tpu_torch.pipeline import MagpiePipeline
from magpie_tts_tpu_torch.runtime import streaming
from magpie_tts_tpu_torch.runtime.engine import MagpieEngine
from tests import fixtures
from tests.test_torch_support import jax_reference_without_excess_precision

TEXT = "hello world"
# Two sentences, the second longer than a 16-token bucket (split at words).
STREAM_TEXT = "hello world. " + " ".join(["abc def"] * 4) + " hello!"
BF16_TEXT = "hello world. abc def!"
PARAMS = dict(temperature=0.7, seed=3, top_k=80)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_streaming")
    mpath, cpath = str(tmp / "magpie.gguf"), str(tmp / "codec.gguf")
    fixtures.write_tiny_magpie_gguf(mpath, seed=0)
    fixtures.write_tiny_codec_gguf(cpath, seed=1)
    return mpath, cpath


@pytest.fixture(scope="module")
def pipelines(paths):
    return JaxPipeline.from_gguf(*paths), MagpiePipeline.from_gguf(*paths, device="cpu")


def _bucket16(jp, tp):
    """Both packages' engines with one 16-token bucket."""
    return (JaxEngine(jp.engine.weights, jp.config, token_buckets=(16,),
                      split_token_id=jp.tokenizer.space_id),
            MagpieEngine(tp.engine.weights, tp.config, device="cpu", token_buckets=(16,),
                         split_token_id=tp.tokenizer.space_id))


@pytest.mark.parametrize("text,want", [
    ("Hello world. How are you?", ["Hello world.", "How are you?"]),
    ("No ending", ["No ending"]),
    ("Dr.Smith went home!  Then\tslept.", ["Dr.Smith went home!", "Then\tslept."]),
    ("Wait... what?!", ["Wait...", "what?!"]),
    ("  ", []),
])
def test_split_sentences(text, want):
    assert streaming.split_sentences(text) == want == jstreaming.split_sentences(text)


def _chunks(engine, tokens, n, **kw):
    stream = engine.begin_stream(tokens)
    out, done = [], False
    while not done:
        codes, done = engine.decode_chunk(stream, n_frames=n, **kw)
        out.append(np.asarray(codes))
    return out


def test_decode_chunks_match_jax_decode_chunk(pipelines):
    """decode_loop(target_frames=) chunk by chunk, each chunk with
    fold_in(PRNGKey(seed), chunk) and the split chain restarted at its first
    frame: the JAX engine's codes exactly, at temp 0.7."""
    jp, tp = pipelines
    tokens = tp.tokenizer.encode(TEXT)
    want = _chunks(jp.engine, tokens, 2, **PARAMS)
    got = _chunks(tp.engine, tokens, 2, **PARAMS)
    assert [len(c) for c in got] == [len(c) for c in want] and len(got) > 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_first_chunk_key_is_fold_in_zero(pipelines):
    """Chunk 0 samples with fold_in(PRNGKey(seed), 0) (not PRNGKey(seed)):
    the same key as jax.random.fold_in, and the same codes as decode_loop
    with that key up to target_frames; a later call continues the state."""
    _, tp = pipelines
    key = sampling.fold_in(sampling.prng_key(3), 0)
    want_key = jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(3), 0))
    assert tuple(int(v) for v in np.asarray(want_key, np.uint32)) == tuple(key)
    eng, cfg = tp.engine, tp.config
    tokens = tp.tokenizer.encode(TEXT)
    first, _ = eng.decode_chunk(eng.begin_stream(tokens), n_frames=4, temperature=0.7, seed=3)
    tok, n = eng._pad_tokens(tokens)
    with torch.no_grad():
        xa_k, xa_v, st = tmagpie.prepare(tok, n, 0, eng.weights, cfg)
        st = tmagpie.decode_loop(xa_k, xa_v, st, n, eng.weights, cfg, key, 0.7, 80,
                                 target_frames=4)
        assert st.frame_idx == 4 and not st.done
        np.testing.assert_array_equal(first, st.codes[:4])
        st = tmagpie.decode_loop(xa_k, xa_v, st, n, eng.weights, cfg, key, 0.7, 80,
                                 target_frames=6)
    assert st.frame_idx == 6 or st.done


def _port_stream(engine, codec, tokenizer, text, params):
    """stream_text's chunks, and each piece's codes (read from its stream)."""
    streams = []
    begin = engine.begin_stream

    def record(*a, **k):
        streams.append(begin(*a, **k))
        return streams[-1]

    engine.begin_stream = record
    try:
        chunks = list(streaming.stream_text(engine, codec, tokenizer, text, params))
    finally:
        del engine.begin_stream
    return chunks, [s["state"].codes[:s["state"].frame_idx] for s in streams]


def _meta(chunks):
    return [(c.sentence_index, c.total_sentences, c.frames_generated, c.is_sentence_end)
            for c in chunks]


def test_stream_text_matches_jax(pipelines):
    """Two sentences, the second split at words (a 16-token bucket): the
    chunks' metadata equal, every piece's codes equal the JAX engine's
    chunked decode, and the audio within 5e-5 (float32 conv order)."""
    jp, tp = pipelines
    jeng, teng = _bucket16(jp, tp)
    jparams = jstreaming.StreamParams(**PARAMS)
    want = list(jstreaming.stream_text(jeng, jp.codec, jp.tokenizer, STREAM_TEXT, jparams))
    got, codes = _port_stream(teng, tp.codec, tp.tokenizer, STREAM_TEXT,
                              streaming.StreamParams(**PARAMS))
    pieces = [p for s in streaming.split_sentences(STREAM_TEXT)
              for p in split_to_buckets(tp.tokenizer.encode(s), (16,), tp.tokenizer.space_id,
                                        tp.config.text_bos_id, tp.config.text_eos_id)]
    assert _meta(got) == _meta(want) and len(codes) == len(pieces) > 2
    for g, w in zip(got, want):
        assert g.samples.dtype == np.float32 and g.samples.shape == w.samples.shape
        np.testing.assert_allclose(g.samples, w.samples, atol=5e-5, rtol=0)
    for piece, got_codes in zip(pieces, codes):
        want_codes = np.concatenate(_chunks(jeng, piece, 4, **PARAMS))
        np.testing.assert_array_equal(got_codes, want_codes)


def jax_stream_bf16_reference(model: str, codec: str) -> dict:
    """JAX stream_text in bfloat16 and each sentence's chunked codes (run in
    the child process of jax_reference_without_excess_precision)."""
    import jax.numpy as jnp

    jp = JaxPipeline.from_gguf(model, codec, compute_dtype=jnp.bfloat16)
    chunks = list(jp.stream(BF16_TEXT, jstreaming.StreamParams(**PARAMS)))
    out = {"meta": np.array(_meta(chunks), np.int64),
           "lens": np.array([len(c.samples) for c in chunks], np.int64),
           "audio": np.concatenate([c.samples for c in chunks]).astype(np.float32)}
    for i, s in enumerate(jstreaming.split_sentences(BF16_TEXT)):
        out[f"codes{i}"] = np.concatenate(_chunks(jp.engine, jp.tokenizer.encode(s), 4,
                                                  **PARAMS))
    return out


def test_stream_text_matches_jax_bf16(paths):
    """In bfloat16: codes exactly the JAX engine's, the audio within the bf16
    codec's bar against the JAX package's XLA codec (test_torch_bf16: at
    most 0.02 anywhere, 0.002 on average; the port rounds where the Pallas
    kernels do)."""
    ref = jax_reference_without_excess_precision(
        "tests.test_torch_streaming:jax_stream_bf16_reference", model=paths[0], codec=paths[1])
    tp = MagpiePipeline.from_gguf(*paths, device="cpu", compute_dtype=torch.bfloat16)
    got, codes = _port_stream(tp.engine, tp.codec, tp.tokenizer, BF16_TEXT,
                              streaming.StreamParams(**PARAMS))
    assert np.array_equal(np.array(_meta(got), np.int64), ref["meta"])
    assert [len(c.samples) for c in got] == list(ref["lens"])
    for i, c in enumerate(codes):
        np.testing.assert_array_equal(c, ref[f"codes{i}"])
    audio = np.concatenate([c.samples for c in got])
    assert np.abs(audio - ref["audio"]).max() <= 0.02
    assert np.abs(audio - ref["audio"]).mean() <= 0.002


@pytest.mark.parametrize("frames_per_chunk", [4, 5])
def test_streamed_audio_equals_offline_decode(pipelines, frames_per_chunk):
    """At temp 0 a one-sentence stream's audio equals the offline decode of
    the same codes: each chunk vocodes its frames after 32 context frames
    (the window starts at frame 0 while the stream is short)."""
    _, tp = pipelines
    params = streaming.StreamParams(temperature=0.0, frames_per_chunk=frames_per_chunk)
    chunks = list(tp.stream(TEXT, params))
    codes = tp.synthesize_codes(TEXT, temperature=0.0)
    assert chunks[-1].frames_generated == codes.shape[0] and chunks[-1].is_sentence_end
    assert len(chunks) == -(-codes.shape[0] // frames_per_chunk)
    np.testing.assert_array_equal(np.concatenate([c.samples for c in chunks]),
                                  tp.synthesize(TEXT, temperature=0.0))


def test_stall_raises_and_abort_returns_minus_one(pipelines, monkeypatch):
    _, tp = pipelines
    calls = []

    def on_audio(samples):
        calls.append(len(samples))
        return len(calls) < 2

    progress = []
    total = streaming.synthesize_streaming(tp.engine, tp.codec, tp.tokenizer, TEXT,
                                           streaming.StreamParams(**PARAMS), on_audio,
                                           lambda *a: progress.append(a))
    assert total == -1 and len(calls) == 2 and progress[0][1:] == (0, 1)
    total = streaming.synthesize_streaming(tp.engine, tp.codec, tp.tokenizer, TEXT,
                                           streaming.StreamParams(**PARAMS), lambda s: True)
    assert total == sum(len(c.samples) for c in tp.stream(TEXT, streaming.StreamParams(**PARAMS)))

    eng = MagpieEngine(tp.engine.weights, tp.config, device="cpu")
    monkeypatch.setattr(eng, "decode_chunk",
                        lambda stream, **k: (np.zeros((0, 8), np.int32), False))
    with pytest.raises(RuntimeError, match="no progress"):
        list(streaming.stream_sentence(eng, tp.codec, tp.tokenizer.encode(TEXT),
                                       streaming.StreamParams()))


def test_pipeline_surfaces(pipelines, tmp_path):
    _, tp = pipelines
    codes = tp.synthesize_codes(TEXT, **PARAMS)
    audio = tp.synthesize(TEXT, **PARAMS)
    np.testing.assert_array_equal(audio, tp.codec.decode(codes))
    out = str(tmp_path / "p.wav")
    n = tp.synthesize_to_wav(TEXT, out, **PARAMS)
    samples, sr = read_wav(out)
    assert n == len(samples) == codes.shape[0] * tp.codec.config.hop_length and sr == 22050
    np.testing.assert_array_equal(
        np.round(samples * 32767).astype(np.int16), tp.codec.decode(codes, pcm16=True))
    chunks = list(tp.stream(TEXT, streaming.StreamParams(**PARAMS)))
    assert sum(len(c.samples) for c in chunks) > 0 and chunks[-1].is_sentence_end
    hop = tp.codec.config.hop_length
    np.testing.assert_array_equal(tp.codec.decode_with_context(codes, 3),
                                  tp.codec.decode(codes)[3 * hop:])
    tp.warmup(token_buckets=(16,))
    tp.warmup(streaming_path=True, token_buckets=(16,))
    tp.engine.warmup(token_buckets=(16,), split_stream=True)
    with pytest.raises(ValueError, match="codec"):
        tp.engine.warmup(streaming=True)


def test_cli_stream_writes_the_offline_wav(paths, tmp_path, capsys):
    """--stream logs the time to first audio; at temp 0 on one sentence its
    WAV is byte-identical to the offline synth's."""
    outs = {}
    for flag in ((), ("--stream",)):
        out = str(tmp_path / f"out{len(flag)}.wav")
        rc = cli.main(["-m", paths[0], "-c", paths[1], "-t", TEXT, "-o", out, "--device",
                       "cpu", "--temp", "0", *flag])
        cap = capsys.readouterr()
        assert rc == 0 and cap.out.strip() == out
        assert ("time to first audio" in cap.err) == bool(flag)
        assert "x real-time" in cap.err
        outs[flag] = open(out, "rb").read()
    assert outs[()] == outs[("--stream",)]


def test_cli_warmup_all_surfaces(paths, capsys):
    rc = cli.main(["warmup", "-m", paths[0], "-c", paths[1], "--device", "cpu", "--surfaces",
                   "all", "--buckets", "16"])
    cap = capsys.readouterr()
    assert rc == 0 and cap.out.strip() == str(build.library_path())
    for name in ("offline", "codec", "fused", "stream", "serve"):
        assert f"warmup: {name}" in cap.err


@pytest.mark.parametrize("argv,rc,msg", [
    (["--cache-dir", "/tmp/never"], 2, "compilation cache"),
    (["--surfaces", "offline,bogus"], 1, "unknown surface"),
])
def test_cli_warmup_refusals(argv, rc, msg, capsys):
    assert cli.main(["warmup", *argv]) == rc
    assert msg in capsys.readouterr().err
