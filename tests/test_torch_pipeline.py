"""PyTorch port, the slice end to end: MagpiePipeline.from_gguf and the CLI
on tiny GGUF checkpoints against the JAX package, on the CPU."""

import numpy as np
import pytest
import torch

from magpie_tts_tpu.pipeline import MagpiePipeline as JaxPipeline
from magpie_tts_tpu.runtime.engine import MagpieEngine as JaxEngine
from magpie_tts_tpu_torch import cli
from magpie_tts_tpu_torch.io.wav import read_wav
from magpie_tts_tpu_torch.pipeline import MagpiePipeline
from magpie_tts_tpu_torch.runtime import engine as tengine
from tests import fixtures

TEXT = "hello world"
LONG_TEXT = " ".join(["hello world"] * 6) + ", abc."


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pipeline")
    mpath, cpath = str(tmp / "magpie.gguf"), str(tmp / "codec.gguf")
    fixtures.write_tiny_magpie_gguf(mpath, seed=0)
    fixtures.write_tiny_codec_gguf(cpath, seed=1)
    return mpath, cpath


@pytest.fixture(scope="module")
def pipelines(paths):
    return JaxPipeline.from_gguf(*paths), MagpiePipeline.from_gguf(*paths, device="cpu")


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.7, 3)])
def test_codes_equal_jax(pipelines, temperature, seed):
    jp, tp = pipelines
    want = jp.synthesize_codes(TEXT, temperature=temperature, seed=seed)
    got = tp.synthesize_codes(TEXT, temperature=temperature, seed=seed)
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_array_equal(got, want)


def test_waveform_matches_jax(pipelines):
    jp, tp = pipelines
    codes = jp.synthesize_codes(TEXT, temperature=0.7, seed=3)
    want = jp.codec.decode(codes)
    got = tp.codec.decode(codes)
    assert got.shape == want.shape == (codes.shape[0] * tp.codec.config.hop_length,)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    pcm = tp.codec.decode(codes, pcm16=True)
    assert pcm.dtype == np.int16
    assert np.abs(pcm.astype(np.int32) - jp.codec.decode(codes, pcm16=True)).max() <= 1


def test_over_long_input_chunks_like_jax(pipelines):
    """Inputs past the largest token bucket split at word boundaries; chunk
    i > 0 samples with fold_in(PRNGKey(seed), i) in both packages."""
    jp, tp = pipelines
    tokens = tp.tokenizer.encode(LONG_TEXT)
    assert len(tokens) > 16
    jeng = JaxEngine(jp.engine.weights, jp.config, token_buckets=(16,),
                     split_token_id=jp.tokenizer.space_id)
    teng = tengine.MagpieEngine(tp.engine.weights, tp.config, device="cpu",
                                token_buckets=(16,), split_token_id=tp.tokenizer.space_id)
    want = jeng.synthesize_codes(tokens, temperature=0.7, seed=5).codes
    got = teng.synthesize_codes(tokens, temperature=0.7, seed=5).codes
    np.testing.assert_array_equal(got, want)


def test_synthesize_audio_fused_is_codes_then_pcm16(pipelines):
    _, tp = pipelines
    tokens = tp.tokenizer.encode(TEXT)
    pcm, n = tengine.synthesize_audio_fused(tp.engine, tp.codec, tokens, temperature=0.7,
                                            seed=3)
    codes = tp.synthesize_codes(TEXT, temperature=0.7, seed=3)
    assert n == codes.shape[0]
    np.testing.assert_array_equal(pcm, tp.codec.decode(codes, pcm16=True))


def test_cli_cpu_writes_wav(paths, pipelines, tmp_path, capsys):
    _, tp = pipelines
    out = str(tmp_path / "out.wav")
    rc = cli.main(["-m", paths[0], "-c", paths[1], "-t", TEXT, "-o", out, "--device", "cpu",
                   "--temp", "0.7", "--seed", "3", "-q"])
    assert rc == 0
    assert capsys.readouterr().out.strip() == out
    samples, sr = read_wav(out)
    n = tp.synthesize_codes(TEXT, temperature=0.7, seed=3).shape[0]
    assert sr == 22050 and len(samples) == n * tp.codec.config.hop_length


def test_cli_without_cuda_exits_1(paths, tmp_path, monkeypatch, capsys):
    """No silent fallback: with no CUDA device and no --device cpu, exit 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.wav"
    rc = cli.main(["-m", paths[0], "-c", paths[1], "-t", TEXT, "-o", str(out)])
    assert rc == 1 and not out.exists()
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("argv,rc", [
    (["serve", "--dtype", "bfloat16", "--device", "cpu"], 1), (["warmup"], 2),
    (["--stream"], 2), (["--serve-q8"], 2), (["--dtype", "bfloat16", "--device", "cpu"], 1)])
def test_cli_rejects_what_is_not_ported(argv, rc, capsys):
    assert cli.main(argv) == rc
    assert "not ported" in capsys.readouterr().err


def test_engines_refuse_bfloat16_and_missing_cuda(pipelines, monkeypatch):
    _, tp = pipelines
    with pytest.raises(NotImplementedError):
        tengine.MagpieEngine(tp.engine.weights, tp.config, device="cpu",
                             compute_dtype=torch.bfloat16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tengine.CodecEngine(tp.codec.weights, tp.codec.config, device="cuda")
