"""PyTorch port, the serve path: CodecEngine.decode_batch and ``cli.main
serve`` on tiny GGUF checkpoints against the JAX package, on the CPU."""

import io
import json

import numpy as np
import pytest
import torch

from magpie_tts_tpu.parallel.continuous import ContinuousBatchingEngine as JaxContinuous
from magpie_tts_tpu.pipeline import MagpiePipeline as JaxPipeline
from magpie_tts_tpu_torch import cli
from magpie_tts_tpu_torch.io.wav import read_wav, write_wav
from magpie_tts_tpu_torch.pipeline import MagpiePipeline
from tests import fixtures

REQUESTS = [('{"id": "a", "text": "hello world", "seed": 3}', "a"),
            ("abc, def.", None),
            ('{"id": "broken", "text": ', None)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve")
    mpath, cpath = str(tmp / "magpie.gguf"), str(tmp / "codec.gguf")
    fixtures.write_tiny_magpie_gguf(mpath, seed=0)
    fixtures.write_tiny_codec_gguf(cpath, seed=1)
    return mpath, cpath


@pytest.fixture(scope="module")
def pipelines(paths):
    return JaxPipeline.from_gguf(*paths), MagpiePipeline.from_gguf(*paths, device="cpu")


def test_decode_batch_matches_jax(pipelines):
    """Utterances of different lengths (one empty) in one batched call."""
    jp, tp = pipelines
    rng = np.random.default_rng(2)
    codes = [rng.integers(0, 32, size=(n, 8)).astype(np.int32) for n in (7, 30, 0, 13)]
    want = jp.codec.decode_batch(codes)
    got = tp.codec.decode_batch(codes)
    hop = tp.codec.config.hop_length
    for c, g, w in zip(codes, got, want):
        assert g.dtype == np.float32 and g.shape == (c.shape[0] * hop,)
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=0)


def test_serve_matches_jax_continuous_engine(paths, pipelines, tmp_path, monkeypatch, capsys):
    """One JSON request, one plain line, one malformed line at temp 0: a
    result line per good request, an error line for the bad one, WAVs of
    frames * hop samples equal to the JAX continuous engine's codes through
    the JAX decode_batch."""
    jp, _ = pipelines
    out_dir = tmp_path / "wavs"
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(r for r, _ in REQUESTS) + "\n"))
    rc = cli.main(["serve", "-m", paths[0], "-c", paths[1], "--out-dir", str(out_dir),
                   "--slots", "2", "--segment-frames", "4", "--temp", "0", "--top-k", "8",
                   "--device", "cpu", "--dtype", "float32", "-q"])
    assert rc == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    errors = [ln for ln in lines if "error" in ln]
    results = {ln["id"]: ln for ln in lines if "error" not in ln}
    assert len(errors) == 1 and "malformed" in errors[0]["error"]
    assert sorted(results) == ["1", "a"]

    jeng = JaxContinuous(jp.engine.weights, jp.config, n_slots=2, segment_frames=4)
    jeng.split_token_id = jp.tokenizer.space_id
    ids = [jeng.submit(jp.tokenizer.encode("hello world"), seed=3),
           jeng.submit(jp.tokenizer.encode("abc, def."))]
    finished = {}
    while jeng.pending:
        finished.update(jeng.step(temperature=0.0, top_k=8))
    want_audio = jp.codec.decode_batch([finished[i] for i in ids])
    hop = jp.codec.config.hop_length
    for name, rid, audio in zip(("a", "1"), ids, want_audio):
        res = results[name]
        assert res["frames"] == finished[rid].shape[0] > 0
        samples, sr = read_wav(res["wav"])
        assert sr == 22050 and len(samples) == res["frames"] * hop
        ref = tmp_path / f"ref_{name}.wav"   # the same int16 rounding
        write_wav(str(ref), audio, 22050)
        np.testing.assert_allclose(samples, read_wav(str(ref))[0], atol=5e-5, rtol=0)


def test_serve_without_cuda_exits_1(paths, tmp_path, monkeypatch, capsys):
    """No silent fallback: no CUDA device and no --device cpu is an error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.stdin", io.StringIO("hello\n"))
    rc = cli.main(["serve", "-m", paths[0], "-c", paths[1], "--out-dir", str(tmp_path / "o")])
    assert rc == 1 and not (tmp_path / "o").exists()
    assert "no CUDA device" in capsys.readouterr().err
