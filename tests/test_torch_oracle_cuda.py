"""PyTorch port on the card: the native GGUF reader, dump_golden on cuda
against the CPU, the standard path against kernel A, and acceptance on
cuda, at the tiny configs.

Every test here needs a CUDA device and skips without one. This file imports
neither jax nor the JAX package:
    MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_oracle_cuda.py -q -m cuda
"""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from magpie_tts_tpu_torch.io import gguf, native
from magpie_tts_tpu_torch.io.golden import read_golden
from magpie_tts_tpu_torch.io.magpie_weights import load_magpie_weights, materialize_weights
from magpie_tts_tpu_torch.models.standard import synthesize_codes_standard
from magpie_tts_tpu_torch.runtime import engine as engine_mod
from magpie_tts_tpu_torch.text.tokenizer import MagpieTokenizer
from magpie_tts_tpu_torch.tools import acceptance, dump_golden
from tests.test_torch_cuda import SMALL, SMALL_CODEC

pytestmark = pytest.mark.cuda

TEXT = "hello world"
FRAMES = 4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return engine_mod.resolve_device("cuda")   # TF32 off


@pytest.fixture(scope="module")
def files(card, tmp_path_factory):
    root = tmp_path_factory.mktemp("oracle_cuda")
    out = {"model": str(root / "m.gguf"), "q8": str(root / "m_q8.gguf"),
           "codec": str(root / "c.gguf"), "root": root}
    chip_smoke.write_model_gguf(out["model"], SMALL, seed=7)
    chip_smoke.write_model_gguf(out["q8"], SMALL, seed=7, quant="q8_0")
    chip_smoke.write_codec_gguf(out["codec"], SMALL_CODEC, seed=7)
    for device in ("cpu", "cuda"):
        out[device] = str(root / f"golden_{device}")
        assert dump_golden.main(["-m", out["model"], "-c", out["codec"], "-t", TEXT,
                                 "-o", out[device], "--frames", str(FRAMES),
                                 "--device", device]) == 0
    return out


def test_native_reader_on_the_card_host(files):
    for path in (files["model"], files["q8"], files["codec"]):
        nat, ref = native.open_gguf(path), gguf.GGUFReader(path)
        assert nat.metadata == ref.metadata
        for name in ref.tensors:
            a, b = nat.tensor(name), ref.tensor(name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
            assert nat.raw(name).tobytes() == np.asarray(ref.raw(name)).tobytes(), name
    for q8_native in (False, True):
        a = materialize_weights(load_magpie_weights(files["q8"], q8_native=q8_native)[1])
        b = materialize_weights(load_magpie_weights(
            files["q8"], reader=gguf.GGUFReader(files["q8"]), q8_native=q8_native)[1])
        fa, fb = a.flatten(), b.flatten()
        assert all(torch.equal(fa[k], fb[k]) for k in fa)


def test_dump_golden_cuda_matches_cpu(files):
    """Within the CPU bars: tokens and codes exact, codec intermediates
    5e-5, the other float32 traces 1e-5 (kernel A's greedy frames included)."""
    names = sorted(p.stem for p in Path(files["cpu"]).glob("*.bin"))
    assert names == sorted(p.stem for p in Path(files["cuda"]).glob("*.bin"))
    for name in names:
        a = read_golden(f"{files['cpu']}/{name}.bin")
        b = read_golden(f"{files['cuda']}/{name}.bin")
        bar = (0.0 if name in ("tokens", "greedy_codes", "lt_greedy_codes", "codec_latent")
               else 5e-5 if name.startswith("codec") else 1e-5)
        assert a.shape == b.shape, name
        err = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
        assert err <= bar, (name, err)


def test_standard_path_against_kernel_a(files, card):
    """Temperature 0: the standard path's codes on cuda equal the cached
    engine's (kernel A), or differ only at a near-tie (codes_agree)."""
    config, weights = load_magpie_weights(files["model"])
    tokens = MagpieTokenizer.from_gguf_metadata(native.open_gguf(files["model"]).metadata
                                                ).encode(TEXT)
    w = weights.to(device=card)
    std = synthesize_codes_standard(tokens, w, config, temperature=0.0, max_steps=8)
    cached = dump_golden.greedy_codes(weights, config, tokens, 0, 8, card)
    agree = chip_smoke.standard_against_cached(w, config, tokens, std, cached, card)
    assert agree["frames"] >= 2


def _acceptance(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = acceptance.main(argv)
    return rc, out.getvalue()


def test_acceptance_on_cuda_passes(files):
    rc, out = _acceptance(["-m", files["model"], "-c", files["codec"], "-r", files["cpu"],
                           "-t", TEXT, "--max-frames", str(FRAMES), "--device", "cuda"])
    assert rc == 0 and "ACCEPTANCE: PASS" in out, out
    rc, out = _acceptance(["-m", files["q8"], "-t", TEXT, "--max-frames", "6",
                           "--device", "cuda"])
    assert rc == 0 and "frames exactly equal" in out, out
