"""PyTorch port, IO and text: weights, GGUF loading, tokenizer, WAV, and the
rule that the port never imports jax or the JAX package."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from magpie_tts_tpu.io import codec_weights as jcw
from magpie_tts_tpu.io import magpie_weights as jmw
from magpie_tts_tpu.io.gguf import GGUFReader as JReader
from magpie_tts_tpu.io.wav import write_wav as jax_write_wav
from magpie_tts_tpu.text.tokenizer import MagpieTokenizer as JTokenizer
from magpie_tts_tpu.text.tokenizer import chunk_token_ids as j_chunk
from magpie_tts_tpu_torch.config import CodecConfig, MagpieConfig
from magpie_tts_tpu_torch.io import codec_weights as tcw
from magpie_tts_tpu_torch.io import magpie_weights as tmw
from magpie_tts_tpu_torch.io.gguf import GGUFReader
from magpie_tts_tpu_torch.io.wav import read_wav, write_wav
from magpie_tts_tpu_torch.text.tokenizer import MagpieTokenizer, chunk_token_ids
from tests import fixtures
from tests.test_torch_support import jax_params
from tests.utils import tiny_codec_config, tiny_magpie_config

REPO = Path(__file__).resolve().parent.parent


def _assert_same(port_flat, jax_flat):
    assert set(port_flat) == set(jax_flat)
    for key, arr in jax_flat.items():
        got = port_flat[key]
        assert got.dtype == torch.float32, key
        np.testing.assert_array_equal(got.numpy(), arr, err_msg=key)


@pytest.mark.parametrize("seed", [0, 11])
def test_random_magpie_weights_bit_equal(seed):
    c = tiny_magpie_config()
    _assert_same(tmw.random_magpie_weights(c, seed=seed).flatten(),
                 jax_params(jmw.random_magpie_weights(c, seed=seed)))


def test_random_codec_weights_bit_equal():
    c = tiny_codec_config()
    _assert_same(tcw.random_codec_weights(c, seed=5).flatten(),
                 jax_params(jcw.random_codec_weights(c, seed=5)))


@pytest.mark.parametrize("quant", [None, "q8_0"])
def test_magpie_gguf_loads_like_jax(tmp_path, quant):
    path = str(tmp_path / "m.gguf")
    fixtures.write_tiny_magpie_gguf(path, seed=2, quant=quant)
    jconfig, jweights = jmw.load_magpie_weights(path, reader=JReader(path))
    config, weights = tmw.load_magpie_weights(path)
    assert config == MagpieConfig(**{f: getattr(jconfig, f)
                                     for f in jconfig.__dataclass_fields__})
    _assert_same(weights.flatten(), jax_params(jweights))


def test_codec_gguf_loads_like_jax(tmp_path):
    path = str(tmp_path / "c.gguf")
    fixtures.write_tiny_codec_gguf(path, seed=4)
    jconfig, jweights = jcw.load_codec_weights(path, reader=JReader(path))
    config, weights = tcw.load_codec_weights(path)
    assert config == CodecConfig(**{f: getattr(jconfig, f)
                                    for f in jconfig.__dataclass_fields__})
    _assert_same(weights.flatten(), jax_params(jweights))


def test_weights_from_numpy_rejects_unknown_and_missing_keys():
    flat = {k: v.numpy() for k, v in
            tmw.random_magpie_weights(tiny_magpie_config(), seed=0).flatten().items()}
    with pytest.raises(KeyError):
        tmw.magpie_weights_from_numpy({**flat, "decoder.bogus": np.zeros(1)})
    del flat["lt.qkv"]
    with pytest.raises(KeyError):
        tmw.magpie_weights_from_numpy(flat)


def test_weights_to_device_and_dtype_keeps_structure():
    w = tcw.random_codec_weights(tiny_codec_config(), seed=1)
    moved = w.to(device="cpu", dtype=torch.float64)
    assert set(moved.flatten()) == set(w.flatten())
    assert all(v.dtype == torch.float64 for v in moved.flatten().values())


TEXTS = ["hello world", "Hello, world! 42 apples.", "It's 1999; pay $5 or 12%.",
         "the 3rd of May", "xyz qq", ""]


@pytest.fixture(scope="module")
def gguf_metadata(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "m.gguf")
    fixtures.write_tiny_magpie_gguf(path)
    return GGUFReader(path).metadata


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_ids_equal(gguf_metadata, text):
    assert (MagpieTokenizer.from_gguf_metadata(gguf_metadata).encode(text) ==
            JTokenizer.from_gguf_metadata(gguf_metadata).encode(text))


def test_chunk_token_ids_equal():
    rng = np.random.default_rng(0)
    ids = [98] + [int(x) for x in rng.integers(0, 96, size=200)] + [99]
    for max_len in (8, 16, 33, 500):
        assert chunk_token_ids(ids, max_len, 93, 98, 99) == j_chunk(ids, max_len, 93, 98, 99)


def test_wav_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.2, 1.2, size=999).astype(np.float32)
    write_wav(str(tmp_path / "a.wav"), x)
    jax_write_wav(str(tmp_path / "b.wav"), x)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    samples, sr = read_wav(str(tmp_path / "a.wav"))
    assert sr == 22050 and samples.shape == (999,)


def test_port_never_imports_jax():
    """Import every module of the port in a fresh interpreter: neither jax,
    flax nor the JAX package may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import magpie_tts_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'magpie_tts_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(mods) > 20, mods\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("codec", ["q8_0", "q4_0"])
def test_block_quant_codecs_equal_jax(codec):
    """The port's Q8_0/Q4_0 byte codecs (writer and dequant-at-load) equal
    the JAX package's bit for bit, including a ragged last block."""
    from magpie_tts_tpu.io import quant as jq
    from magpie_tts_tpu_torch.io import quant as tq

    x = np.random.default_rng(3).normal(0, 0.05, size=(7, 37)).astype(np.float32)
    x.reshape(-1)[64:96] = 0.0                    # block 2 all zero
    data = getattr(tq, f"quantize_{codec}")(x)
    assert data == getattr(jq, f"quantize_{codec}")(x)
    payload = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(getattr(tq, f"dequantize_{codec}")(payload, x.size),
                                  getattr(jq, f"dequantize_{codec}")(payload, x.size))
