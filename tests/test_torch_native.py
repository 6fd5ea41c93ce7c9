"""PyTorch port, the native GGUF reader (magpie_tts_tpu_torch/io/native.py):
held to the port's numpy reader and to the JAX package's NativeGGUFReader on
F32, F16, Q4_0, Q8_0 and I32 tensors, through the loaders bit for bit, and
raising where the JAX reader would fall back."""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from magpie_tts_tpu.io import native as jnative
from magpie_tts_tpu_torch import config as tconfig
from magpie_tts_tpu_torch.io import gguf
from magpie_tts_tpu_torch.io import native
from magpie_tts_tpu_torch.io.codec_weights import load_codec_weights
from magpie_tts_tpu_torch.io.magpie_weights import (load_magpie_weights, q8_blocks,
                                                     q8_stream_from_gguf)
from magpie_tts_tpu_torch.text.tokenizer import MagpieTokenizer
from tests.utils import tiny_codec_config, tiny_magpie_config

REPO = Path(__file__).resolve().parent.parent
# Metadata of every scalar type the format has, beside the writer's own.
EXTRA_KV = [("x.u8", gguf.T_UINT8, 200), ("x.i8", gguf.T_INT8, -100),
            ("x.u16", gguf.T_UINT16, 60000), ("x.i16", gguf.T_INT16, -30000),
            ("x.i32", gguf.T_INT32, -7), ("x.u64", gguf.T_UINT64, 2**40 + 3),
            ("x.i64", gguf.T_INT64, -2**40 - 5), ("x.f32_whole", gguf.T_FLOAT32, 2.0),
            ("x.f32", gguf.T_FLOAT32, 0.1), ("x.f64", gguf.T_FLOAT64, 1.0 / 3.0),
            ("x.false", gguf.T_BOOL, False), ("x.true", gguf.T_BOOL, True),
            ("x.utf8", gguf.T_STRING, "grüße\nzwei Zeilen")]


def _mixed_file(path: str) -> dict:
    rng = np.random.default_rng(5)
    arrays = {"f32": (rng.normal(size=(3, 5, 7)).astype(np.float32), gguf.GGML_F32),
              "f16": (rng.normal(size=(8, 64)).astype(np.float32), gguf.GGML_F16),
              "q4": (rng.normal(size=(4, 96)).astype(np.float32), gguf.GGML_Q4_0),
              "q8": (rng.normal(size=(2, 3, 64)).astype(np.float32), gguf.GGML_Q8_0),
              "q8_zero_block": (np.zeros((1, 64), np.float32), gguf.GGML_Q8_0),
              # halves below 2**-14: subnormal F16 values and Q8_0 / Q4_0 scales
              "f16_subnormal": (np.float32([[1.5e-5, -3e-7, 6e-8, 1.0]]), gguf.GGML_F16),
              "q8_subnormal": (np.concatenate([np.full(32, 1e-4), np.full(32, 0.5)]
                                              ).astype(np.float32)[None], gguf.GGML_Q8_0),
              "q4_subnormal": (np.full((1, 32), 3e-5, np.float32), gguf.GGML_Q4_0),
              "i32": (rng.integers(-1000, 1000, size=(6,)).astype(np.int32), gguf.GGML_I32),
              "scalar_row": (np.float32([1.5]), gguf.GGML_F32)}
    wr = gguf.GGUFWriter()
    wr.add_metadata("general.architecture", "test")
    wr._kv.extend(EXTRA_KV)
    for name, (arr, ggml_type) in arrays.items():
        wr.add_tensor(name, arr, ggml_type)
    wr.write(path)
    return arrays


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_native")
    out = {"mixed": str(tmp / "mixed.gguf"), "f32": str(tmp / "m.gguf"),
           "q8": str(tmp / "m_q8.gguf"), "codec": str(tmp / "c.gguf")}
    _mixed_file(out["mixed"])
    chip_smoke.write_model_gguf(out["f32"], tiny_magpie_config(), seed=3)
    chip_smoke.write_model_gguf(out["q8"], tiny_magpie_config(), seed=3, quant="q8_0")
    chip_smoke.write_codec_gguf(out["codec"], tiny_codec_config(), seed=4)
    return out


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("which", ["mixed", "f32", "q8", "codec"])
def test_metadata_equal_in_value_and_type(files, which):
    nat, ref = native.open_gguf(files[which]), gguf.GGUFReader(files[which])
    assert nat.metadata == ref.metadata
    assert {k: type(v) for k, v in nat.metadata.items()} == \
        {k: type(v) for k, v in ref.metadata.items()}
    assert nat.array_keys == []


def test_metadata_against_jax_native_reader(files):
    """The JAX reader holds the same values; it turns whole floats (and
    bools) into ints, which the port's reader types by gguf_kv_type."""
    nat, jax_nat = native.open_gguf(files["mixed"]), jnative.NativeGGUFReader(files["mixed"])
    assert nat.metadata == jax_nat.metadata
    assert type(nat.metadata["x.f32_whole"]) is float and type(nat.metadata["x.true"]) is bool
    assert type(jax_nat.metadata["x.f32_whole"]) is int


def _assert_equal_but_halved(got: np.ndarray, jax_got: np.ndarray, name: str) -> None:
    """The JAX package's native reader: bit-equal, except where a stored half
    is subnormal, which it takes to half its value (test_subnormal_halves_corrected)."""
    assert got.dtype == jax_got.dtype and got.shape == jax_got.shape, name
    off = got.view(np.uint8).reshape(got.size, -1) != jax_got.view(np.uint8).reshape(got.size, -1)
    off = off.any(axis=1).reshape(got.shape)
    np.testing.assert_array_equal(jax_got[off] * 2, got[off], err_msg=name)


@pytest.mark.parametrize("which", ["mixed", "f32", "q8", "codec"])
def test_tensors_and_raw_bit_equal(files, which):
    nat, ref = native.open_gguf(files[which]), gguf.GGUFReader(files[which])
    jax_nat = jnative.NativeGGUFReader(files[which])
    assert list(nat.tensors) == list(ref.tensors)
    for name, info in ref.tensors.items():
        got = nat.tensors[name]
        assert (got.name, got.shape, got.ggml_type) == (info.name, info.shape, info.ggml_type)
        assert _same_bits(nat.tensor(name), ref.tensor(name)), name
        _assert_equal_but_halved(nat.tensor(name), jax_nat.tensor(name), name)
        assert _same_bits(nat.raw(name), np.asarray(ref.raw(name))), name
        assert _same_bits(nat.raw(name), jax_nat.raw(name)), name
        if info.ggml_type in (gguf.GGML_F16, gguf.GGML_Q8_0, gguf.GGML_Q4_0):
            assert _same_bits(nat.tensor(name, np.float16), ref.tensor(name, np.float16)), name


def test_subnormal_halves_corrected(files):
    """native/gguf_reader.cpp halves subnormal F16 values (its f16_to_f32);
    the port's reader recomputes those elements and blocks, so it equals the
    numpy reader where the JAX package's native reader does not."""
    nat, ref = native.open_gguf(files["mixed"]), gguf.GGUFReader(files["mixed"])
    jax_nat = jnative.NativeGGUFReader(files["mixed"])
    for name in ("f16_subnormal", "q8_subnormal", "q4_subnormal"):
        want = ref.tensor(name)
        assert _same_bits(nat.tensor(name), want), name
        jax_got = jax_nat.tensor(name)
        off = jax_got != want
        assert off.any(), name
        np.testing.assert_array_equal(jax_got[off] * 2, want[off])
    # a block of normal scale beside the subnormal one is left as C computed it
    np.testing.assert_array_equal(nat.tensor("q8_subnormal")[0, 32:],
                                  jax_nat.tensor("q8_subnormal")[0, 32:])


def test_integer_tensor_is_int32(files):
    arrays = _mixed_file(files["mixed"] + ".again")
    got = native.open_gguf(files["mixed"] + ".again").tensor("i32")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, arrays["i32"][0])


def _assert_trees_bit_equal(a, b):
    fa, fb = a.flatten(), b.flatten()
    assert list(fa) == list(fb)
    for key in fa:
        assert fa[key].dtype == fb[key].dtype and torch.equal(fa[key], fb[key]), key


@pytest.mark.parametrize("which,q8_native", [("f32", False), ("q8", False), ("q8", True)])
def test_magpie_loader_bit_equal_through_both_readers(files, which, q8_native):
    path = files[which]
    c_nat, w_nat = load_magpie_weights(path, q8_native=q8_native)   # reader=None: native
    c_ref, w_ref = load_magpie_weights(path, reader=gguf.GGUFReader(path), q8_native=q8_native)
    assert c_nat == c_ref
    blocks_nat, blocks_ref = q8_blocks(w_nat), q8_blocks(w_ref)
    assert list(blocks_nat) == list(blocks_ref)
    assert bool(blocks_nat) == q8_native
    for key, blk in blocks_nat.items():
        assert torch.equal(blk.q, blocks_ref[key].q) and torch.equal(blk.s, blocks_ref[key].s)
    from magpie_tts_tpu_torch.io.magpie_weights import materialize_weights

    _assert_trees_bit_equal(materialize_weights(w_nat), materialize_weights(w_ref))


def test_q8_stream_bit_equal_through_both_readers(files):
    path = files["q8"]
    cfg = load_magpie_weights(path)[0]
    a = q8_stream_from_gguf(native.open_gguf(path), cfg)
    b = q8_stream_from_gguf(gguf.GGUFReader(path), cfg)
    for name in ("qkv", "sa_out", "ff_proj", "ff_out"):
        for part in ("q", "bs"):
            assert torch.equal(getattr(a, f"{name}_{part}"), getattr(b, f"{name}_{part}"))


def test_codec_loader_bit_equal_through_both_readers(files):
    path = files["codec"]
    c_nat, w_nat = load_codec_weights(path)
    c_ref, w_ref = load_codec_weights(path, reader=gguf.GGUFReader(path))
    assert c_nat == c_ref
    _assert_trees_bit_equal(w_nat, w_ref)


class _Recording(dict):
    """A metadata dict that records every key a loader looks up."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self.read.add(key)
        return super().get(key, default)

    def __contains__(self, key):
        self.read.add(key)
        return super().__contains__(key)


def _section_end(raw: bytes, pos: int, n_kv: int, n_tensors: int):
    """Byte offsets where the KV entries and then the tensor infos end."""
    for _ in range(n_kv):
        pos += 8 + struct.unpack_from("<Q", raw, pos)[0]
        vtype = struct.unpack_from("<i", raw, pos)[0]
        pos += 4
        if vtype == gguf.T_STRING:
            pos += 8 + struct.unpack_from("<Q", raw, pos)[0]
        else:
            pos += struct.calcsize(gguf._SCALAR_FMT[vtype])
    kv_end = pos
    for _ in range(n_tensors):
        pos += 8 + struct.unpack_from("<Q", raw, pos)[0]
        pos += 4 + 8 * struct.unpack_from("<I", raw, pos)[0] + 4 + 8
    return kv_end, pos


def _with_array_kv(src: str, dst: str, key: str, values) -> None:
    """Copy a GGUF with one more metadata entry, an int32 array (the writer
    takes scalars only): the entry goes after the last KV, the KV count grows
    by one, and the data section is re-aligned (tensor offsets are relative
    to it)."""
    raw = Path(src).read_bytes()
    ref = gguf.GGUFReader(src)
    n_kv = struct.unpack_from("<q", raw, 16)[0]
    kv_end, infos_end = _section_end(raw, 24, n_kv, len(ref.tensors))
    entry = (struct.pack("<Q", len(key)) + key.encode()
             + struct.pack("<iiQ", gguf.T_ARRAY, gguf.T_INT32, len(values))
             + struct.pack(f"<{len(values)}i", *values))
    header = raw[:16] + struct.pack("<q", n_kv + 1) + raw[24:kv_end] + entry
    header += raw[kv_end:infos_end]
    pad = (-len(header)) % gguf.ALIGNMENT
    Path(dst).write_bytes(header + b"\x00" * pad + raw[ref._data_start:])


def test_no_loader_reads_an_array_valued_key(files, tmp_path):
    """The C ABI does not surface array values. Every metadata key the
    port's loaders read (configs, tokenizer) is a scalar one, present in the
    native reader's metadata; an array-valued key is listed apart."""
    path = str(tmp_path / "with_array.gguf")
    _with_array_kv(files["f32"], path, "tokenizer.ggml.token_type", [1, 2, 3])
    nat, ref = native.open_gguf(path), gguf.GGUFReader(path)
    assert nat.array_keys == ["tokenizer.ggml.token_type"]
    assert ref.metadata["tokenizer.ggml.token_type"] == [1, 2, 3]
    assert "tokenizer.ggml.token_type" not in nat.metadata
    for which, readers in (("f32", (tconfig.MagpieConfig, MagpieTokenizer)),
                           ("codec", (tconfig.CodecConfig,))):
        src = path if which == "f32" else files[which]
        numpy_meta = _Recording(gguf.GGUFReader(src).metadata)   # arrays included
        native_meta = _Recording(native.open_gguf(src).metadata)
        for cls in readers:
            a, b = cls.from_gguf_metadata(native_meta), cls.from_gguf_metadata(numpy_meta)
            assert (a.encode("hello world, abc") == b.encode("hello world, abc")
                    if cls is MagpieTokenizer else a == b)
        assert numpy_meta.read == native_meta.read
        present = numpy_meta.read & set(numpy_meta)
        assert present and not any(isinstance(numpy_meta[k], list) for k in present)
        assert present <= set(native_meta)
    # The loaders load the file with the array key through the native reader.
    assert load_magpie_weights(path)[0] == load_magpie_weights(files["f32"])[0]


def test_missing_library_raises(files, monkeypatch, tmp_path):
    monkeypatch.setenv("MAGPIE_GGUF_LIB", str(tmp_path / "nowhere.so"))
    with pytest.raises(FileNotFoundError):
        native.open_gguf(files["f32"])
    with pytest.raises(FileNotFoundError):
        load_magpie_weights(files["f32"])


def test_library_without_raw_reader_raises(files, monkeypatch, tmp_path):
    """A library that lacks an entry point (an old build without
    gguf_tensor_read_raw) is refused, not worked around."""
    src = tmp_path / "old.cpp"
    src.write_text(native.SOURCE.read_text().replace("int gguf_tensor_read_raw(",
                                                     "static int unused_read_raw("))
    so = tmp_path / "libold.so"
    subprocess.run(["g++", *native.CXX_FLAGS, "-o", str(so), str(src)], check=True,
                   capture_output=True)
    monkeypatch.setenv("MAGPIE_GGUF_LIB", str(so))
    with pytest.raises(RuntimeError, match="gguf_tensor_read_raw"):
        native.open_gguf(files["f32"])


@pytest.mark.parametrize("corrupt", ["magic", "version", "truncated"])
def test_corrupt_file_raises(files, tmp_path, corrupt):
    data = bytearray(Path(files["f32"]).read_bytes())
    if corrupt == "magic":
        data[:4] = b"GGML"
    elif corrupt == "version":
        data[4:8] = struct.pack("<I", 2)
    else:
        data = data[:200]
    path = tmp_path / f"{corrupt}.gguf"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match={"magic": "not a GGUF", "version": "version 2",
                                          "truncated": "refused"}[corrupt]):
        native.open_gguf(str(path))
    with pytest.raises(ValueError):
        load_magpie_weights(str(path))


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError) as e:
        native.open_gguf(str(tmp_path / "absent.gguf"))
    assert e.value.filename == str(tmp_path / "absent.gguf")


def test_close_releases_once(files):
    reader = native.open_gguf(files["mixed"])
    reader.close()
    reader.close()   # a second close does nothing
    with pytest.raises(ValueError, match="closed"):
        reader.tensor("f32")
    with native.open_gguf(files["mixed"]) as r:
        assert r.tensor("i32").dtype == np.int32
    assert r._handle is None


def test_ragged_block_tensor_raises(tmp_path):
    path = str(tmp_path / "ragged.gguf")
    wr = gguf.GGUFWriter()
    wr.add_tensor("q", np.ones((3, 37), np.float32), gguf.GGML_Q8_0)
    wr.write(path)
    with pytest.raises(ValueError, match="whole"):
        native.open_gguf(path).tensor("q")


def test_library_builds_once_into_build_and_survives_a_race(tmp_path):
    """Four processes build the library from a clean build dir at once: each
    loads a complete library, all the same file, under build/magpie_gguf/."""
    code = ("import sys\n"
            "from magpie_tts_tpu_torch.io import native\n"
            "native.BUILD_DIR = __import__('pathlib').Path(sys.argv[1])\n"
            "lib = native.load_library()\n"
            "print(native.library_path())\n")
    build = tmp_path / "build"
    env = dict(os.environ)
    env.pop("MAGPIE_GGUF_LIB", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert sorted(f.name for f in build.iterdir()) == [Path(paths.pop()).name]
    assert native.library_path().parent == REPO / "build" / "magpie_gguf"
