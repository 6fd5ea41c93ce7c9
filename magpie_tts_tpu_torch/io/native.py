"""The native GGUF reader: a ctypes binding of ``native/gguf_reader.cpp``.

``NativeGGUFReader`` has the surface of the numpy ``io.gguf.GGUFReader``
(``metadata``, ``tensors`` of ``TensorInfo``, ``tensor(name, dequant_dtype)``,
``raw(name)``) over the C ABI of the C++ reader (mmap parse, Q8_0 / Q4_0 /
F16 dequantized by threads). ``open_gguf`` returns one; every loader of the
port opens its checkpoint through it.

Build: at first use (never at import), ``g++ -O3 -std=c++17 -fPIC -shared
-pthread`` compiles ``native/gguf_reader.cpp`` into ``build/magpie_gguf/`` of
the checkout, named by a hash of the source and the flags, so an edited
source builds anew and an unchanged one loads the cached library. Each
process builds at most once; the library is written under a temporary name
and renamed, so processes that race never load a half-written file.
``MAGPIE_GGUF_LIB`` may name a prebuilt library instead; it must export every
entry point bound here (``gguf_tensor_read_raw`` included), or loading raises.

There is no fallback: a compiler that fails, a library that is missing or
incomplete, or a file the C++ parser refuses raises, with the compiler's
output or the parse error. ``io.gguf.GGUFReader`` stays for callers that name
it (the writer's round trips, tests comparing the two readers).

What the C ABI surfaces, and so what this reader returns:
- metadata values typed by ``gguf_kv_type``: the integer types as ``int``,
  FLOAT32 / FLOAT64 as ``float``, BOOL as ``bool``, STRING as ``str`` (read
  up to its first NUL byte). The C side holds numbers as doubles, so a 64-bit
  integer beyond 2**53 loses its low bits.
- ARRAY values are parsed but not surfaced (native/gguf_reader.cpp:148-155):
  their keys are absent from ``metadata`` and listed in ``array_keys``. No
  loader of the port reads an array-valued key.
- ``TensorInfo.offset`` is None: the ABI has no accessor for it.
- tensors of at most 4 dims (the parser refuses more).

One correction: the C++ ``f16_to_f32`` takes a subnormal half (exponent bits
0, mantissa not 0) to half its value (its exponent is one too small), so an
F16 element or a Q8_0 / Q4_0 block scale below 2**-14 would dequantize
wrong. ``tensor()`` recomputes exactly those elements or blocks from the
stored bytes, with the numpy reader's arithmetic, so every tensor is bit-equal
to ``GGUFReader.tensor``. The JAX package's reader does not: it returns the
halved values.
"""

from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from . import gguf as pygguf
from . import quant

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "gguf_reader.cpp"
BUILD_DIR = ROOT / "build" / "magpie_gguf"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_T_BOOL = pygguf.T_BOOL
_T_STRING = pygguf.T_STRING
_T_ARRAY = pygguf.T_ARRAY
_FLOAT_TYPES = (pygguf.T_FLOAT32, pygguf.T_FLOAT64)
# Block types: (bytes a block, the numpy dequant of a payload).
_BLOCKS = {pygguf.GGML_Q8_0: (2 + pygguf.QK, quant.dequantize_q8_0),
           pygguf.GGML_Q4_0: (2 + pygguf.QK // 2, quant.dequantize_q4_0)}

_c = ctypes
_P = _c.c_void_p
# name -> (restype, argtypes): every entry point this reader binds.
_ABI = {
    "gguf_open": (_P, [_c.c_char_p]),
    "gguf_close": (None, [_P]),
    "gguf_n_tensors": (_c.c_int64, [_P]),
    "gguf_tensor_name": (_c.c_char_p, [_P, _c.c_int64]),
    "gguf_tensor_ndims": (_c.c_int32, [_P, _c.c_int64]),
    "gguf_tensor_dims": (None, [_P, _c.c_int64, _c.POINTER(_c.c_int64)]),
    "gguf_tensor_type": (_c.c_int32, [_P, _c.c_int64]),
    "gguf_tensor_nelements": (_c.c_int64, [_P, _c.c_int64]),
    "gguf_n_kv": (_c.c_int64, [_P]),
    "gguf_kv_key": (_c.c_char_p, [_P, _c.c_int64]),
    "gguf_kv_type": (_c.c_int32, [_P, _c.c_int64]),
    "gguf_kv_num": (_c.c_double, [_P, _c.c_int64]),
    "gguf_kv_str": (_c.c_char_p, [_P, _c.c_int64]),
    "gguf_tensor_read_f32": (_c.c_int, [_P, _c.c_int64, _c.POINTER(_c.c_float)]),
    "gguf_tensor_nbytes": (_c.c_int64, [_P, _c.c_int64]),
    "gguf_tensor_read_raw": (_c.c_int, [_P, _c.c_int64, _c.POINTER(_c.c_uint8)]),
}

_libs: Dict[str, ctypes.CDLL] = {}   # loaded libraries by path
_lock = threading.Lock()
build_seconds: Optional[float] = None  # wall time of this process's g++ run, if any


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native GGUF reader is built from "
                           f"{SOURCE} at first use")
    return found


def library_path() -> Path:
    """The library ``open_gguf`` loads: ``MAGPIE_GGUF_LIB`` if set, else the
    build of the current source under ``build/magpie_gguf/``."""
    override = os.environ.get("MAGPIE_GGUF_LIB")
    if override:
        return Path(override)
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmagpie_gguf_{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = Path(tmp) / target.name
        t0 = time.perf_counter()
        run = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(so), str(SOURCE)],
                             capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if run.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native GGUF reader:\n"
                               f"{run.stdout}{run.stderr}")
        os.replace(so, target)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the reader library, with every entry point
    of ``_ABI`` declared. Raises when the library is missing, fails to build
    or lacks an entry point."""
    with _lock:
        path = library_path()
        key = str(path)
        if key in _libs:
            return _libs[key]
        if not path.exists():
            if os.environ.get("MAGPIE_GGUF_LIB"):
                raise FileNotFoundError(errno.ENOENT, "MAGPIE_GGUF_LIB names no file", key)
            _build(path)
        lib = ctypes.CDLL(key)
        missing = [name for name in _ABI if not hasattr(lib, name)]
        if missing:
            raise RuntimeError(f"{path} lacks {', '.join(missing)}: rebuild it from {SOURCE} "
                               "(or unset MAGPIE_GGUF_LIB to build it at first use)")
        for name, (restype, argtypes) in _ABI.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[key] = lib
        return lib


def _subnormal_f16(bits: np.ndarray) -> np.ndarray:
    """Which half-precision bit patterns are subnormal (see the module doc)."""
    return ((bits & 0x7C00) == 0) & ((bits & 0x03FF) != 0)


def _parse_error(path: str) -> str:
    """Why the C++ parser refused ``path``, as far as its first bytes say."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:4] != pygguf.GGUF_MAGIC:
        return f"{path}: not a GGUF file"
    version = int.from_bytes(head[4:8], "little") if len(head) == 8 else None
    if version != pygguf.GGUF_VERSION:
        return f"{path}: unsupported GGUF version {version}"
    return (f"{path}: the native GGUF parser refused the header (truncated, a metadata "
            "value of unknown type, or a tensor of more than 4 dims)")


class NativeGGUFReader:
    """A GGUF file parsed by the C++ reader; tensors are copied out of its
    mmap on request. ``close()`` (or the context manager, or garbage
    collection) releases the handle once."""

    def __init__(self, path: str):
        path = os.fspath(path)
        if not os.path.isfile(path):
            raise FileNotFoundError(errno.ENOENT, "no such GGUF file", path)
        self._lib = load_library()
        self._handle = self._lib.gguf_open(path.encode())
        if not self._handle:
            raise ValueError(_parse_error(path))
        self.path = path
        self.metadata: Dict[str, object] = {}
        self.array_keys: List[str] = []
        self.tensors: Dict[str, pygguf.TensorInfo] = {}
        self._index: Dict[str, int] = {}
        lib, h = self._lib, self._handle
        for i in range(lib.gguf_n_kv(h)):
            key = lib.gguf_kv_key(h, i).decode("utf-8")
            vtype = lib.gguf_kv_type(h, i)
            if vtype == _T_ARRAY:
                self.array_keys.append(key)
            elif vtype == _T_STRING:
                self.metadata[key] = lib.gguf_kv_str(h, i).decode("utf-8")
            else:
                num = lib.gguf_kv_num(h, i)
                self.metadata[key] = (float(num) if vtype in _FLOAT_TYPES else
                                      bool(num) if vtype == _T_BOOL else int(num))
        dims = (ctypes.c_int64 * 4)()
        for i in range(lib.gguf_n_tensors(h)):
            name = lib.gguf_tensor_name(h, i).decode("utf-8")
            lib.gguf_tensor_dims(h, i, dims)
            shape = tuple(int(dims[d]) for d in range(lib.gguf_tensor_ndims(h, i)))
            self.tensors[name] = pygguf.TensorInfo(name, shape, lib.gguf_tensor_type(h, i),
                                                   None)
            self._index[name] = i

    def _idx(self, name: str) -> int:
        if not self._handle:
            raise ValueError(f"{self.path}: reader is closed")
        return self._index[name]

    def tensor(self, name: str, dequant_dtype=np.float32) -> np.ndarray:
        """The tensor in its stored (PyTorch) shape, as ``GGUFReader.tensor``
        returns it: F32 as float32, I32 as int32, F16 / Q8_0 / Q4_0
        dequantized (in float32, then cast to ``dequant_dtype``)."""
        idx = self._idx(name)
        info = self.tensors[name]
        if info.ggml_type in _BLOCKS and info.n_elements % pygguf.QK:
            raise ValueError(f"{name}: {info.n_elements} elements are not whole "
                             f"{pygguf.QK}-element blocks")
        out = np.empty(info.n_elements, dtype=np.float32)
        rc = self._lib.gguf_tensor_read_f32(self._handle, idx,
                                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise ValueError(f"{name}: native read failed (rc={rc}, type {info.ggml_type})")
        if info.ggml_type == pygguf.GGML_I32:
            out = out.view(np.int32)
        elif info.ggml_type != pygguf.GGML_F32:
            self._correct_subnormals(name, info.ggml_type, out)
            out = out.astype(dequant_dtype, copy=False)
        return out.reshape(info.shape)

    def _correct_subnormals(self, name: str, ggml_type: int, out: np.ndarray) -> None:
        """Recompute, in place, the elements (F16) or blocks (Q8_0 / Q4_0)
        whose stored half is subnormal, as ``GGUFReader.tensor`` does."""
        raw = self.raw(name)
        if ggml_type == pygguf.GGML_F16:
            halves = raw.view(np.uint16)
            bad = _subnormal_f16(halves)
            if bad.any():
                out[bad] = halves[bad].view(np.float16).astype(np.float32)
            return
        block_bytes, dequantize = _BLOCKS[ggml_type]
        blocks = raw.reshape(-1, block_bytes)
        bad = _subnormal_f16(blocks[:, :2].copy().view(np.uint16)[:, 0])
        if bad.any():
            fixed = dequantize(blocks[bad].reshape(-1), int(bad.sum()) * pygguf.QK)
            out.reshape(-1, pygguf.QK)[bad] = fixed.reshape(-1, pygguf.QK)

    def raw(self, name: str) -> np.ndarray:
        """The tensor's stored bytes, undecoded (Q8_0 blocks stay blocks), as
        ``GGUFReader.raw`` returns them."""
        idx = self._idx(name)
        nbytes = self._lib.gguf_tensor_nbytes(self._handle, idx)
        if nbytes < 0:
            raise ValueError(f"{name}: unsupported ggml type {self.tensors[name].ggml_type}")
        out = np.empty(nbytes, dtype=np.uint8)
        rc = self._lib.gguf_tensor_read_raw(self._handle, idx,
                                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise ValueError(f"{name}: native raw read failed (rc={rc})")
        return out

    def close(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.gguf_close(handle)

    def __enter__(self) -> "NativeGGUFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


Reader = Union[pygguf.GGUFReader, NativeGGUFReader]  # what the loaders take


def open_gguf(path: str) -> NativeGGUFReader:
    """The checkpoint at ``path`` through the native reader (built at first
    use). Raises rather than falling back to the numpy reader."""
    return NativeGGUFReader(path)
