"""Pure-numpy GGUF v3 reader + writer.

Format per the reference converter (scripts/convert_magpie_to_gguf.py:380-425):
little-endian, header = magic 'GGUF' + u32 version + i64 n_tensors + i64 n_kv,
then KV pairs, then tensor infos (name, n_dims, dims (reversed, i.e. GGUF stores
the innermost/fastest dim first), type, offset), then 32-byte-aligned data section.

The PyTorch port reads every checkpoint through this reader (the JAX package's
C++ fast path, native/gguf_reader.cpp, is not ported); the writer builds the
synthetic checkpoints of the tests and of chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
ALIGNMENT = 32

# GGUF metadata value types
T_UINT8, T_INT8, T_UINT16, T_INT16, T_UINT32, T_INT32, T_FLOAT32, T_BOOL = range(8)
T_STRING = 8
T_ARRAY = 9
T_UINT64, T_INT64, T_FLOAT64 = 10, 11, 12

# ggml tensor dtypes we support
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q8_0 = 8
GGML_I32 = 26

_SCALAR_FMT = {
    T_UINT8: "<B", T_INT8: "<b", T_UINT16: "<H", T_INT16: "<h",
    T_UINT32: "<I", T_INT32: "<i", T_FLOAT32: "<f", T_BOOL: "<?",
    T_UINT64: "<Q", T_INT64: "<q", T_FLOAT64: "<d",
}

QK = 32  # block size for Q8_0 / Q4_0


def _type_nbytes(ggml_type: int, n_elements: int) -> int:
    if ggml_type == GGML_F32 or ggml_type == GGML_I32:
        return 4 * n_elements
    if ggml_type == GGML_F16:
        return 2 * n_elements
    if ggml_type == GGML_Q8_0:
        return (n_elements // QK) * (2 + QK)
    if ggml_type == GGML_Q4_0:
        return (n_elements // QK) * (2 + QK // 2)
    raise ValueError(f"unsupported ggml type {ggml_type}")


@dataclasses.dataclass
class TensorInfo:
    name: str
    shape: Tuple[int, ...]  # numpy/PyTorch order (outermost first)
    ggml_type: int
    offset: int  # relative to data section start

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return _type_nbytes(self.ggml_type, self.n_elements)


class GGUFReader:
    """Parses a GGUF file; tensor payloads are served lazily from an mmap."""

    def __init__(self, path: str):
        self.path = path
        self.metadata: Dict[str, object] = {}
        self.tensors: Dict[str, TensorInfo] = {}
        self._mmap = np.memmap(path, dtype=np.uint8, mode="r")
        self._parse()

    def _parse(self) -> None:
        buf = self._mmap
        pos = 0

        def read(fmt: str):
            nonlocal pos
            size = struct.calcsize(fmt)
            out = struct.unpack_from(fmt, buf, pos)
            pos += size
            return out if len(out) > 1 else out[0]

        def read_str() -> str:
            nonlocal pos
            n = read("<Q")
            s = bytes(buf[pos:pos + n]).decode("utf-8")
            pos += n
            return s

        def read_value(vtype: int):
            if vtype in _SCALAR_FMT:
                return read(_SCALAR_FMT[vtype])
            if vtype == T_STRING:
                return read_str()
            if vtype == T_ARRAY:
                elem_type = read("<i")
                count = read("<Q")
                return [read_value(elem_type) for _ in range(count)]
            raise ValueError(f"unsupported GGUF value type {vtype}")

        magic = bytes(buf[0:4])
        pos = 4
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        version = read("<I")
        if version != GGUF_VERSION:
            raise ValueError(f"{self.path}: unsupported GGUF version {version}")
        n_tensors = read("<q")
        n_kv = read("<q")

        for _ in range(n_kv):
            key = read_str()
            vtype = read("<i")
            self.metadata[key] = read_value(vtype)

        infos: List[TensorInfo] = []
        for _ in range(n_tensors):
            name = read_str()
            n_dims = read("<I")
            dims = [read("<q") for _ in range(n_dims)]
            ggml_type = read("<i")
            offset = read("<Q")
            # GGUF stores dims innermost-first; numpy order is the reverse.
            infos.append(TensorInfo(name, tuple(reversed(dims)), ggml_type, offset))

        self._data_start = (pos + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT
        for info in infos:
            self.tensors[info.name] = info

    def raw(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        start = self._data_start + info.offset
        return np.asarray(self._mmap[start:start + info.nbytes])

    def tensor(self, name: str, dequant_dtype=np.float32) -> np.ndarray:
        """Return the tensor as a numpy array in its stored (PyTorch) shape.

        Quantized tensors are dequantized to ``dequant_dtype``.
        """
        from . import quant

        info = self.tensors[name]
        payload = self.raw(name)
        if info.ggml_type == GGML_F32:
            arr = payload.view(np.float32)
        elif info.ggml_type == GGML_F16:
            arr = payload.view(np.float16).astype(dequant_dtype)
        elif info.ggml_type == GGML_I32:
            arr = payload.view(np.int32)
        elif info.ggml_type == GGML_Q8_0:
            arr = quant.dequantize_q8_0(payload, info.n_elements).astype(dequant_dtype, copy=False)
        elif info.ggml_type == GGML_Q4_0:
            arr = quant.dequantize_q4_0(payload, info.n_elements).astype(dequant_dtype, copy=False)
        else:
            raise ValueError(f"{name}: unsupported ggml type {info.ggml_type}")
        return arr[: info.n_elements].reshape(info.shape)


class GGUFWriter:
    """Writes GGUF v3 files byte-compatible with the reference converter."""

    def __init__(self):
        self._kv: List[Tuple[str, int, object]] = []
        self._tensors: List[Tuple[str, Tuple[int, ...], int, bytes]] = []

    def add_metadata(self, key: str, value: Union[int, float, str, bool]) -> None:
        if isinstance(value, bool):
            self._kv.append((key, T_BOOL, value))
        elif isinstance(value, int):
            if value < 0:
                self._kv.append((key, T_INT32, value))
            else:
                self._kv.append((key, T_UINT32, value))
        elif isinstance(value, float):
            self._kv.append((key, T_FLOAT32, value))
        elif isinstance(value, str):
            self._kv.append((key, T_STRING, value))
        else:
            raise TypeError(f"unsupported metadata type for {key}: {type(value)}")

    def add_tensor(self, name: str, array: np.ndarray, ggml_type: Optional[int] = None) -> None:
        """Add a tensor, stored in its numpy shape. Optionally quantize."""
        from . import quant

        array = np.ascontiguousarray(array)
        if ggml_type is None:
            ggml_type = GGML_I32 if array.dtype == np.int32 else GGML_F32
        if ggml_type == GGML_F32:
            data = array.astype(np.float32).tobytes()
        elif ggml_type == GGML_F16:
            data = array.astype(np.float16).tobytes()
        elif ggml_type == GGML_I32:
            data = array.astype(np.int32).tobytes()
        elif ggml_type == GGML_Q8_0:
            data = quant.quantize_q8_0(array)
        elif ggml_type == GGML_Q4_0:
            data = quant.quantize_q4_0(array)
        else:
            raise ValueError(f"unsupported ggml type {ggml_type}")
        self._tensors.append((name, tuple(array.shape), ggml_type, data))

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(GGUF_MAGIC)
            f.write(struct.pack("<I", GGUF_VERSION))
            f.write(struct.pack("<q", len(self._tensors)))
            f.write(struct.pack("<q", len(self._kv)))

            def wstr(s: str):
                b = s.encode("utf-8")
                f.write(struct.pack("<Q", len(b)))
                f.write(b)

            for key, vtype, value in self._kv:
                wstr(key)
                f.write(struct.pack("<i", vtype))
                if vtype == T_STRING:
                    wstr(value)
                else:
                    f.write(struct.pack(_SCALAR_FMT[vtype], value))

            offset = 0
            offsets = []
            for _, _, _, data in self._tensors:
                aligned = (offset + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT
                offsets.append(aligned)
                offset = aligned + len(data)

            for (name, shape, ggml_type, _), off in zip(self._tensors, offsets):
                wstr(name)
                f.write(struct.pack("<I", len(shape)))
                for dim in reversed(shape):
                    f.write(struct.pack("<q", dim))
                f.write(struct.pack("<i", ggml_type))
                f.write(struct.pack("<Q", off))

            pad = (-f.tell()) % ALIGNMENT
            f.write(b"\x00" * pad)
            data_start = f.tell()
            for (_, _, _, data), off in zip(self._tensors, offsets):
                target = data_start + off
                f.write(b"\x00" * (target - f.tell()))
                f.write(data)
