"""Golden-tensor ``.bin`` format (magpie_tts_tpu/io/golden.py), byte for byte.

The layout the reference's dumpers write and its C++ tests read: the shape is
padded to 4 dims, the header is those 4 dims as int64 written REVERSED, and
the payload is float32 in the tensor's row-major order (GGML's ne-innermost-
first layout once the dims are reversed). Token and code dumps are stored as
float32 too.

``read_golden`` drops trailing 1-dims (they are indistinguishable from the
padding), so a real trailing dim of 1 is lost: a ``[T, 1]`` dump reads back as
``[T]``. The JAX package's reader does the same; the comparisons
(``tools.verify_golden``) read both sides through it.
"""

from __future__ import annotations

import numpy as np


def write_golden(path: str, array: np.ndarray) -> None:
    array = np.ascontiguousarray(np.asarray(array, dtype=np.float32))
    if array.ndim > 4:
        raise ValueError("golden format supports at most 4 dims")
    padded = list(array.shape) + [1] * (4 - array.ndim)
    with open(path, "wb") as f:
        np.asarray(list(reversed(padded)), np.int64).tofile(f)
        array.tofile(f)


def read_golden(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        dims = np.fromfile(f, dtype=np.int64, count=4)
        data = np.fromfile(f, dtype=np.float32)
    shape = [int(d) for d in reversed(dims)]   # back to numpy order
    while len(shape) > 1 and shape[-1] == 1:   # drop the padding dims
        shape.pop()
    n = int(np.prod(shape))
    return np.reshape(data[:n], shape)
