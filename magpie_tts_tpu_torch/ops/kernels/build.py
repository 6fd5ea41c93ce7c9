"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first use, under
``build/magpie_torch_kernels/`` of the checkout, named by a hash of the sources
and flags (an edited source builds anew; an unchanged one loads the cached
library). The library is bound with ``ctypes``: every entry point returns the
CUDA error code of its launches, which the wrappers turn into exceptions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "magpie_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's nvcc run
build_log: str = ""                    # nvcc/ptxas output of that run


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                           "the CUDA kernels are built from source at first use")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmagpie_kernels_{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    # Build into a temporary name, then rename: a concurrent process never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                          capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, target)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declares every entry
    point's argument and return types."""
    global _lib
    if _lib is None:
        target = library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        from . import codec_conv, frame_step

        frame_step.declare(lib)
        codec_conv.declare(lib)
        lib.magpie_cuda_error_string.argtypes = [ctypes.c_int]
        lib.magpie_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        name = _lib.magpie_cuda_error_string(err).decode() if _lib else "?"
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
