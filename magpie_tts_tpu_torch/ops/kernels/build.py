"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for Hopper (``sm_90a``),
all started together, and linked into one shared library with a plain C
interface, at first use, under
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
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "magpie_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The compute dtypes every kernel takes, with their entry points' suffixes
# (magpie_frame_step_f32 / magpie_frame_step_bf16, ...).
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()  # engines on several cards load from a thread pool
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = str(Path(tmp) / f"{src.stem}.o")
            objs.append(obj)
            procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        logs = [p.communicate()[0] for p in procs]
        # Link into a temporary name, then rename: a concurrent process never
        # loads a half-written library.
        so = str(Path(tmp) / target.name)
        link = None
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run([nvcc, "-shared", "-o", so, *objs], capture_output=True,
                                  text=True)
            logs.append(link.stdout + link.stderr)
        build_seconds = time.perf_counter() - t0
        build_log = "".join(logs)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(so, target)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declares every entry
    point's argument and return types."""
    global _lib
    with _lib_lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            from . import (batched_gemm, codec_conv, codec_res_fused, decode_attention,
                           decoder_step, decoder_step_batched, frame_step, frame_step_batched,
                           lt_sampler, lt_sampler_batched, probe_attend, probe_copy, probe_gemv,
                           q8_dequant)

            for module in (frame_step, frame_step_batched, codec_conv, codec_res_fused,
                           lt_sampler, decoder_step, lt_sampler_batched, decoder_step_batched,
                           q8_dequant, probe_gemv, probe_attend, probe_copy, decode_attention,
                           batched_gemm):
                module.declare(lib)
            lib.magpie_cuda_error_string.argtypes = [ctypes.c_int]
            lib.magpie_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def count_dtype(counts: dict, dtype: torch.dtype) -> None:
    """Add one launch to a wrapper's ``dtype_launches`` under ``dtype``."""
    counts[str(dtype).replace("torch.", "")] += 1


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        name = _lib.magpie_cuda_error_string(err).decode() if _lib else "?"
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
