"""Shared helpers of the PyTorch-port tests (the JAX package is the reference).

Inputs are made with numpy from a seed and handed to both packages; JAX runs
on the CPU (its Pallas kernels in interpret mode), the port on CPU tensors.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import torch

from magpie_tts_tpu_torch.io.codec_weights import codec_weights_from_numpy
from magpie_tts_tpu_torch.io.magpie_weights import magpie_weights_from_numpy

# Tiny shapes: one intra-op thread per pytest worker avoids oversubscription.
torch.set_num_threads(1)


def jax_params(tree) -> dict:
    """Flatten a JAX weight pytree to ``{field.path: np.ndarray}`` with the
    port's key spelling (tuple elements by index: ``stages.0.convt_w``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(p.name) if hasattr(p, "name") else str(p.idx) for p in path)
        out[key] = np.asarray(leaf)
    return out


def port_magpie_weights(jax_weights):
    return magpie_weights_from_numpy(jax_params(jax_weights))


def port_codec_weights(jax_weights):
    return codec_weights_from_numpy(jax_params(jax_weights))


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor (copied)."""
    return torch.tensor(np.array(x), dtype=dtype)


def jax_reference_without_excess_precision(target: str, **kwargs) -> dict:
    """Run ``target`` ("module:function", returning {name: np.ndarray}) with
    ``kwargs`` in a child process whose XLA keeps every rounding the JAX
    source writes, and return its arrays.

    XLA's ``--xla_allow_excess_precision`` (on by default) computes the
    bfloat16 values inside a fusion in float32 and drops the source's
    ``.astype(bfloat16)`` roundings, so jitted JAX (and every ``scan`` body or
    Pallas kernel in interpret mode) is not the JAX source in bfloat16. The
    flag is read once, when a process starts its backend: this test process
    has started its own, so the reference runs in a child with the flag off
    (``JAX_PLATFORMS=cpu``). ``target`` returns numpy arrays (bf16 values as
    float32, where they are exact)."""
    root = Path(__file__).resolve().parent.parent
    module, fn = target.split(":")
    code = ("import importlib, json, sys\n"
            "import numpy as np\n"
            f"fn = getattr(importlib.import_module({module!r}), {fn!r})\n"
            "np.savez(sys.argv[1], **fn(**json.loads(sys.argv[2])))\n")
    flags = (os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ref.npz")
        run = subprocess.run([sys.executable, "-c", code, out, json.dumps(kwargs)], cwd=root,
                             env=env, capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            raise RuntimeError(f"{target} failed in the reference process:\n{run.stderr[-4000:]}")
        with np.load(out) as z:
            return {k: z[k] for k in z.files}


def test_jax_params_round_trip_through_port_containers():
    """The flattening both directions rely on: every JAX leaf lands in the
    port container under the same path, unchanged."""
    from magpie_tts_tpu.io.magpie_weights import random_magpie_weights
    from tests.utils import tiny_magpie_config

    jw = random_magpie_weights(tiny_magpie_config(), seed=3)
    flat = jax_params(jw)
    back = port_magpie_weights(jw).flatten()
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key].numpy(), arr, err_msg=key)
