"""Shared helpers of the PyTorch-port tests (the JAX package is the reference).

Inputs are made with numpy from a seed and handed to both packages; JAX runs
on the CPU (its Pallas kernels in interpret mode), the port on CPU tensors.
"""

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
