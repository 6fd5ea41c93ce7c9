"""PyTorch port on the card: the lockstep program launched from several host
threads onto one card (a mesh that repeats a device), at small shapes.

Every test needs a CUDA device and skips without one; this file imports
neither jax nor the JAX package:
    MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_mesh_cuda.py -q -m cuda
Tolerance: none. Each thread's program has the shapes of a sequential run,
so codes and frame counts must be bit-equal to it.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu_torch.ops import sampling
from magpie_tts_tpu_torch.parallel import mesh as mesh_mod
from magpie_tts_tpu_torch.parallel.serving import BatchedMagpieEngine
from magpie_tts_tpu_torch.runtime import engine as engine_mod
from magpie_tts_tpu_torch.scripts import parity_batched
from tests.test_torch_cuda import SMALL

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return engine_mod.resolve_device("cuda")


@pytest.mark.parametrize("fused", [True, False])
def test_threads_on_one_card_equal_a_sequential_run(cuda, fused):
    """Four threads run the lockstep program on one card at once, each on its
    own inputs; each result is bit-equal to the same program run alone."""
    config = dataclasses.replace(SMALL, max_dec_steps=24, min_generated_frames=24)
    w = random_magpie_weights(config, seed=3).to(device=cuda)
    inputs = [parity_batched.make_inputs(config, 4, seed) for seed in range(4)]
    run = lambda x: parity_batched.run_program(x, w, w, config, 0.7, fused)
    alone = [run(x) for x in inputs]
    with ThreadPoolExecutor(max_workers=4) as pool:
        together = list(pool.map(run, inputs))
    for (c0, n0), (c1, n1) in zip(alone, together):
        np.testing.assert_array_equal(n1, n0)
        np.testing.assert_array_equal(c1, c0)


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_mesh_of_a_repeated_card_equals_its_slices_alone(cuda, temp):
    """BatchedMagpieEngine over ["cuda:0", "cuda:0"] at B = 4 gives the codes
    of each half run by an unmeshed B = 2 engine (the same shapes)."""
    config = dataclasses.replace(SMALL, max_dec_steps=24)
    w = random_magpie_weights(config, seed=4)
    rng = np.random.default_rng(1)
    reqs = [[config.text_bos_id] + [int(v) for v in rng.integers(2, 30, size=n)]
            + [config.text_eos_id] for n in (5, 9, 3, 12)]
    mesh = mesh_mod.make_mesh(devices=["cuda:0", "cuda:0"])
    got = BatchedMagpieEngine(w, config, 4, mesh=mesh, token_buckets=(16,)).synthesize_batch(
        reqs, temperature=temp, seed=2)
    half = BatchedMagpieEngine(w, config, 2, device=cuda, token_buckets=(16,))
    # the mesh keys row i with fold_in(PRNGKey(2), i): run each half with its own keys
    base = sampling.prng_key(2)
    for h in range(2):
        keys = [sampling.fold_in(base, i) for i in (2 * h, 2 * h + 1)]
        want = half._dispatch_wave(reqs[2 * h: 2 * h + 2], [0, 0], keys, temp, 80)
        for i, wnt in enumerate(want):
            np.testing.assert_array_equal(got[2 * h + i], wnt)
