"""PyTorch port, the data-parallel device list (``parallel.mesh``) and the
lockstep engine's ``mesh`` argument, on the CPU.

``BatchedMagpieEngine`` with a mesh of ``["cpu"] * n`` (n = 2, 4: each entry
runs the lockstep program on its slice of the batch from its own thread)
must give codes and lengths equal to the port's engine without a mesh, and
to the JAX ``BatchedMagpieEngine`` with ``make_mesh(n_data=n)`` over the
virtual CPU devices of tests/conftest.py (``shard_map`` over the data axis;
when fewer than n JAX devices exist, the JAX engine without a mesh, which
tests/test_parallel.py holds equal to the sharded one), at temp 0 and 0.7.
Tolerance: none (exact codes)."""

import jax
import numpy as np
import pytest
import torch

from magpie_tts_tpu.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu.parallel import mesh as jax_mesh
from magpie_tts_tpu.parallel.serving import BatchedMagpieEngine as JaxBatchedEngine
from magpie_tts_tpu_torch.parallel import mesh as mesh_mod
from magpie_tts_tpu_torch.parallel.serving import BatchedMagpieEngine
from tests import test_torch_support  # noqa: F401  (one intra-op thread per worker)
from tests.test_torch_support import port_magpie_weights
from tests.utils import tiny_magpie_config

CONFIG = tiny_magpie_config()
BATCH, BUCKETS = 8, (8, 16)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def weights():
    jw = random_magpie_weights(CONFIG, seed=11)
    return jw, port_magpie_weights(jw)


@pytest.fixture(scope="module")
def requests():
    rng = np.random.default_rng(0)
    return [[CONFIG.text_bos_id] + [int(v) for v in rng.integers(2, 30, size=n)]
            + [CONFIG.text_eos_id] for n in (4, 9, 6, 3, 11, 5, 7, 2)]


@pytest.fixture(scope="module")
def unmeshed(weights, requests):
    """The port's engine without a mesh, codes by temperature."""
    eng = BatchedMagpieEngine(weights[1], CONFIG, batch_size=BATCH, device="cpu",
                              token_buckets=BUCKETS)
    return {t: eng.synthesize_batch(requests, temperature=t, seed=3) for t in (0.0, 0.7)}


def test_make_mesh_refuses_tensor_parallelism():
    with pytest.raises(ValueError, match="retired"):
        mesh_mod.make_mesh(n_data=2, n_model=2, devices=["cpu"] * 2)


def test_make_mesh_refuses_too_few_devices():
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        mesh_mod.make_mesh(n_data=3, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(n_data=0, devices=["cpu"])


def test_make_mesh_lists_devices_in_order():
    mesh = mesh_mod.make_mesh(n_data=3, devices=["cpu"] * 4)
    assert mesh == [CPU] * 3
    assert mesh_mod.make_mesh(devices=("cpu", "cpu")) == [CPU, CPU]


def test_make_mesh_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_mesh()
    with pytest.raises(RuntimeError):
        mesh_mod.make_mesh(devices=["cuda:0"])


def test_same_device_names_one_device():
    assert mesh_mod.same_device("cpu", CPU) and not mesh_mod.same_device("cpu", "cuda:0")
    assert mesh_mod.same_device("cuda:1", torch.device("cuda", 1))
    assert not mesh_mod.same_device("cuda:0", "cuda:1")


def test_batch_sharding_cuts_contiguous_equal_slices():
    assert mesh_mod.batch_sharding([CPU] * 4, 8) == [slice(0, 2), slice(2, 4), slice(4, 6),
                                                     slice(6, 8)]
    assert mesh_mod.batch_sharding([CPU] * 2, 4) == [slice(0, 2), slice(2, 4)]
    with pytest.raises(ValueError, match="does not divide"):
        mesh_mod.batch_sharding([CPU] * 4, 6)


def test_shard_weights_replicates_and_shares_a_device(weights):
    _, pw = weights
    copies = mesh_mod.shard_weights(pw, [CPU] * 3, CONFIG)
    assert len(copies) == 3 and copies[0] is copies[1] is copies[2]
    np.testing.assert_array_equal(copies[0].decoder.ff_proj.numpy(), pw.decoder.ff_proj.numpy())
    assert mesh_mod.replicated([CPU, CPU])(torch.ones(2))[1].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_meshed_engine_equals_unmeshed_and_jax(weights, requests, unmeshed, n, temp):
    jw, pw = weights
    eng = BatchedMagpieEngine(pw, CONFIG, batch_size=BATCH,
                              mesh=mesh_mod.make_mesh(devices=["cpu"] * n),
                              token_buckets=BUCKETS)
    got = eng.synthesize_batch(requests, temperature=temp, seed=3)
    for i, (g, w) in enumerate(zip(got, unmeshed[temp])):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i} vs the unmeshed engine")
    jmesh = (jax_mesh.make_mesh(n_data=n, devices=jax.devices()[:n])
             if len(jax.devices()) >= n else None)
    want = _jax_engine(jw, jmesh, n).synthesize_batch(requests, temperature=temp, seed=3)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i} vs the JAX engine")


_JAX_ENGINES = {}


def _jax_engine(jw, jmesh, n):
    """One JAX engine a mesh size (its program compiles once; temp is traced)."""
    if n not in _JAX_ENGINES:
        _JAX_ENGINES[n] = JaxBatchedEngine(jw, CONFIG, batch_size=BATCH, mesh=jmesh,
                                           token_buckets=BUCKETS)
    return _JAX_ENGINES[n]


def test_meshed_engine_chunked_waves(weights, unmeshed):
    """An over-long request's chunks join the lockstep rows as extra slots on
    the mesh too; the joined codes equal the unmeshed engine's."""
    _, pw = weights
    rng = np.random.default_rng(4)
    long = [CONFIG.text_bos_id] + [int(v) for v in rng.integers(2, 30, size=40)] + \
        [CONFIG.text_eos_id]
    for i in range(5, 40, 6):
        long[i] = 93
    reqs = [long, [CONFIG.text_bos_id, 3, 4, CONFIG.text_eos_id]]
    want = BatchedMagpieEngine(pw, CONFIG, batch_size=4, device="cpu",
                               token_buckets=BUCKETS).synthesize_batch(reqs, seed=9)
    got = BatchedMagpieEngine(pw, CONFIG, batch_size=4, mesh=["cpu", "cpu"],
                              token_buckets=BUCKETS).synthesize_batch(reqs, seed=9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_engine_refuses_a_disagreeing_device_or_ragged_batch(weights):
    _, pw = weights
    with pytest.raises(ValueError, match="not the mesh's devices"):
        BatchedMagpieEngine(pw, CONFIG, batch_size=BATCH, mesh=["cpu", "cpu"], device="cuda")
    with pytest.raises(ValueError, match="does not divide"):
        BatchedMagpieEngine(pw, CONFIG, batch_size=BATCH, mesh=["cpu"] * 3)
    eng = BatchedMagpieEngine(pw, CONFIG, batch_size=2, mesh=["cpu", "cpu"], device="cpu")
    assert eng.mesh == [CPU, CPU] and eng.device == CPU


@pytest.mark.parametrize("kernel", ["frame_step", "frame_step_batched"])
def test_launch_holds_its_workspace_until_enqueued(monkeypatch, kernel):
    """A mesh that repeats a card launches from two host threads onto one
    stream. A workspace freed before its kernels are enqueued can be handed
    at once to the other thread's launch, and the two then share it (codes of
    all-BOS rows on the card). With the checks and the library stubbed, the
    entry point must be called while every workspace buffer is still alive."""
    import contextlib
    import weakref

    from magpie_tts_tpu_torch.ops.kernels import batched_gemm, build
    from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
    from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb

    mod = fs if kernel == "frame_step" else fsb
    refs, seen = [], []
    make = mod._workspace

    def workspace(*args, **kw):
        ws = make(*args, **kw)
        refs.extend(weakref.ref(t) for t in ws.values())
        return ws

    class Lib:
        def __getattr__(self, entry):
            def call(args, stream):
                seen.append(all(r() is not None for r in refs))
                return 0
            return call

    monkeypatch.setattr(mod, "_workspace", workspace)
    monkeypatch.setattr(mod, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(mod, "stream_tensors", lambda *a, **k: {})
    monkeypatch.setattr(batched_gemm, "check_widths", lambda *a, **k: None)
    monkeypatch.setattr(build, "load_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    hidden = torch.zeros(2, CONFIG.d_model)
    if kernel == "frame_step":
        fs.launch("magpie_frame_step_f32", {"hidden": (hidden[0], (CONFIG.d_model,))}, {},
                  CONFIG, CPU, pos=CONFIG.context_frames + 1, enc_len=4)
    else:
        fsb.launch("magpie_frame_step_batched_f32", 2,
                   {"hidden": (hidden, (2, CONFIG.d_model), torch.float32, False)}, {}, CONFIG,
                   CPU, rows=CONFIG.context_frames + 2, enc_rows=4)
    assert refs and seen == [True]
