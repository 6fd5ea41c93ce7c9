"""Admission and stream prepare as CUDA graphs (``models.magpie.PrepareGraphs``)
on the card, at 357M.

Each test needs a CUDA device and skips without one; the file imports neither
jax nor the JAX package:
    MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_prepare_graph_cuda.py -q -m cuda

A replay of the graph of every (bucket, M) the serving cells reach (buckets
32 / 64 / 128, M = 1 ... 64), in float32 and in bf16 on ``float32_products``,
bit-equal to eager ``prepare_batch`` on the same inputs, at its capture and
replayed again on other inputs; replays in another order than the captures;
a second group of a shape captures nothing and allocates nothing; a capture
inside a running ``torch.profiler`` profile, whose replays the profile sees
kernel by kernel; a stream's tensors untouched by later streams' replays;
the continuous engine's state after admission (captures, then replays into
the same slots, across the ring's wrap) and ``begin_stream``'s (float32,
bf16 and on Q8_0 blocks, which dequantize inside the graph) bit-equal to
the state built from eager ``prepare_batch`` rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.config import MagpieConfig
from magpie_tts_tpu_torch.io.magpie_weights import (Q8Blocks, q8_blocks_from_numpy,
                                                    random_magpie_weights)
from magpie_tts_tpu_torch.models import magpie as magpie_mod
from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
from magpie_tts_tpu_torch.runtime import engine as engine_mod

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
BUCKETS = (32, 64, 128)
SIZES = (1, 2, 4, 8, 16, 32, 64)
NAMES = ("xa_k", "xa_v", "k_rows", "v_rows", "hidden")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return engine_mod.resolve_device("cuda")


@pytest.fixture(scope="module")
def weights(card):
    c = MagpieConfig()
    w = random_magpie_weights(c, seed=0).to(device=card)
    return c, {"float32": w, "bf16": magpie_mod.float32_products(w.to(dtype=BF))}


@pytest.fixture(scope="module")
def owners(weights):
    """One owner a dtype for every shape of the bit test: all its graphs in
    one pool."""
    c, ws = weights
    return {k: magpie_mod.PrepareGraphs(w, c) for k, w in ws.items()}


def _group(c, m, bucket, seed):
    """Host inputs: tokens [m, bucket] (lengths 1 and the full bucket among
    them), lengths, speakers (every one)."""
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(1, bucket + 1, m)]
    lens[0] = 1
    if m > 1:
        lens[1] = bucket
    tokens = np.zeros((m, bucket), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(2, c.text_vocab_size - 2, n)
    return tokens, lens, [(i + seed) % c.num_speakers for i in range(m)]


def _eager(c, w, card, group):
    tokens, lens, spk = group
    return magpie_mod.prepare_batch(torch.from_numpy(tokens).to(card), lens, spk, w, c)


def _differences(got, want):
    """Names of the outputs that are not bit-equal, with their largest
    |difference| over the largest |value|."""
    return {n: float((g.float() - x.float()).abs().max() / x.float().abs().max())
            for n, g, x in zip(NAMES, got, want) if not torch.equal(g, x)}


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_replay_bit_equal_to_eager(card, weights, owners, dtype, bucket):
    """Every M at this bucket: the capture's first replay, and a replay on
    other inputs, bit-equal to eager ``prepare_batch`` on the same inputs."""
    c, ws = weights
    owner = owners[dtype]
    failed = {}
    with torch.no_grad():
        for m in SIZES:
            for turn, want_mode in enumerate(("capture", "replay")):
                group = _group(c, m, bucket, seed=1000 * turn + bucket + m)
                rows, mode = owner(*group)
                got = [r.clone() for r in rows]
                want = _eager(c, ws[dtype], card, group)
                assert mode == want_mode and all(g.dtype == x.dtype and g.shape == x.shape
                                                 for g, x in zip(got, want))
                diff = _differences(got, want)
                if diff:
                    failed[(bucket, m, mode)] = diff
    assert not failed, f"{dtype}: replay not bit-equal to eager: {failed}"


def test_replay_order_differs_from_capture_order(card, weights):
    """Shapes captured in one order and replayed in the reverse one, each on
    its capture's inputs, give the capture's outputs, and eager's."""
    c, ws = weights
    owner = magpie_mod.PrepareGraphs(ws["bf16"], c)
    shapes = [(32, 1), (64, 4), (128, 2), (32, 8)]
    groups = {s: _group(c, s[1], s[0], seed=7 + s[1]) for s in shapes}
    first = {}
    with torch.no_grad():
        for s in shapes:
            rows, mode = owner(*groups[s])
            assert mode == "capture"
            first[s] = [r.clone() for r in rows]
        for s in reversed(shapes):
            rows, mode = owner(*groups[s])
            assert mode == "replay"
            assert not _differences(rows, first[s]), s
            assert not _differences(rows, _eager(c, ws["bf16"], card, groups[s])), s


def test_second_group_of_a_shape_captures_nothing(card, weights):
    """The second call of a shape replays its graph: no new graph, the same
    output tensors, no device memory allocated."""
    c, ws = weights
    owner = magpie_mod.PrepareGraphs(ws["float32"], c)
    with torch.no_grad():
        rows, mode = owner(*_group(c, 8, 64, seed=1))
        torch.cuda.synchronize()
        graph = owner._graphs[(64, 8)][0]
        allocated = torch.cuda.memory_allocated(card)
        again, mode2 = owner(*_group(c, 8, 64, seed=2))
        torch.cuda.synchronize()
    assert (mode, mode2) == ("capture", "replay") and len(owner._graphs) == 1
    assert owner._graphs[(64, 8)][0] is graph and all(a is b for a, b in zip(rows, again))
    assert torch.cuda.memory_allocated(card) == allocated
    assert dict(owner.calls) == {(64, 8): 2}


def test_capture_under_a_running_profile(card, weights):
    """A first use inside a ``torch.profiler`` profile with CUDA activity (the
    benchmark's traced runs) captures, and the capture's replay and a second
    replay are bit-equal to eager; the profile holds both replays' kernels
    (the owner's side stream made its first, eager run before the profile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    c, ws = weights
    owner = magpie_mod.PrepareGraphs(ws["bf16"], c)
    groups = [_group(c, 4, 32, seed=s) for s in (3, 4)]
    with torch.no_grad():
        assert owner(*_group(c, 1, 64, seed=2))[1] == "capture"
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = []
            for g in groups:
                rows, mode = owner(*g)
                got.append((mode, [r.clone() for r in rows]))
            torch.cuda.synchronize()
    assert [m for m, _ in got] == ["capture", "replay"]
    for (_, rows), g in zip(got, groups):
        assert not _differences(rows, _eager(c, ws["bf16"], card, g))
    kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    eager_kernels = _kernels(lambda: _eager(c, ws["bf16"], card, groups[0]))
    assert eager_kernels > 100 and kernels >= 1.9 * eager_kernels, (kernels, eager_kernels)


def _kernels(fn) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def _q8(c, w, card):
    """``w`` with the encoder's and the decoder's qkv as Q8_0 blocks on the
    card (random codes, f16-valued scales), as ``--serve-q8`` loads them."""
    rng = np.random.default_rng(3)
    D = c.d_model

    def blocks(lead):
        n = 3 * D * D // 32
        return q8_blocks_from_numpy(rng.integers(-127, 128, (lead, n, 32)),
                                    rng.normal(0, 1e-3, (lead, n, 1)).astype(np.float16),
                                    (3 * D, D), "linear").to(card)
    return dataclasses.replace(
        w, encoder=dataclasses.replace(w.encoder, qkv=blocks(c.enc_layers)),
        decoder=dataclasses.replace(w.decoder, qkv=blocks(c.dec_layers)))


def _tokens(c, rng, n):
    return [c.text_bos_id] + [int(v) for v in rng.integers(2, 100, size=n - 2)] + \
        [c.text_eos_id]


def _stream_tensors(stream):
    st = stream["state"]
    return [stream["xa_k"], stream["xa_v"], st.k_cache, st.v_cache, st.hidden]


@pytest.mark.parametrize("kind", ["float32", "bf16", "q8"])
def test_begin_stream_state_equals_eager(card, weights, kind):
    """``begin_stream`` (M = 1 replays) against ``prepare`` on the engine's
    prepare weights, bit for bit; a stream's xa K/V, caches and hidden stay
    as they were through later streams of another bucket and of its own
    (a replay of its graph). The Q8_0 engine captures on its own blocks."""
    c, ws = weights
    w = {"float32": ws["float32"], "bf16": ws["float32"].to(dtype=BF),
         "q8": _q8(c, ws["float32"], card)}[kind]
    eng = engine_mod.MagpieEngine(w, c, device=card, compute_dtype=w.text_emb.dtype,
                                  token_buckets=(32, 64))
    assert eng._prepare.weights is (eng.prepare_weights or eng.weights)
    assert isinstance(eng._prepare.weights.encoder.qkv, Q8Blocks) == (kind == "q8")
    rng = np.random.default_rng(5)
    lengths = (20, 50, 25)
    streams, modes = [], []
    for i, n in enumerate(lengths):
        tokens = _tokens(c, rng, n)
        s = eng.begin_stream(tokens, speaker_id=i % c.num_speakers)
        torch.cuda.synchronize()
        streams.append((tokens, s, [t.clone() for t in _stream_tensors(s)]))
    for i, (tokens, s, first) in enumerate(streams):
        tok, n = eng._pad_tokens(tokens)
        with torch.no_grad():
            xa_k, xa_v, st = magpie_mod.prepare(tok, n, i % c.num_speakers,
                                                eng.prepare_weights or eng.weights, c)
        want = [xa_k, xa_v, st.k_cache, st.v_cache, st.hidden]
        now = _stream_tensors(s)
        assert all(torch.equal(a, b) for a, b in zip(now, first)), f"stream {i} changed"
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(now, want)), \
            f"stream {i}: {_differences(now, want)}"
    assert dict(eng._prepare.calls) == {(32, 1): 2, (64, 1): 1}
    assert len(eng._prepare._graphs) == 2


STATE = ("k_cache", "v_cache", "xa_k", "xa_v", "hidden", "valid", "enc_lengths",
         "logical_pos", "frame_count")


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["float32", "bf16"])
@pytest.mark.parametrize("ring_p", [None, 3], ids=["start", "wrap"])
def test_admission_state_equals_eager_rows(card, weights, dtype, ring_p):
    """The continuous engine's state after admitting a burst over two
    buckets (groups 8, 2, 1 and 4: captures), then the same burst again into
    the same slots (replays), equals an engine's whose admission places
    eager ``prepare_batch`` rows; ``ring_p = 3`` places the rows across the
    ring's wrap."""
    c, ws = weights
    w = ws["float32"].to(dtype=dtype)
    kw = dict(n_slots=16, device=card, compute_dtype=dtype, token_buckets=(32, 64),
              segment_frames=8)
    graphs, eager = (ContinuousBatchingEngine(w, c, **kw) for _ in range(2))

    def eager_prepare(tokens, lens, spk):
        return _eager(c, eager.prepare_weights, card, (tokens, lens, spk)), "eager"
    eager._prepare = eager_prepare
    rng = np.random.default_rng(8)
    burst = [_tokens(c, rng, int(n)) for n in rng.integers(3, 33, 11)] + \
        [_tokens(c, rng, int(n)) for n in rng.integers(33, 65, 4)]
    for wave in range(2):
        for eng in (graphs, eager):
            eng._slot_req = [None] * eng.n_slots
            for i, t in enumerate(burst):
                eng.submit(t, speaker_id=i % c.num_speakers, seed=i + wave)
            if ring_p is not None:
                eng.ring_p = ring_p
            with torch.no_grad():
                eng._admit_pending()
        torch.cuda.synchronize()
        for name in STATE:
            a, b = getattr(graphs, name), getattr(eager, name)
            assert torch.equal(a, b), f"wave {wave}: {name}"
        np.testing.assert_array_equal(graphs.keys, eager.keys)
    assert dict(graphs._prepare.calls) == {(32, 8): 2, (32, 2): 2, (32, 1): 2, (64, 4): 2}
    assert len(graphs._prepare._graphs) == 4
