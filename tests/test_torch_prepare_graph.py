"""PyTorch port, admission and stream prepare through ``PrepareGraphs`` on the
CPU: ``prepare_batch`` is ``prepare_rows`` on uploaded inputs, bit for bit;
off a card the owner runs ``prepare_batch`` eagerly and the ``graph``
attribute of the ``engine.admit.prepare`` and ``stream.prepare`` spans reads
``eager``; the engine hands it (bucket, M) shapes of power-of-two groups of
at most ``n_slots``; ``begin_stream``'s state equals ``prepare``'s; the
benchmark's reader of the attribute. The card's graphs:
tests/test_torch_prepare_graph_cuda.py."""

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from magpie_tts_tpu_torch.io.magpie_weights import (Q8Blocks, has_q8_blocks, q8_blocks_from_numpy,
                                                    random_magpie_weights)
from magpie_tts_tpu_torch.models import magpie as tmagpie
from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
from magpie_tts_tpu_torch.runtime import telemetry
from magpie_tts_tpu_torch.runtime.engine import MagpieEngine
from port_bench import spec
from tests.utils import tiny_magpie_config

CONFIG = tiny_magpie_config()
BUCKETS = (16, 32)
BF = torch.bfloat16
READER = spec.module("metrics", "prepare_graph_share.tput")


@pytest.fixture(scope="module")
def weights():
    return random_magpie_weights(CONFIG, seed=9)


def _q8(w):
    """``w`` with the encoder's and the decoder's qkv as Q8_0 blocks (random
    codes and f16-valued scales), as a ``--serve-q8`` load holds them."""
    rng = np.random.default_rng(3)

    def blocks(lead, torch_shape):
        n = int(np.prod(torch_shape)) // 32
        return q8_blocks_from_numpy(rng.integers(-127, 128, (lead, n, 32)),
                                    rng.normal(0, 1e-3, (lead, n, 1)).astype(np.float16),
                                    torch_shape, "linear")
    D = CONFIG.d_model
    return dataclasses.replace(
        w, encoder=dataclasses.replace(w.encoder, qkv=blocks(CONFIG.enc_layers, (3 * D, D))),
        decoder=dataclasses.replace(w.decoder, qkv=blocks(CONFIG.dec_layers, (3 * D, D))))


def _group(m, bucket, seed=0):
    """Host inputs of a group: tokens [m, bucket] (lengths 1 and the full
    bucket among them), lengths, speakers (both of the tiny config's)."""
    rng = np.random.default_rng(seed + m)
    lens = [int(n) for n in rng.integers(1, bucket + 1, m)]
    lens[0] = 1
    if m > 1:
        lens[1] = bucket
    tokens = np.zeros((m, bucket), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(2, CONFIG.text_vocab_size - 2, n)
    return tokens, lens, [i % CONFIG.num_speakers for i in range(m)]


WEIGHTS = {"float32": lambda w: w, "bf16": lambda w: tmagpie.float32_products(w.to(dtype=BF)),
           "q8": _q8}


@pytest.mark.parametrize("kind", sorted(WEIGHTS))
@pytest.mark.parametrize("m", [1, 3, 4])
def test_prepare_batch_is_prepare_rows(weights, kind, m):
    """``prepare_batch`` = ``prepare_rows`` on the same inputs uploaded by
    hand (int64 lengths and speakers), bit for bit, in float32, in bf16 on
    ``float32_products`` and on weights holding Q8_0 blocks."""
    w = WEIGHTS[kind](weights)
    assert has_q8_blocks(w) == (kind == "q8")
    tokens, lens, spk = _group(m, 16)
    with torch.no_grad():
        want = tmagpie.prepare_batch(torch.from_numpy(tokens), lens, spk, w, CONFIG)
        got = tmagpie.prepare_rows(torch.from_numpy(tokens), torch.tensor(lens),
                                   torch.tensor(spk), w, CONFIG)
    assert len(got) == len(want) == 5
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)


@pytest.mark.parametrize("kind", sorted(WEIGHTS))
def test_owner_runs_prepare_batch_eagerly_off_a_card(weights, kind, monkeypatch):
    """On the CPU every call is ``prepare_batch`` itself (mode ``eager``),
    with the owner's weights, on the host arrays uploaded as they came;
    ``calls`` counts the calls by (T, M)."""
    w = WEIGHTS[kind](weights)
    owner = tmagpie.PrepareGraphs(w, CONFIG)
    seen = []
    real = tmagpie.prepare_batch

    def recording(tokens, lens, spk, weights_, config):
        seen.append((tokens.clone(), list(lens), list(spk), weights_))
        return real(tokens, lens, spk, weights_, config)
    monkeypatch.setattr(tmagpie, "prepare_batch", recording)
    shapes = [(4, 16), (1, 32), (4, 16)]
    with torch.no_grad():
        for i, (m, bucket) in enumerate(shapes):
            tokens, lens, spk = _group(m, bucket, seed=i)
            rows, mode = owner(tokens, lens, spk)
            assert mode == "eager"
            want = real(torch.from_numpy(tokens), lens, spk, w, CONFIG)
            assert all(torch.equal(g, x) for g, x in zip(rows, want))
            tok, l_, s_, w_ = seen[-1]
            assert torch.equal(tok, torch.from_numpy(tokens)) and (l_, s_) == (lens, spk)
            assert w_ is w
    assert len(seen) == 3 and dict(owner.calls) == {(16, 4): 2, (32, 1): 1}
    assert not owner._graphs


def _tokens(rng, n):
    return [CONFIG.text_bos_id] + [int(v) for v in rng.integers(2, 30, size=n)] + \
        [CONFIG.text_eos_id]


@pytest.mark.parametrize("slots", [3, 4, 6])
def test_engine_shapes_are_bucket_and_group_size(weights, slots):
    """The continuous engine hands its owner one (bucket, M) a group: M a
    power of two and at most ``n_slots``, a token bucket of the engine, the
    groups' sizes summing to the requests admitted (more requests than
    slots, over two buckets, in two waves)."""
    eng = ContinuousBatchingEngine(weights, CONFIG, n_slots=slots, device="cpu",
                                   token_buckets=BUCKETS, segment_frames=4)
    assert eng._prepare.weights is eng.prepare_weights
    rng = np.random.default_rng(slots)
    lengths = [3, 20, 5, 7, 25, 4, 9, 11, 2, 6]
    for n in lengths:
        eng.submit(_tokens(rng, n), seed=n)
    eng._admit_pending()
    first = dict(eng._prepare.calls)
    while eng.pending:
        eng.step(temperature=0.7, top_k=8)
    calls = eng._prepare.calls
    assert sum(first.values()) >= 1 and sum(m * k for (_, m), k in first.items()) == slots
    assert sum(m * k for (_, m), k in calls.items()) == len(lengths)
    for bucket, m in calls:
        assert bucket in BUCKETS and m & (m - 1) == 0 and 1 <= m <= slots


def test_span_attribute_reads_eager_off_a_card(weights):
    """Under a CPU profile every ``engine.admit.prepare`` and
    ``stream.prepare`` span carries ``graph="eager"``, and the benchmark's
    reader of the attribute reads 0% replays from them."""
    from magpie_tts_tpu_torch.io.codec_weights import random_codec_weights
    from magpie_tts_tpu_torch.runtime import streaming
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine
    from tests.utils import tiny_codec_config

    eng = ContinuousBatchingEngine(weights, CONFIG, n_slots=2, device="cpu",
                                   token_buckets=BUCKETS, segment_frames=4)
    rng = np.random.default_rng(1)
    stream_engine = MagpieEngine(weights, CONFIG, device="cpu", token_buckets=BUCKETS)
    codec = CodecEngine(random_codec_weights(tiny_codec_config(), seed=1), tiny_codec_config(),
                        device="cpu")
    params = streaming.StreamParams(temperature=0.7, top_k=8, frames_per_chunk=4,
                                    codec_context_frames=8, seed=3)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        for i, n in enumerate((4, 9, 20)):
            eng.submit(_tokens(rng, n), seed=i)
        while eng.pending:
            eng.step(temperature=0.7, top_k=8)
        list(streaming.stream_sentence(stream_engine, codec, _tokens(rng, 6), params))
    t1 = time.perf_counter()
    spans = [s for s in telemetry.spans(t0, t1)
             if s.name in ("engine.admit.prepare", "stream.prepare")]
    assert {s.name for s in spans} == {"engine.admit.prepare", "stream.prepare"}
    assert all(s.attrs == {"graph": "eager"} for s in spans)
    run = _Run({"t0": t0, "t_end": t1})
    assert READER.read(run) == 0.0


@dataclasses.dataclass
class _Run:
    win: dict


def test_reader_counts_replays_and_reads_none_without_the_attribute():
    """The reader: replays over every prepare span that carries ``graph``,
    admission and stream alike; None where no span carries it (a program
    without the graphs) or no span ran."""
    def window(attrs):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU]):
            for name, a in attrs:
                with telemetry.span(name, **a):
                    pass
        return _Run({"t0": t0, "t_end": time.perf_counter()})
    mixed = window([("engine.admit.prepare", {"graph": "capture"}),
                    ("engine.admit.prepare", {"graph": "replay"}),
                    ("stream.prepare", {"graph": "replay"}),
                    ("stream.prepare", {"graph": "eager"}),
                    ("codec.read", {})])
    assert READER.read(mixed) == 50.0
    assert READER.read(window([("engine.admit.prepare", {"graph": "replay"})])) == 100.0
    assert READER.read(window([("engine.admit.prepare", {}), ("stream.prepare", {})])) is None
    assert READER.read(window([("codec.read", {})])) is None


@pytest.mark.parametrize("kind", ["float32", "q8"])
def test_begin_stream_state_equals_prepare(weights, kind):
    """``begin_stream`` through the owner: xa K/V, the cache with the context
    + BOS rows, hidden and position bit-equal to ``prepare``'s on the
    engine's weights (the Q8_0 engine's prepare dequantizes its own blocks)."""
    w = WEIGHTS[kind](weights)
    eng = MagpieEngine(w, CONFIG, device="cpu", token_buckets=BUCKETS)
    assert eng._prepare.weights is (eng.prepare_weights or eng.weights)
    tokens = _tokens(np.random.default_rng(4), 11)
    stream = eng.begin_stream(tokens, speaker_id=1)
    tok, n = eng._pad_tokens(tokens)
    with torch.no_grad():
        xa_k, xa_v, st = tmagpie.prepare(tok, n, 1, w, CONFIG)
    got = stream["state"]
    assert stream["enc_length"] == n and got.pos == st.pos and got.frame_idx == 0
    for a, b in ((stream["xa_k"], xa_k), (stream["xa_v"], xa_v), (got.k_cache, st.k_cache),
                 (got.v_cache, st.v_cache), (got.hidden, st.hidden)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert dict(eng._prepare.calls) == {(16, 1): 1}
    assert not has_q8_blocks(stream["weights"])
    assert isinstance(w.encoder.qkv, Q8Blocks) == (kind == "q8")
