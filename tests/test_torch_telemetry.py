"""PyTorch port, the program's spans (``runtime.telemetry``): nothing recorded
and nothing changed without a profiler; under a CPU ``torch.profiler`` the
serving and streaming paths' span tree, its copy on the profiler's timeline,
the counts at each boundary, and the benchmark's readers of them over tiny
traced runs of each cell."""

import math
import time
from collections import deque

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from magpie_tts_tpu_torch.io.codec_weights import random_codec_weights
from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu_torch.parallel.continuous import (ContinuousBatchingEngine,
                                                      MultiChipContinuousServer)
from magpie_tts_tpu_torch.runtime import streaming, telemetry
from magpie_tts_tpu_torch.runtime.engine import CodecEngine, MagpieEngine, pick_bucket
from port_bench import run as bench_run
from port_bench import spec
from port_bench.tests import tiny
from tests.utils import tiny_codec_config, tiny_magpie_config

CONFIG = tiny_magpie_config()
CODEC = tiny_codec_config()
SLOTS, SEGMENT, BUCKETS = 2, 4, (16, 32)
TEMP, TOP_K = 0.7, 8

# Each span's enclosing span (None: at the top of its thread).
PARENT = {
    "engine.step": None, "engine.admit": "engine.step", "engine.admit.group": "engine.admit",
    "engine.admit.prepare": "engine.admit.group", "engine.admit.upload": "engine.admit.place",
    "engine.admit.place": "engine.admit.group", "engine.segment": "engine.step",
    "engine.segment.upload": "engine.segment", "engine.segment.enqueue": "engine.segment",
    "engine.segment.read": "engine.segment", "engine.retire": "engine.step",
    "stream.prepare": None, "stream.chunk": None, "decode.read": "stream.chunk",
    "stream.vocode": None, "codec.decode": "stream.vocode", "codec.read": "codec.decode",
}
SERVE_SPANS = {n for n in PARENT if n.startswith("engine.")}
STREAM_SPANS = {n for n in PARENT if not n.startswith("engine.")}


@pytest.fixture(scope="module")
def weights():
    return random_magpie_weights(CONFIG, seed=7), random_codec_weights(CODEC, seed=1)


def _requests(n):
    rng = np.random.default_rng(5)
    return [[CONFIG.text_bos_id] + [int(v) for v in rng.integers(2, 30, size=int(k))] +
            [CONFIG.text_eos_id] for k in rng.integers(3, 25, size=n)]


def _serve(weights, n_requests=6):
    """Codes of ``n_requests`` (more than the slots) through the continuous
    engine, each request's codes in submission order."""
    engine = ContinuousBatchingEngine(weights[0], CONFIG, n_slots=SLOTS, device="cpu",
                                      token_buckets=BUCKETS, segment_frames=SEGMENT)
    ids = [engine.submit(t, seed=i) for i, t in enumerate(_requests(n_requests))]
    finished = {}
    while engine.pending:
        finished.update(engine.step(temperature=TEMP, top_k=TOP_K))
    return [finished[i] for i in ids]


def _stream(weights):
    """Audio of two sentences streamed in 4-frame chunks with 8 frames of context."""
    engine = MagpieEngine(weights[0], CONFIG, device="cpu", token_buckets=BUCKETS)
    codec = CodecEngine(weights[1], CODEC, device="cpu")
    params = streaming.StreamParams(temperature=TEMP, top_k=TOP_K, frames_per_chunk=4,
                                    codec_context_frames=8, seed=3)
    return [np.concatenate([c.samples for c in streaming.stream_sentence(engine, codec, t, params)])
            for t in _requests(2)]


PATHS = {"serve": _serve, "stream": _stream}


def _traced(fn, *args):
    """(fn's result, the spans it recorded, the profiler's ``magpie.*``
    events as (name, start ns, end ns), by start)."""
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    marks = sorted(((e.name()[len("magpie."):], e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("magpie.")), key=lambda m: m[1])
    return out, telemetry.spans(t0, time.perf_counter()), marks


@pytest.fixture(scope="module")
def runs(weights):
    """Each path run once with no profiler (checking nothing was recorded)
    and once under one: {path: (plain result, traced result, records, marks)}."""
    out = {}
    for path, fn in PATHS.items():
        t0 = time.perf_counter()
        plain = fn(weights)
        assert telemetry.spans(t0, time.perf_counter()) == []
        out[path] = (plain, *_traced(fn, weights))
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_untraced_records_nothing_and_traced_bits_equal(runs, path):
    """No profiler: ``span`` is the shared no-op and nothing is recorded.
    With one: the codes (serve) and the audio (stream) are bit-equal."""
    assert telemetry.span("engine.step", x=1) is telemetry.span("codec.read")
    assert not telemetry.span("engine.step").on
    plain, traced, records, _ = runs[path]
    assert records and {r.name for r in records} <= SERVE_SPANS | STREAM_SPANS
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _enclosing(marks, i):
    """The name of the innermost mark that holds mark ``i``, or None."""
    _, s, e = marks[i]
    holders = [m for j, m in enumerate(marks) if j != i and m[1] <= s and e <= m[2]]
    return max(holders, key=lambda m: m[1])[0] if holders else None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_span_tree_and_its_profiler_copy(runs, path):
    """Every span of the path appears, each under the span the table above
    names; each ``record_function`` copy has the same name, order and
    nesting on the profiler's timeline."""
    _, _, records, marks = runs[path]
    by_index = {r.index: r for r in records}
    assert {r.name for r in records} == (SERVE_SPANS if path == "serve" else STREAM_SPANS)
    for r in records:
        parent = by_index[r.parent].name if r.parent >= 0 else None
        assert parent == PARENT[r.name], r.name
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = by_index[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert [m[0] for m in marks] == [r.name for r in sorted(records, key=lambda r: r.start_ns)]
    for i, m in enumerate(marks):
        assert _enclosing(marks, i) == PARENT[m[0]], m


def test_server_threads_keep_their_own_nesting(weights):
    """``MultiChipContinuousServer`` steps its engines from a thread pool:
    each thread's spans nest under that thread's own ``engine.step``."""
    server = MultiChipContinuousServer(weights[0], CONFIG, devices=["cpu", "cpu"],
                                       slots_per_device=SLOTS, token_buckets=BUCKETS,
                                       segment_frames=SEGMENT)
    want = server.synthesize_all(_requests(6), temperature=TEMP, top_k=TOP_K)
    server = MultiChipContinuousServer(weights[0], CONFIG, devices=["cpu", "cpu"],
                                       slots_per_device=SLOTS, token_buckets=BUCKETS,
                                       segment_frames=SEGMENT)
    got, records, _ = _traced(lambda: server.synthesize_all(_requests(6), temperature=TEMP,
                                                            top_k=TOP_K))
    by_index = {r.index: r for r in records}
    steps = [r for r in records if r.name == "engine.step"]
    assert len(steps) >= 2 and all(r.parent == -1 for r in steps)
    for r in records:
        parent = by_index[r.parent].name if r.parent >= 0 else None
        assert parent == PARENT[r.name], r.name
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_server_queue_wait_counts_its_shared_queue(weights):
    """Behind ``MultiChipContinuousServer`` a request's queue wait starts at
    the server's ``submit``: one held in the shared queue until a slot frees
    waits at least from the last submit to its group's start."""
    server = MultiChipContinuousServer(weights[0], CONFIG, devices=["cpu", "cpu"],
                                       slots_per_device=SLOTS, token_buckets=BUCKETS,
                                       segment_frames=SEGMENT)

    def serve():
        for i, t in enumerate(_requests(3 * 2 * SLOTS)):
            server.submit(t, seed=i)
        submitted = time.perf_counter_ns()
        while server.pending:
            server.step(temperature=TEMP, top_k=TOP_K)
        return submitted

    submitted, records, _ = _traced(serve)
    groups = [r for r in records if r.name == "engine.admit.group"]
    assert sum(g.attrs["requests"] for g in groups) == 3 * 2 * SLOTS
    late = [g for g in groups if g.start_ns - submitted > 1e6]
    assert late
    for g in groups:
        assert min(g.attrs["queue_wait_ms"]) >= (g.start_ns - submitted) / 1e6


def test_serve_counts(runs):
    """Requests over groups = admitted = requests placed; groups are powers of
    two; ``slot_frames`` = K x slots a segment; ``kept_frames`` sums to the
    codes returned; every queue wait >= 0, and one request queued behind full
    slots waited longer than a whole segment."""
    _, codes, records, _ = runs["serve"]
    named = {n: [r for r in records if r.name == n] for n in SERVE_SPANS}
    groups, admits = named["engine.admit.group"], named["engine.admit"]
    assert sum(g.attrs["requests"] for g in groups) == sum(a.attrs["admitted"] for a in admits)
    assert sum(a.attrs["admitted"] for a in admits) == len(codes) == 6
    assert all(g.attrs["requests"] & (g.attrs["requests"] - 1) == 0 for g in groups)
    assert all(len(g.attrs["request_ids"]) == len(g.attrs["queue_wait_ms"]) ==
               g.attrs["requests"] for g in groups)
    assert sorted(i for g in groups for i in g.attrs["request_ids"]) == list(range(6))
    assert sorted(i for r in named["engine.retire"] for i in r.attrs["request_ids"]) == \
        list(range(6))
    assert len(named["engine.admit.prepare"]) == len(groups)
    segs = named["engine.segment"]
    assert all(s.attrs["slot_frames"] == SEGMENT * SLOTS for s in segs)
    assert sum(s.attrs["slot_frames"] for s in segs) == len(segs) * SEGMENT * SLOTS
    assert sum(s.attrs["kept_frames"] for s in segs) == sum(c.shape[0] for c in codes)
    assert all(0 <= s.attrs["kept_frames"] <= s.attrs["slot_frames"] for s in segs)
    waits = [w for g in groups for w in g.attrs["queue_wait_ms"]]
    assert min(waits) >= 0
    assert max(waits) > 1e3 * segs[0].seconds


@pytest.mark.parametrize("lengths", [(7, 30, 0, 13), (1,), (33, 2)])
def test_decode_batch_counts_match_its_padding(weights, lengths):
    codec = CodecEngine(weights[1], CODEC, device="cpu")
    rng = np.random.default_rng(2)
    codes = [rng.integers(0, 32, size=(n, 8)).astype(np.int32) for n in lengths]
    audios, records, _ = _traced(codec.decode_batch, codes)
    (batch,) = [r for r in records if r.name == "codec.decode_batch"]
    bucket = pick_bucket(codec.frame_buckets, max(max(lengths), 1))
    assert batch.attrs == {"requests": len(lengths), "frames": sum(lengths),
                           "vocoded": len(lengths) * bucket}
    assert [a.shape[0] for a in audios] == [n * CODEC.hop_length for n in lengths]
    assert [r.name for r in records if r.parent == batch.index] == ["codec.read"]


def test_stream_reads_a_frame_and_vocodes_the_window(weights):
    """One ``decode.read`` a frame the loop ran (the frames made, plus the
    EOS frame where one ended the sentence); each ``stream.vocode`` vocodes
    the window, of which its chunk's frames are new."""
    engine = MagpieEngine(weights[0], CONFIG, device="cpu", token_buckets=BUCKETS)
    codec = CodecEngine(weights[1], CODEC, device="cpu")
    params = streaming.StreamParams(temperature=TEMP, top_k=TOP_K, frames_per_chunk=4,
                                    codec_context_frames=8, seed=3)
    window = min(8 + 4, CONFIG.max_dec_steps)
    for tokens in _requests(3):
        chunks, records, _ = _traced(
            lambda: list(streaming.stream_sentence(engine, codec, tokens, params)))
        made = chunks[-1].frames_generated
        ended_by_eos = made < CONFIG.max_dec_steps
        reads = [r for r in records if r.name == "decode.read"]
        assert len(reads) == made + int(ended_by_eos)
        assert sum(r.attrs["frames"] for r in records if r.name == "stream.chunk") == made
        vocodes = [r for r in records if r.name == "stream.vocode"]
        assert len(vocodes) == len(chunks)
        assert all(v.attrs["vocoded"] == window for v in vocodes)
        assert [v.attrs["frames"] for v in vocodes] == [
            c.samples.shape[0] // CODEC.hop_length for c in chunks]


def test_overflow_is_counted(monkeypatch):
    """A full ring overwrites its oldest records and counts them; a profile
    after that still records, and indices keep counting every span."""
    monkeypatch.setattr(telemetry, "_records", deque(maxlen=2))
    before = telemetry.dropped()
    for profiled in range(2):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU]):
            for i in range(5):
                with telemetry.span("codec.read", i=i):
                    pass
        kept = telemetry.spans(t0, time.perf_counter())
        assert [r.attrs["i"] for r in kept] == [3, 4]
        assert kept[1].index == kept[0].index + 1
        assert telemetry.dropped() - before == 3 + 5 * profiled


# ---- the benchmark's readers of the spans, over tiny traced runs -------------

BENCH = spec.benchmark()
PROGRAM_METRICS = [(m["name"], cell) for m in BENCH["per_layer"]
                   if m["source"] in ("program_span", "program_counter")
                   for cell in m["workloads"]]
RANGES = {"%": (0.0, 100.0), "req/group": (1.0, 64.0)}
# p90 wants ten waits beyond it: a hundred admissions, which the four-slot
# tiny run does not reach in seconds; one step of 100 slots admits 100.
WIDE = {"engine": {"slots": 100, "segment_frames": 1},
        "traffic": {"clients": 100, "pool_size": 116}}


@pytest.fixture(scope="module")
def tiny_runs():
    cache = {}

    def get(cell, wide):
        if (cell, wide) not in cache:
            o = tiny.overrides(cell)
            if wide:
                for key, extra in WIDE.items():
                    o["workload"][key] = {**o["workload"][key], **extra}
            res = bench_run.run_cell(cell, 2**33 + 11, 0.01 if wide else 3.0, True,
                                     device="cpu", overrides=o, log=lambda *a, **k: None)
            cache[(cell, wide)] = res.pop("_run")
        return cache[(cell, wide)]
    return get


@pytest.mark.parametrize("name,cell", PROGRAM_METRICS, ids=lambda x: x)
def test_program_metric_reads_a_tiny_traced_run(tiny_runs, name, cell):
    unit = next(m["unit"] for m in BENCH["per_layer"] if m["name"] == name)
    run = tiny_runs(cell, name == "queue_wait_p90_ms.tput")
    value = spec.module("metrics", name).read(run)
    assert value is not None and math.isfinite(value), (name, cell, value)
    if name == "prepare_graph_share.tput":
        # No card: every prepare runs eagerly, none replays a graph.
        assert value == 0.0, (name, cell, value)
        return
    lo, hi = RANGES.get(unit, (0.0, math.inf))
    if name == "admit_group_size.tput" and cell.startswith("serve"):
        hi = run.workload["engine"]["slots"]
    assert lo <= value <= hi and value > 0, (name, cell, value)


@pytest.mark.parametrize("name", sorted({n for n, _ in PROGRAM_METRICS}))
def test_program_metric_reads_nothing_from_an_untraced_window(name):
    """A window with no program spans (no profiler ran) reads None."""
    from port_bench.run import Run

    t = time.perf_counter()
    run = Run("serve-bf16-sat", {"engine": {"segment_frames": 32}}, "bfloat16", 0.0, 0.0,
              {"t0": t, "t_end": t, "counts": {}}, {}, {}, {}, None, {}, 0.0)
    assert spec.module("metrics", name).read(run) is None
