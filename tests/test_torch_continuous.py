"""PyTorch port, continuous batching: ContinuousBatchingEngine against the JAX
engine (exact codes at temp 0.7, so the ring cache, admission, keys and ids
all match), against the port's single-stream engine at temp 0, and the
per-device server against one engine, on the CPU."""

import numpy as np
import pytest

from magpie_tts_tpu.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu.parallel.continuous import ContinuousBatchingEngine as JaxContinuous
from magpie_tts_tpu_torch.parallel.continuous import (ContinuousBatchingEngine,
                                                      MultiChipContinuousServer)
from magpie_tts_tpu_torch.runtime.engine import MagpieEngine
from tests.test_torch_support import port_magpie_weights
from tests.utils import tiny_magpie_config

CONFIG = tiny_magpie_config()
TEMP, TOP_K = 0.7, 8


@pytest.fixture(scope="module")
def weights():
    jw = random_magpie_weights(CONFIG, seed=7)
    return jw, port_magpie_weights(jw)


def _tokens(rng, n):
    return [CONFIG.text_bos_id] + [int(v) for v in rng.integers(2, 30, size=n)] + \
        [CONFIG.text_eos_id]


def _drive(engine, waves, temperature):
    """Submit wave 0, run one step, submit the later waves one per step, then
    pump until drained. Returns codes per request in submission order."""
    ids = [engine.submit(tok, seed=seed) for tok, seed in waves[0]]
    finished = dict(engine.step(temperature=temperature, top_k=TOP_K))
    for wave in waves[1:]:
        ids += [engine.submit(tok, seed=seed) for tok, seed in wave]
        finished.update(engine.step(temperature=temperature, top_k=TOP_K))
    while engine.pending:
        finished.update(engine.step(temperature=temperature, top_k=TOP_K))
    assert sorted(finished) == sorted(ids)
    return [finished[i] for i in ids]


# (slots, segment_frames, token buckets, request lengths per wave)
CASES = {
    # requests join after a segment has advanced the ring pointer
    "staggered": (3, 5, (16, 32), [[4, 9, 6], [12, 5]]),
    # one burst admitted across two token buckets
    "burst_two_buckets": (4, 6, (16, 32), [[4, 20, 5, 25]]),
    # one slot reused; 16-frame segments wrap the 48-row ring
    "slot_reuse": (1, 16, (16,), [[5], [8], [3]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_continuous_codes_equal_jax(weights, case):
    jw, pw = weights
    slots, seg, buckets, lengths = CASES[case]
    rng = np.random.default_rng(len(case))
    waves = [[(_tokens(rng, n), 3 + i) for i, n in enumerate(wave)] for wave in lengths]
    want = _drive(JaxContinuous(jw, CONFIG, n_slots=slots, token_buckets=buckets,
                                segment_frames=seg), waves, TEMP)
    engine = ContinuousBatchingEngine(pw, CONFIG, n_slots=slots, device="cpu",
                                      token_buckets=buckets, segment_frames=seg)
    got = _drive(engine, waves, TEMP)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{case} request {i}")


def test_continuous_greedy_equals_single_stream(weights):
    """At temp 0 a request's codes do not depend on its slot or ring rows:
    they equal the single-stream engine's. Nine requests through three slots
    wrap the ring, context rows included."""
    _, pw = weights
    rng = np.random.default_rng(11)
    reqs = [_tokens(rng, n) for n in (4, 9, 6, 12, 5, 7, 3, 10, 8)]
    reference = MagpieEngine(pw, CONFIG, device="cpu", token_buckets=(16, 32))
    want = [reference.synthesize_codes(r, temperature=0.0, top_k=1).codes for r in reqs]
    engine = ContinuousBatchingEngine(pw, CONFIG, n_slots=3, device="cpu",
                                      token_buckets=(16, 32), segment_frames=5)
    ring_rows = []
    ids = [engine.submit(r) for r in reqs[:3]]
    finished = {}
    while engine.pending:
        if len(ids) < len(reqs):
            ids.append(engine.submit(reqs[len(ids)]))
        ring_rows.append(engine.ring_p)
        finished.update(engine.step(temperature=0.0, top_k=1))
    assert any(p < CONFIG.context_frames + 1 for p in ring_rows), "the ring never wrapped"
    for i, (rid, w) in enumerate(zip(ids, want)):
        np.testing.assert_array_equal(finished[rid], w, err_msg=f"request {i}")


def test_multi_device_server_equals_one_engine(weights):
    """One engine per device behind the shared queue (two CPU devices, two
    slots each, more requests than slots) gives one engine's greedy codes."""
    _, pw = weights
    rng = np.random.default_rng(12)
    reqs = [_tokens(rng, n) for n in (4, 9, 6, 12, 5, 7)]
    one = ContinuousBatchingEngine(pw, CONFIG, n_slots=2, device="cpu",
                                   token_buckets=(16, 32), segment_frames=5)
    want = one.synthesize_all(reqs, temperature=0.0, top_k=1)
    server = MultiChipContinuousServer(pw, CONFIG, devices=["cpu", "cpu"], slots_per_device=2,
                                       token_buckets=(16, 32), segment_frames=5)
    got = server.synthesize_all(reqs, temperature=0.0, top_k=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(e._next_id > 0 for e in server.engines)
