"""PyTorch port, over-long requests on the continuous engine: the port's
counterpart of tests/test_long_inputs.py's chunk-and-reassemble test. A
request longer than the largest token bucket splits at word boundaries into
child chunks (child i > 0 with seed + i) that run as separate slots and are
joined in order; the port's codes must equal the JAX continuous engine's
exactly (same weights, tokens, seeds), at temp 0 and 0.7, on the tiny config
with 3 slots and token buckets 8 / 16. Tolerance: none (exact codes)."""

import numpy as np
import pytest

from magpie_tts_tpu.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu.parallel.continuous import ContinuousBatchingEngine as JaxContinuous
from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
from magpie_tts_tpu_torch.runtime.engine import split_to_buckets
from tests.test_torch_support import port_magpie_weights
from tests.utils import tiny_magpie_config

CONFIG = tiny_magpie_config()
TOKEN_BUCKETS = (8, 16)
BOS, EOS = CONFIG.text_bos_id, CONFIG.text_eos_id
SPACE = 9  # the split token (tests/test_long_inputs.py's stand-in for the space id)
SLOTS, SEGMENT = 3, 4


def make_long_tokens(n_words: int, word_len: int = 3):
    """[BOS, w w w, SPACE, w w w, SPACE, ..., EOS] (tests/test_long_inputs.py)."""
    body = []
    for w in range(n_words):
        body.extend([1 + (w + j) % 7 for j in range(word_len)])
        if w != n_words - 1:
            body.append(SPACE)
    return [BOS] + body + [EOS]


@pytest.fixture(scope="module")
def weights():
    jw = random_magpie_weights(CONFIG, seed=11)
    return jw, port_magpie_weights(jw)


def _engine(cls, w, **kw):
    eng = cls(w, CONFIG, n_slots=SLOTS, token_buckets=TOKEN_BUCKETS, segment_frames=SEGMENT,
              **kw)
    eng.split_token_id = SPACE
    return eng


def _drive(engine, requests, temperature):
    """Submit every request, pump until all are finished; codes by request."""
    ids = [engine.submit(ids, seed=seed) for ids, seed in requests]
    finished = {}
    for _ in range(400):
        finished.update(engine.step(temperature=temperature, top_k=8))
        if all(i in finished for i in ids):
            break
    assert all(i in finished for i in ids)
    return [finished[i] for i in ids]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_long_request_chunks_and_reassembles_like_jax(weights, temperature):
    """A 41-token request (three chunks over bucket 16) beside a short one:
    the port's joined codes equal the JAX engine's."""
    jw, pw = weights
    long_ids = make_long_tokens(10)
    chunks = split_to_buckets(long_ids, TOKEN_BUCKETS, SPACE, BOS, EOS)
    assert len(chunks) > 1 and len(long_ids) > max(TOKEN_BUCKETS)
    requests = [(long_ids, 5), ([BOS, 1, 2, EOS], 2)]
    want = _drive(_engine(JaxContinuous, jw), requests, temperature)
    got = _drive(_engine(ContinuousBatchingEngine, pw, device="cpu"), requests, temperature)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_long_request_equals_its_chunks_run_alone(weights):
    """At temp 0 the joined codes equal the chunks run as separate requests
    (child i with seed + i), in order: the split path reassembles, it does
    not resample."""
    _, pw = weights
    long_ids = make_long_tokens(10)
    joined = _drive(_engine(ContinuousBatchingEngine, pw, device="cpu"), [(long_ids, 0)],
                    0.0)[0]
    chunks = split_to_buckets(long_ids, TOKEN_BUCKETS, SPACE, BOS, EOS)
    parts = _drive(_engine(ContinuousBatchingEngine, pw, device="cpu"),
                   [(ch, i) for i, ch in enumerate(chunks)], 0.0)
    np.testing.assert_array_equal(joined, np.concatenate(parts, axis=0))
