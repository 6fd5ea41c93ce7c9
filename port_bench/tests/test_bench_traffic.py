"""The traffic generator: fixed by the cell's pool seed, ordered by --seed."""

from __future__ import annotations

from collections import Counter
from itertools import islice

import numpy as np

import pytest

from port_bench import spec, traffic

HP = {"num_speakers": 5, "text_bos_id": 2378, "text_eos_id": 2379}
TR = {"pool_size": 40, "pool_seed": 11, "prompt_tokens": [16, 96]}


def test_pool_is_fixed_by_its_seed():
    a, b = traffic.pool(TR, HP), traffic.pool(TR, HP)
    assert a == b
    assert traffic.pool({**TR, "pool_seed": 12}, HP) != a
    lengths = sorted(len(r.tokens) for r in a)
    assert lengths[0] == 16 and lengths[-1] == 96
    assert Counter(r.speaker for r in a) == Counter({s: 8 for s in range(5)})
    for r in a:
        assert r.tokens[0] == 2378 and r.tokens[-1] == 2379
        assert all(2 <= t < 2378 for t in r.tokens[1:-1])
        assert 0 <= r.seed < 2**31


def test_order_is_fixed_by_the_seed_and_cycles_the_whole_pool():
    pool = traffic.pool(TR, HP)
    big = 2**40 + 17                       # the driver's seeds exceed 32 bits
    first = [r.index for r in islice(traffic.order(pool, big), 120)]
    assert first == [r.index for r in islice(traffic.order(pool, big), 120)]
    assert first != [r.index for r in islice(traffic.order(pool, big + 1), 120)]
    for cycle in range(3):
        assert sorted(first[cycle * 40:(cycle + 1) * 40]) == list(range(40))


@pytest.mark.parametrize("change", [{"loop": "open"}, {"prompt_tokens": [16, 129]}])
def test_serve_driver_refuses_traffic_it_cannot_keep_apart(change):
    """Only closed loops, and only prompts that the engine keeps whole: a
    longer one would be split into children whose ids collide with the pool's."""
    from types import SimpleNamespace

    serve = spec.module("drivers", "serve")
    wl = spec.load("workloads", "serve-bf16-sat")
    ctx = SimpleNamespace(workload={**wl, "traffic": {**wl["traffic"], **change}})
    with pytest.raises(ValueError):
        serve.window(ctx, None, 1.0)


def test_sample_holds_the_longest():
    picks = traffic.sample(50, 8, 9, always=(41,))
    assert 41 in picks and len(picks) == 8
    assert picks == traffic.sample(50, 8, 9, always=(41,))
