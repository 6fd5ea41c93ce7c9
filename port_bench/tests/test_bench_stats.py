"""Percentiles with their refusal, spreads, the busy union and idle gaps."""

from __future__ import annotations

import statistics

import pytest

from port_bench import stats, trace


def test_percentile_nearest_rank_and_misses():
    values = list(range(1, 201))                        # 200 samples: p95 has 10 beyond
    assert stats.percentile(values, 95) == 190
    assert stats.percentile(values, 50) == 100
    assert stats.percentile(values[:100], 90) == 90
    assert stats.percentile(values[:-1] + [float("inf")], 95) == 190
    assert stats.percentile([1.0] * 189 + [float("inf")] * 11, 95) == float("inf")


@pytest.mark.parametrize("n,p", [(199, 95), (99, 90), (9, 0), (19, 50)])
def test_percentile_refused_with_fewer_than_ten_beyond(n, p):
    with pytest.raises(stats.TooFewSamples):
        stats.percentile(list(range(n)), p)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 9.0, 10.5, 9.5, 10.2]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_busy_union_and_gaps():
    intervals = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert trace._union(intervals) == pytest.approx(3 + 1 + 1)
    assert trace._gaps(intervals, -1, 10) == [(-1, 0), (3, 5), (6, 8), (9, 10)]
    stages = [(0.0, 4.0, "segment"), (4.5, 7.0, "codec")]
    starts = [s for s, _, _ in stages]
    assert trace._stage_at(stages, starts, 3.0) == "segment"
    assert trace._stage_at(stages, starts, 4.2) == "host"
    assert trace._stage_at(stages, starts, 6.0) == "codec"


class _Event:
    """A stand-in for the profiler's raw event (``_KinetoEvent``)."""

    def __init__(self, name, device, start, end, annotation=False):
        self._n, self._d, self._s, self._e, self._a = name, device, start, end, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return self._a


def test_reduce_profile_attributes_kernels_by_span_extent():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event("bench.window", cpu, 0, 100),
        _Event("bench.stage.segment", cpu, 0, 38),
        _Event("bench.stage.codec", cpu, 50, 90),
        _Event("bench.kernel.C", gpu, 10, 30, annotation=True),
        _Event("k_c1", gpu, 10, 15), _Event("k_c2", gpu, 20, 30),
        _Event("bench.kernel.B", gpu, 60, 80, annotation=True),
        _Event("k_b", gpu, 60, 80),
        _Event("Memcpy DtoH", gpu, 40, 45),
        _Event("k_other", gpu, 95, 110),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    out = trace.reduce_profile(prof)
    assert out["window_s"] == pytest.approx(100e-9)
    assert out["kernel_s"]["C"] == pytest.approx(15e-9)
    assert out["kernel_s"]["B"] == pytest.approx(20e-9)
    assert out["busy_s"] == pytest.approx((5 + 10 + 20 + 5) * 1e-9)
    idle = dict(out["breakdown"]["idle_gaps"])
    # A gap goes to the stage the host was in when the card went idle.
    assert idle["segment"] == pytest.approx(45e-9)      # 0-10, 15-20, 30-60
    assert idle["codec"] == pytest.approx(15e-9)        # 80-95
    assert set(idle) == {"segment", "codec"}
    assert out["breakdown"]["device_ops"][0][0] == "k_b"
