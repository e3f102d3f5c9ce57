"""The arithmetic of the metrics on inputs with known answers."""
from __future__ import annotations

import pytest

from conftest import REPO

from benchmark import stats
from benchmark import trace as tracing
from benchmark.harness import Run, SlotSample, Window
from benchmark.manifest import Bench


def test_union_and_gaps():
    merged = tracing.union([(5, 7), (0, 2), (1, 3), (6, 9), (12, 13)])
    assert merged == [[0, 3], [5, 9], [12, 13]]
    assert sum(e - s for s, e in merged) == 8  # a sum of the five is 10
    assert tracing.gaps(merged, 0, 15) == [(3, 5), (9, 12), (13, 15)]
    assert tracing.gaps(merged, 1, 6) == [(3, 5)]
    assert tracing.gaps([], 0, 4) == [(0, 4)]


def test_gaps_are_named_by_the_innermost_event():
    cpu = [(0, 100, "bench.window"), (10, 50, "bench.call"),
           (20, 30, "aten::copy_"), (60, 70, "bench.return")]
    named = tracing.name_gaps(cpu, [(22, 24), (40, 44), (55, 57), (61, 69),
                                    (110, 120)])
    assert named == {"aten::copy_": 2, "bench.call": 4, "bench.window": 2,
                     "bench.return": 8, "python": 10}


def test_rate_and_least_bytes():
    assert stats.rate(48.0, 2.0) == 24.0
    # 3024 x 4032 RGB read once plus 1,000,000 scan bytes written once
    assert stats.least_bytes(3024 * 4032, 3, 1_000_000) == 37_578_304


def _draw(seed, keys, k=5, calls=200):
    s = SlotSample(k, seed)
    s.choose(keys)
    for call in range(calls):
        for slot in range(len(keys)):
            s.offer(slot, (slot, call))
    return sorted(s.items)


def test_the_slot_sample_takes_each_size_s_ends_and_repeats_for_a_seed():
    keys = ["a", "b", "a", "c", "a", "b", "a", "a", "b", "c"] * 10
    got = _draw(7, keys, k=12)
    assert got == _draw(7, keys, k=12) and got != _draw(8, keys, k=12)
    slots = [slot for slot, _ in got]
    assert len(slots) == len(set(slots)) == 12
    # the first and last slot of each key
    assert {0, 97, 1, 98, 3, 99} <= set(slots)
    # one call a slot, drawn over the calls
    assert len({call for _, call in got}) > 3
    one_size = {slot for slot, _ in _draw(1, ["x"] * 16, k=8)}
    assert len(one_size) == 8 and {0, 15} <= one_size
    assert len(_draw(1, ["x"] * 3, k=8)) == 3  # fewer slots than k


def _run(trace, window):
    return Run(setup_s=9.5, window=window, trace=trace,
               least_bytes=int(3.35e11),
               peaks={"hbm_bytes_per_s": 3.35e12})


@pytest.mark.parametrize("name, want", [
    ("throughput_mpix_s", 25.0),
    ("setup_s", 9.5),
    ("device_idle_pct", 75.0),
    ("kernel_ms_per_mpix", 2.0),
    ("h2d_ms_per_mpix", 4.0),
    ("launches_per_image", 12.5),
    ("device_roofline_pct", 50.0),
])
def test_readers(name, want):
    win = Window(t_start=1.0, t_end=5.0, attempted=40, returned=40,
                 pixels=100_000_000, out_bytes=0)
    summary = tracing.Summary(window_s=4.0, busy_s=1.0, kernel_s=0.2,
                              kernels=500, h2d_s=0.4, device_ops=[],
                              idle_gaps=[])
    reader = Bench(REPO).reader(name)
    assert reader.read(_run(summary, win)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["device_idle_pct", "kernel_ms_per_mpix",
                                  "h2d_ms_per_mpix", "launches_per_image",
                                  "device_roofline_pct"])
def test_readers_with_nothing_to_read_return_none(name):
    reader = Bench(REPO).reader(name)
    assert reader.read(_run(None, Window(t_start=0, t_end=1))) is None


class _Event:
    def __init__(self, name, start, end, cuda=False, tid=1, note=False):
        import torch
        self._v = (name, start, end, tid, note)
        self._dt = (torch.autograd.DeviceType.CUDA if cuda
                    else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def device_type(self):
        return self._dt


def test_a_trace_reduces_to_union_sums_and_named_gaps():
    from types import SimpleNamespace
    ms = 1_000_000
    events = [
        _Event("bench.window", 0, 100 * ms),
        _Event("bench.call", 10 * ms, 60 * ms),
        _Event("aten::copy_", 12 * ms, 20 * ms),
        _Event("cudaLaunchKernel", 30 * ms, 31 * ms),
        _Event("aten::other_thread", 40 * ms, 90 * ms, tid=2),
        _Event("bench.window", 0, 100 * ms, cuda=True, note=True),
        _Event("Memcpy HtoD (Pinned -> Device)", 14 * ms, 24 * ms, cuda=True),
        _Event("void k1<1>(int const*, int)", 20 * ms, 30 * ms, cuda=True),
        _Event("void k1<1>(int const*, int)", 50 * ms, 52 * ms, cuda=True),
        _Event("Memset (Device)", 95 * ms, 105 * ms, cuda=True),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    s = tracing.summarize(prof)
    assert s.window_s == pytest.approx(0.1)
    # [14, 30) + [50, 52) + [95, 100): 23 ms, not the 27 ms of a sum
    assert s.busy_s == pytest.approx(0.023)
    assert (s.kernels, s.kernel_s, s.h2d_s) == (2, pytest.approx(0.012),
                                                pytest.approx(0.010))
    assert s.device_ops[0] == ["k1<1>", pytest.approx(0.012)]
    gaps = dict(s.idle_gaps)
    # [0, 14): bench.window at 7; [30, 50): bench.call at 40;
    # [52, 95): bench.window at 73.5
    assert gaps == {"bench.window": pytest.approx(0.057),
                    "bench.call": pytest.approx(0.020)}
