"""The frames-on-the-card cell (video_1080p_420.batch64_on_card): its two
readers' arithmetic, what they return with nothing to read, and a whole
tiny run on the port's CPU path, which passes CPU tensors."""
from __future__ import annotations

import dataclasses

import pytest

from conftest import REPO

from benchmark import harness, program_spans
from benchmark.harness import Run, Window
from benchmark.manifest import Bench
from benchmark.run import run_cell
from benchmark.trace import Summary

CELL = "video_1080p_420.batch64_on_card"
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def _trace(device_ops) -> Summary:
    return Summary(window_s=1.0, busy_s=0.5, kernel_s=0.1, kernels=1,
                   h2d_s=0.0, device_ops=device_ops, idle_gaps=[])


def _run(pixels: int, trace, peaks=PEAKS) -> Run:
    return Run(setup_s=1.0, window=Window(pixels=pixels), trace=trace,
               least_bytes=0, peaks=peaks)


def test_stage_roofline_reads_k13s_share_of_its_bytes():
    """6.7e9 least bytes (2 x 3 bytes a pixel, 1,116.67 MPix) over 3.35
    TB/s is 2 ms; K13 ran 4 ms in two entries of the trace."""
    reader = Bench(REPO).reader("stage_roofline_pct")
    assert reader.least_bytes(1_000_000) == 6_000_000
    pixels = 6_700_000_000 // 6
    ops = [["(anonymous namespace)::stage_images_kernel<3>", 0.003],
           ["(anonymous namespace)::transform_kernel<1>", 0.5],
           ["(anonymous namespace)::stage_images_kernel<1>", 0.001]]
    assert reader.read(_run(pixels, _trace(ops))) == pytest.approx(
        50.0, rel=1e-6)
    # nothing to read: no K13 entry, no trace, no peak, no pixels
    assert reader.read(_run(pixels, _trace(ops[1:2]))) is None
    assert reader.read(_run(pixels, None)) is None
    assert reader.read(_run(pixels, _trace(ops), peaks={})) is None
    assert reader.read(_run(0, _trace(ops))) is None


def _span(self_ms: float) -> dict:
    return {"calls": 1, "self_ns": int(self_ms * 1e6),
            "total_ns": int(self_ms * 1e6)}


def test_host_on_card_reads_the_spans_self_time(monkeypatch):
    table = {"spans": {"entry.batch": _span(90), "io.on_card": _span(3)},
             "counts": {"io.on_card_images": 64}, "root_ns": 93_000_000}
    monkeypatch.setattr(program_spans, "totals", lambda: table)
    reader = Bench(REPO).reader("host_on_card_ms_per_mpix")
    assert reader.read(_run(2_000_000, _trace([]))) == pytest.approx(1.5)
    assert reader.read(_run(2_000_000, None)) is None
    # a program that records no io.on_card (the parent's) reads nothing
    monkeypatch.setattr(program_spans, "totals", lambda: {
        **table, "spans": {"entry.batch": _span(90)}})
    assert reader.read(_run(2_000_000, _trace([]))) is None
    monkeypatch.setattr(program_spans, "totals", lambda: None)
    assert reader.read(_run(2_000_000, _trace([]))) is None


def test_a_tiny_run_of_the_cell_is_correct_and_takes_the_card_route(
        tiny, monkeypatch):
    """On the CPU the driver hands CPU tensors (planar frames, permuted)
    to a CPU encode: the on-card route with K13's twin, and the files
    pass the reference. Traced, the spans hold io.on_card and no host
    staging, and the reader reads them once the run has a device trace.
    The seed is test_bench_control's: at this size (2,304 levels a frame)
    one float32 rounding tie reads 434 ppm, so seeds differ in whether a
    sampled frame holds one, on either input route."""
    result = run_cell(tiny, CELL, 2**32 + 9, 0.2, False, "cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 3
    assert set(result["metrics"]) == {"throughput_mpix_s", "setup_s"}
    runs = []

    @dataclasses.dataclass
    class Kept(Run):
        def __post_init__(self):
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    traced = run_cell(tiny, CELL, 2**32 + 9, 0.2, True, "cpu")
    assert traced["correct"] and traced["metrics"] == {}
    t = program_spans.totals()
    assert t["counts"]["io.on_card_images"] == runs[0].window.attempted
    assert "io.on_card" in t["spans"]
    assert not {"io.pad", "io.stack", "io.upload"} & set(t["spans"])
    value = tiny.reader("host_on_card_ms_per_mpix").read(
        dataclasses.replace(runs[0], trace=_trace([])))
    assert isinstance(value, float) and value > 0
