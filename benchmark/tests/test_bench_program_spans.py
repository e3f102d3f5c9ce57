"""The readers of the program's spans and counters (program_spans.py and
the eight metrics that use it): their arithmetic on a hand-made table,
and all eight on the spans of a real traced window of the port's CPU
path."""
from __future__ import annotations

import dataclasses
import json
import os

import pytest

from conftest import REPO

from benchmark import harness, program_spans
from benchmark.harness import Run, Window
from benchmark.manifest import Bench
from benchmark.run import run_cell
from benchmark.trace import Summary

NEW = {"host_pad_stack_ms_per_mpix", "host_copy_ms_per_mpix",
       "host_stuff_ms_per_mpix", "host_jfif_ms_per_mpix",
       "host_enqueue_ms_per_mpix", "host_wait_ms_per_mpix",
       "host_unattributed_pct", "rungs_per_group"}
CELLS = [w["name"] for w in json.load(
    open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]
A_TRACE = Summary(window_s=1.0, busy_s=0.5, kernel_s=0.1, kernels=1,
                  h2d_s=0.1, device_ops=[], idle_gaps=[])


def _span(self_ms: float, total_ms: float | None = None) -> dict:
    return {"calls": 1, "self_ns": int(self_ms * 1e6),
            "total_ns": int((total_ms or self_ms) * 1e6)}


TABLE = {
    "spans": {
        "entry.batch": _span(2, 100), "batch.group": _span(3, 98),
        "io.pad": _span(10), "io.stack": _span(20), "io.upload": _span(15),
        "io.readback": _span(5), "io.stuff": _span(4), "io.jfif": _span(6),
        "orch.front": _span(7), "orch.entropy": _span(8, 9),
        "kernel.launch": _span(1), "orch.tables": _span(2),
        "orch.wait": _span(17)},
    "counts": {"batch.groups": 4, "orch.rungs": 5},
    "root_ns": 100_000_000,
}


def _run(pixels: int, trace=A_TRACE) -> Run:
    return Run(setup_s=1.0, window=Window(pixels=pixels), trace=trace,
               least_bytes=0, peaks={})


@pytest.mark.parametrize("metric, want", [
    ("host_pad_stack_ms_per_mpix", 15.0),
    ("host_copy_ms_per_mpix", 10.0),
    ("host_stuff_ms_per_mpix", 2.0),
    ("host_jfif_ms_per_mpix", 3.0),
    ("host_enqueue_ms_per_mpix", 9.0),
    ("host_wait_ms_per_mpix", 8.5),
    ("host_unattributed_pct", 5.0),
    ("rungs_per_group", 1.25),
])
def test_the_readers_arithmetic(monkeypatch, metric, want):
    """Self times over a 2 MPix window; the entry and group spans' own
    5 ms of 100 ms in root spans; 5 rungs over 4 groups."""
    monkeypatch.setattr(program_spans, "totals", lambda: TABLE)
    reader = Bench(REPO).reader(metric)
    assert reader.read(_run(2_000_000)) == pytest.approx(want)
    # nothing to read: no device trace, no pixels, no root span
    assert reader.read(_run(2_000_000, trace=None)) is None
    assert reader.read(_run(0)) is None
    monkeypatch.setattr(program_spans, "totals",
                        lambda: {**TABLE, "root_ns": 0})
    assert reader.read(_run(2_000_000)) is None
    monkeypatch.setattr(program_spans, "totals", lambda: None)
    assert reader.read(_run(2_000_000)) is None


def test_a_program_without_the_recorder_gives_none(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_tracing(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "jpegtpu_torch" and fromlist and "tracing" in fromlist:
            raise ImportError("no jpegtpu_torch.tracing")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracing)
    assert program_spans.totals() is None
    for metric in NEW:
        assert Bench(REPO).reader(metric).read(_run(1_000_000)) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_window_reads_all_eight(tiny, monkeypatch, cell):
    """A traced run of the tiny cell on the CPU: its line holds no
    program metric (there is no device trace beside the spans), and the
    same readers, given the run with a device trace, read a number from
    each span and counter of the window."""
    runs = []

    @dataclasses.dataclass
    class Kept(Run):
        def __post_init__(self):
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    result = run_cell(tiny, cell, 2**32 + 11, 0.2, True, "cpu")
    assert result["correct"] and not NEW & set(result["metrics"])
    (run,) = runs
    assert run.trace is None and run.window.pixels > 0
    t = program_spans.totals()
    assert t["root_ns"] > 0 and t["counts"]["batch.groups"] > 0
    assert set(t["spans"]) >= {"entry.batch", "batch.group", "io.pad",
                               "io.stack", "io.upload", "io.readback",
                               "io.stuff", "io.jfif", "orch.front",
                               "orch.entropy", "orch.tables", "orch.wait"}
    with_trace = dataclasses.replace(run, trace=A_TRACE)
    values = {m: tiny.reader(m).read(with_trace) for m in NEW}
    assert all(isinstance(v, float) and v >= 0 for v in values.values()), \
        values
    assert values["rungs_per_group"] == 1.0
    assert values["host_unattributed_pct"] < 100
