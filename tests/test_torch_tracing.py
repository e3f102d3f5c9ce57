"""The port's spans and counters (jpegtpu_torch.tracing): self and root
time arithmetic, the off path, the profiler's view of a span, sessions,
threads, files unchanged with tracing on, and the spans and counters a
batch records."""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

import jpegtpu_torch
from jpegtpu_torch import EncodeConfig, _build, native, tracing

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

CPU = dict(device="cpu")
COLOR = EncodeConfig(subsampling="420")


def _sleep_ms(ms: float) -> None:
    end = time.perf_counter() + ms / 1e3
    while time.perf_counter() < end:
        pass


def _images(shapes, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]


def test_self_times_add_up_to_totals_and_root_time_to_the_outer_spans():
    with tracing.recording():
        for _ in range(2):
            with tracing.span("a"):
                _sleep_ms(2)
                with tracing.span("b"):
                    _sleep_ms(1)
                    with tracing.span("c"):
                        _sleep_ms(1)
        with tracing.span("d"):
            _sleep_ms(1)
    t = tracing.totals()
    s = t["spans"]
    assert {k: v["calls"] for k, v in s.items()} == {"a": 2, "b": 2, "c": 2,
                                                      "d": 1}
    # a span's total less its self time is its direct children's totals
    assert s["a"]["total_ns"] - s["a"]["self_ns"] == s["b"]["total_ns"]
    assert s["b"]["total_ns"] - s["b"]["self_ns"] == s["c"]["total_ns"]
    assert s["c"]["self_ns"] == s["c"]["total_ns"] >= 2e6
    assert s["a"]["self_ns"] >= 4e6
    # root time is the outer spans', and every nanosecond of it is some
    # span's self time
    assert t["root_ns"] == s["a"]["total_ns"] + s["d"]["total_ns"]
    assert sum(v["self_ns"] for v in s.values()) == t["root_ns"]


def test_exact_nesting_on_a_fake_clock(monkeypatch):
    """With a clock that ticks 10 ns a read, every span's self time is its
    total less its direct children's totals, and root_ns the outer
    spans' totals."""
    clock = iter(range(0, 10**6, 10))
    monkeypatch.setattr(tracing.time, "perf_counter_ns", lambda: next(clock))
    with tracing.recording():
        with tracing.span("outer"):          # t=0
            with tracing.span("mid"):        # t=10
                with tracing.span("leaf"):   # t=20 .. 30
                    pass
            with tracing.span("leaf"):       # t=50 .. 60
                pass
        with tracing.span("mid"):            # t=80 .. 90
            pass
    s = tracing.totals()["spans"]
    assert s["leaf"] == {"calls": 2, "total_ns": 20, "self_ns": 20}
    # the first mid: 10 .. 40 with a leaf of 10; the second: 80 .. 90
    assert s["mid"] == {"calls": 2, "total_ns": 40, "self_ns": 30}
    # outer: 0 .. 70, its children mid (30) and leaf (10)
    assert s["outer"] == {"calls": 1, "total_ns": 70, "self_ns": 30}
    assert tracing.totals()["root_ns"] == 70 + 10
    assert sum(v["self_ns"] for v in s.values()) == 70 + 10


def test_an_off_span_creates_no_record_function(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function created while tracing is off")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    with tracing.span("io.pad"):
        pass
    tracing.count("orch.rungs")
    files = jpegtpu_torch.encode_color_batch(
        _images([(24, 40, 3)], 1), COLOR, **CPU)
    assert files[0][:2] == b"\xff\xd8"
    # and under recording() with no profiler, none either
    with tracing.recording():
        with tracing.span("io.pad"):
            pass
    assert tracing.totals()["spans"]["io.pad"]["calls"] == 1


def test_a_span_under_a_cpu_profiler_is_in_its_events():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("io.stack"):
            with tracing.span("kernel.launch"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"io.stack", "kernel.launch"} <= names
    # the profiler turned the table on too
    t = tracing.totals()
    assert t["spans"]["io.stack"]["calls"] == 1
    assert t["root_ns"] == t["spans"]["io.stack"]["total_ns"]


def test_a_session_is_cleared_after_an_off_span():
    with tracing.recording():
        with tracing.span("a"):
            pass
        tracing.count("n", 3)
    assert tracing.totals()["counts"] == {"n": 3}
    with tracing.span("a"):  # off: the table stays as it was
        pass
    assert tracing.totals()["spans"]["a"]["calls"] == 1
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("b"):  # the first span on after an off one
            pass
        with tracing.span("b"):
            pass
    t = tracing.totals()
    assert set(t["spans"]) == {"b"} and t["counts"] == {}
    assert t["spans"]["b"]["calls"] == 2
    with tracing.recording():  # entering recording() clears too
        assert tracing.totals()["spans"] == {}


def test_threads_keep_their_own_stacks_and_lose_no_update():
    """More threads than cores, switching every microsecond: each
    thread's outer span has its own inner one as its only child, and no
    call or nanosecond is lost from the shared table."""
    n_threads, reps = (os.cpu_count() or 4) + 2, 200
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait(timeout=30)
        for _ in range(reps):
            with tracing.span(f"t{i % 2}.outer"):
                with tracing.span(f"t{i % 2}.inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording():
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    t = tracing.totals()
    s = t["spans"]
    for k in ("t0", "t1"):
        n = reps * len(range(int(k[1]), n_threads, 2))
        assert s[f"{k}.outer"]["calls"] == s[f"{k}.inner"]["calls"] == n
        assert (s[f"{k}.outer"]["total_ns"] - s[f"{k}.outer"]["self_ns"]
                == s[f"{k}.inner"]["total_ns"])
    assert t["root_ns"] == s["t0.outer"]["total_ns"] + s["t1.outer"]["total_ns"]
    assert sum(v["self_ns"] for v in s.values()) == t["root_ns"]


RAGGED = [(37, 53, 3), (37, 53, 3), (20, 30, 3), (9, 17, 3)]


@pytest.mark.parametrize("entry", ["encode_color_batch",
                                   "encode_grayscale_batch", "encode_color",
                                   "encode_stream_list"])
def test_files_are_the_same_with_tracing_on_and_off(entry):
    images = _images(RAGGED, 7)
    if entry == "encode_color_batch":
        def run():
            return jpegtpu_torch.encode_color_batch(images, COLOR, **CPU)
    elif entry == "encode_grayscale_batch":
        gray = [im[..., 0] for im in images]

        def run():
            return jpegtpu_torch.encode_grayscale_batch(gray, **CPU)
    elif entry == "encode_color":
        def run():
            return [jpegtpu_torch.encode_color(im, COLOR, **CPU)
                    for im in images[1:]]
    else:
        def run():
            return jpegtpu_torch.encode_stream_list(images, COLOR, color=True,
                                                    depth=2, **CPU)
    off = run()
    with tracing.recording():
        on = run()
    assert on == off
    assert tracing.totals()["root_ns"] > 0


BATCH_SPANS = {"entry.batch", "batch.group", "io.pad", "io.stack",
               "io.upload", "orch.tables", "orch.front", "orch.entropy",
               "orch.wait", "io.readback", "io.stuff", "io.jfif"}


def _stuff_counts(files) -> dict:
    """The native stuffer's tally for these files' single-segment scans:
    the 8-byte chunks of each unstuffed scan, and those with a 0xFF."""
    chunks = slow = 0
    for f in files:
        start = f.index(b"\xff\xda")
        start += 2 + int.from_bytes(f[start + 2:start + 4], "big")
        s = np.frombuffer(f[start:-2], np.uint8)
        raw = s[np.r_[True, ~((s[:-1] == 0xFF) & (s[1:] == 0))]]
        body = raw[:raw.size // 8 * 8].reshape(-1, 8)
        chunks += len(body)
        slow += int((body == 0xFF).any(axis=1).sum())
    if not (chunks and native.available()):
        return {}
    return {"io.stuff_chunks": chunks, "io.stuff_chunks_slow": slow}


def test_a_two_group_color_batch_records_its_spans_and_counters():
    images = _images([(37, 53, 3), (20, 30, 3), (37, 53, 3)], 3)
    with tracing.recording():
        files = jpegtpu_torch.encode_color_batch(images, COLOR, **CPU)
    t = tracing.totals()
    assert t["counts"] == {"batch.groups": 2, "orch.rungs": 2,
                           "io.chunks": 2, **_stuff_counts(files)}
    # kernel.launch is the card's: the plain versions launch nothing
    assert set(t["spans"]) == BATCH_SPANS
    assert t["spans"]["entry.batch"]["calls"] == 1
    assert all(t["spans"][n]["calls"] == 2 for n in BATCH_SPANS
               - {"entry.batch"})
    assert t["root_ns"] == t["spans"]["entry.batch"]["total_ns"]
    assert sum(v["self_ns"] for v in t["spans"].values()) == t["root_ns"]


def test_the_single_and_serving_entries_record_their_spans():
    images = _images([(37, 53, 3), (20, 30, 3)], 4)
    with tracing.recording():
        jpegtpu_torch.encode_color(images[0], COLOR, **CPU)
    assert set(tracing.totals()["spans"]) == {
        "entry.single", "io.pad", "io.stack", "io.upload", "orch.tables",
        "orch.front", "orch.entropy", "orch.wait", "io.readback", "io.stuff",
        "io.jfif"}
    with tracing.recording():
        jpegtpu_torch.encode_stream_list(images, COLOR, color=True, **CPU)
    t = tracing.totals()
    assert set(t["spans"]) == {
        "serve.submit", "serve.finish", "io.pad", "io.stack", "io.upload",
        "orch.tables", "orch.front", "orch.entropy", "orch.wait",
        "io.readback", "io.stuff", "io.jfif"}
    assert t["spans"]["serve.submit"]["calls"] == 2


def test_the_launch_counts_are_one_dict():
    assert _build.LAUNCHES is tracing.LAUNCHES
    assert "stitch_segments" in tracing.LAUNCHES
