"""Spans and counters at the port's layer boundaries, and the kernel
launch counts.

    with tracing.span("io.pad"):
        ...
    tracing.count("orch.rungs")

A span is on while a `torch.profiler` session records, or inside
`recording()`; otherwise it is off. Off, it costs a flag check: it
creates no `record_function` and allocates nothing. On, it enters
`torch.profiler.record_function(name)` when a profiler records, so the
span sits in the same trace as the card's activity, on its clock; and it
adds its duration (`time.perf_counter_ns`) to a table by name: calls,
total nanoseconds and self nanoseconds (the total less its direct child
spans on the same thread). `root_ns` sums the spans that had no open
parent span on their thread. `count(name, n)` adds to a counter under the
same gate. `totals()` returns a snapshot of the three.

The table holds one recording session: the first span or count recorded
after one that was not, or after a `recording()` block, clears it, and so
does entering `recording()`. Nothing is kept per span instance and nothing is written to disk (the
profiler's trace holds the instances and their nesting).

Spans are named by stage and layer, not by function, so a stage reads the
same whichever entry runs it:

    entry.batch, entry.single    the entry points
    serve.submit, serve.finish   serving
    batch.group                  a shape group of a batch
    io.pad, io.stack, io.upload, io.on_card, io.readback, io.stuff,
    io.jfif                      host I/O (io.on_card: staging images
                                 that are already on the encode's device)
    orch.tables, orch.front, orch.entropy, orch.wait
                                 orchestration: tables, enqueue of the
                                 transform and of a rung's entropy chain,
                                 the host blocked on the card
    kernel.launch                one launch of a hand-written kernel

Counters: `batch.groups` (groups that run the group ladder),
`orch.rungs` (rungs those ladders ran), `io.chunks` and `io.chunk_waits`
(io.transfer's staging ring), `io.stuff_chunks` and `io.stuff_chunks_slow`
(8-byte chunks the native stuffer tested in io.stuff, and those that held
a 0xFF and went a byte at a time) and `io.on_card_images` (images staged
by io.on_card).

`LAUNCHES` counts every launch of the port's kernels, by kernel, whatever
the gate; `_build.launch` counts, and tests reset and read it.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

# Launches per kernel since the last reset, counted where each wrapper
# launches its kernel (and nowhere else).
LAUNCHES = {"transform": 0, "transform_rgb_y": 0, "transform_rgb_chroma": 0,
            "encode_blocks": 0, "pack_blocks": 0, "merge_mcu": 0,
            "merge_streams": 0, "merge_rows": 0, "stream_concat": 0, "stream_concat_chunked": 0,
            "stream_concat_rows": 0, "stitch_scan": 0, "stitch_segments": 0,
            "stage_images": 0}

_lock = threading.Lock()
_local = threading.local()
_forced = 0       # recording() blocks open
_fresh = True     # the next span or count recorded starts a session
_spans: dict = {}   # name -> [calls, total_ns, self_ns]
_counts: dict = {}  # name -> count
_root_ns = 0

if hasattr(_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _profiler._is_profiler_enabled
else:  # a torch without the Python-side flag: ask its C++ side
    _profiling = torch._C._autograd._profiler_enabled


def _begin() -> None:
    """Start a session: clear the table."""
    global _fresh, _root_ns
    with _lock:
        _spans.clear()
        _counts.clear()
        _root_ns = 0
    _fresh = False


class _Span:
    __slots__ = ("name", "rf", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _fresh:
            _begin()
        self.child_ns = 0
        # read before record_function, so that its cost is this span's
        self.t0 = time.perf_counter_ns()
        self.rf = None
        if _profiling():
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        global _root_ns
        stack = _local.stack
        stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        dt = time.perf_counter_ns() - self.t0
        if stack:
            stack[-1].child_ns += dt
        with _lock:
            row = _spans.get(self.name)
            if row is None:
                row = _spans[self.name] = [0, 0, 0]
            row[0] += 1
            row[1] += dt
            row[2] += dt - self.child_ns
            if not stack:
                _root_ns += dt
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` while tracing is on (see
    the module's docstring) and does nothing otherwise."""
    if _forced or _profiling():
        return _Span(name)
    global _fresh
    _fresh = True
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while tracing is on."""
    global _fresh
    if not (_forced or _profiling()):
        _fresh = True
        return
    if _fresh:
        _begin()
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Turn the spans and counters on for the block, without a profiler,
    from an empty table; read it with totals() during or after (the next
    span or count recorded after the block starts a new session)."""
    global _forced, _fresh
    _begin()
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1
            _fresh = not _forced


def totals() -> dict:
    """The session's table: {"spans": {name: {"calls", "total_ns",
    "self_ns"}}, "counts": {name: n}, "root_ns": time in root spans}."""
    with _lock:
        return {"spans": {name: {"calls": c, "total_ns": t, "self_ns": s}
                          for name, (c, t, s) in _spans.items()},
                "counts": dict(_counts), "root_ns": _root_ns}
