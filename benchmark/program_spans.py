"""The program's own spans and counters (`jpegtpu_torch.tracing`) in the
traced window, as the per-layer readers read them: sums of span self
times, per megapixel encoded or as a share of the time in root spans,
and counters.

A traced run turns the spans on through its profiler; the table they
fill holds the window alone (the untraced warm call before it ends the
previous session). Readers find nothing, and return None, where the
program has no recorder, where the run has no device trace beside the
spans (a run with no card, whose host times are the plain versions'),
or where no root span was recorded."""
from __future__ import annotations


def totals():
    """jpegtpu_torch.tracing.totals(), or None for a program without it."""
    try:
        from jpegtpu_torch import tracing
    except ImportError:
        return None
    return tracing.totals()


def recorded(run):
    """The window's totals, or None where there is nothing to read."""
    if run.trace is None or not run.window.pixels:
        return None
    t = totals()
    if t is None or not t["root_ns"]:
        return None
    return t


def self_ns(t: dict, names) -> int:
    """Summed self time of the named spans (0 for one never recorded)."""
    return sum(t["spans"].get(n, {}).get("self_ns", 0) for n in names)


def read_ms_per_mpix(run, names):
    """A reader's whole work for a self-time metric: the named spans'
    self time per megapixel encoded, in ms, or None."""
    t = recorded(run)
    if t is None:
        return None
    return self_ns(t, names) / 1e6 / (run.window.pixels / 1e6)
