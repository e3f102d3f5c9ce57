"""Capacity rungs a batch group's ladder ran, per group (counters
orch.rungs over batch.groups): 1.0 when no group overflowed its first
rung."""
from benchmark.program_spans import recorded


def read(run):
    t = recorded(run)
    groups = t["counts"].get("batch.groups", 0) if t else 0
    return t["counts"].get("orch.rungs", 0) / groups if groups else None
