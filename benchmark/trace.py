"""The traced run: `torch.profiler` (CPU and CUDA activities) around the
window, reduced in memory to what the per-layer metrics and the
breakdown read. Nothing is written to disk.

The device's busy time is the union of its kernel, memcpy and memset
intervals inside the window (serving overlaps copies with kernels, so a
sum would count the overlap twice). An idle gap is named by the innermost
CPU-side event (a benchmark span, an aten op or a CUDA runtime call) open
on the window's thread at the gap's middle.
"""
from __future__ import annotations

import collections
import dataclasses

WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class Summary:
    window_s: float     # the traced window's length
    busy_s: float       # union of device intervals inside it
    kernel_s: float     # summed device time of every kernel
    kernels: int        # kernel launches
    h2d_s: float        # summed device time of host-to-device copies
    device_ops: list    # [[name, seconds]] by summed time, top 10
    idle_gaps: list     # [[host activity, idle seconds]], top 10


def union(intervals) -> list:
    """Merged [start, end) intervals of an iterable of (start, end)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(merged: list, lo: float, hi: float) -> list:
    """The parts of [lo, hi) that merged intervals leave uncovered."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


def name_gaps(cpu: list, spans: list) -> dict:
    """Idle seconds by the innermost of properly nested CPU events
    (start, end, key) open at each gap's middle, by key ("python" where
    none is open)."""
    mids = sorted(((s + e) / 2, e - s) for s, e in spans)
    by_name = collections.Counter()
    if not mids:
        return by_name
    stack, i = [], 0
    cpu.sort(key=lambda ev: (ev[0], -ev[1]))  # an outer event first
    cpu.append((float("inf"), 0, ""))
    m = mids[0][0]
    for start, end, name in cpu:
        while m < start:
            while stack and stack[-1][0] <= m:
                stack.pop()
            by_name[stack[-1][1] if stack else "python"] += mids[i][1]
            i += 1
            if i == len(mids):
                return by_name
            m = mids[i][0]
        while stack and stack[-1][0] <= start:
            stack.pop()
        stack.append((end, name))
    return by_name


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without "void " and its argument list, cut to
    `limit` characters (enough to hold PyTorch's functor names)."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:limit]


def summarize(prof) -> Summary:
    """Reduce a finished torch.profiler.profile whose events hold one
    WINDOW_SPAN. A device event is a kernel, a copy or a memset, unless it
    is the device side of a record_function span."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == WINDOW_SPAN)
    lo, hi = win.start_ns(), win.end_ns()
    tid = win.start_thread_id()
    dev, cpu, host = [], [], []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append(e)
        elif e.start_thread_id() == tid:
            s, t = e.start_ns(), e.end_ns()
            if t > lo and s < hi:
                cpu.append((s, t, len(host)))
                host.append(e)
    spans, op_time = [], collections.Counter()
    kernel_s = h2d_s = 0.0
    kernels = 0
    for e in dev:
        s, t = max(e.start_ns(), lo), min(e.end_ns(), hi)
        if t <= s:
            continue
        name = e.name()
        spans.append((s, t))
        op_time[name] += (t - s) / 1e9
        if name.startswith("Memcpy"):
            h2d_s += (t - s) / 1e9 if "HtoD" in name else 0.0
        elif not name.startswith("Memset"):
            kernel_s += (t - s) / 1e9
            kernels += 1
    merged = union(spans)
    busy = sum(e - s for s, e in merged) / 1e9
    idle = collections.Counter()
    for key, ns in name_gaps(cpu, gaps(merged, lo, hi)).items():
        idle[key if key == "python" else host[key].name()] += ns
    ops = collections.Counter()
    for name, sec in op_time.items():
        ops[short_name(name)] += sec
    top = lambda c: [[k, v] for k, v in c.most_common(10)]  # noqa: E731
    return Summary(window_s=(hi - lo) / 1e9, busy_s=busy, kernel_s=kernel_s,
                   kernels=kernels, h2d_s=h2d_s, device_ops=top(ops),
                   idle_gaps=top(collections.Counter(
                       {k: v / 1e9 for k, v in idle.items()})))


def profiler():
    """A profiler of CPU and CUDA activity, not yet entered."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
