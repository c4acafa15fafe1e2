"""The traced chunks: torch.profiler, read in memory.

`profile(fn)` runs fn under the profiler and returns its events: the
device's kernels and copies (not the ranges that `record_function`
labels project onto the device's timeline, which span the gaps between
their kernels), in microseconds, and the traced window's length on the
host's clock. On a card it records the device's activity alone, whose
cost to the host is small, so that the window's length and the busy share
read as an untraced chunk's would; with `host` it records the host's
operations too, which lengthens the chunk, and only the idle gaps by host
operation are read from such a trace. Nothing is written to disk. The
arithmetic below (the union of busy intervals, the name groups, the idle
gaps by host operation) is chip_smoke.py's, copied.
"""

from __future__ import annotations

import bisect
import dataclasses
import time


@dataclasses.dataclass
class Trace:
    device: list  # [(name, start_us, end_us)] kernels and copies
    host: list  # [(name, start_us, end_us)] host operations, where traced
    window_us: float  # the traced chunks' length on the host's clock

    @property
    def span_us(self) -> tuple:
        """(first start, last end) over every event."""
        starts = [e[1] for e in self.device] + [e[1] for e in self.host]
        ends = [e[2] for e in self.device] + [e[2] for e in self.host]
        return min(starts), max(ends)

    def kernels(self) -> list:
        return [e for e in self.device if not is_copy(e[0])]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def profile(fn, device, host=False):
    """(fn's result, Trace) with fn run under torch.profiler: on a card
    the CUDA activity, and the CPU's where `host` (off a card, the CPU's
    alone); the window's clock runs from fn's start to the device's
    synchronize after it."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    cuda = torch.device(device).type == "cuda"
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(device)
        window_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    labels = {ev.name for ev in events
              if getattr(ev, "is_user_annotation", False)}
    device, host_ops = [], []
    for ev in events:
        row = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False) \
                    and ev.name not in labels:
                device.append(row)
        elif host:
            host_ops.append(row)
    return out, Trace(device=device, host=host_ops, window_us=window_us)


def union(intervals) -> list:
    """The union of [start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(tr: Trace) -> float:
    """Microseconds in which a kernel or a copy ran on the device."""
    return sum(e - s for s, e in union((d[1], d[2]) for d in tr.device))


def group_of(name: str, groups) -> str:
    for g, patterns in groups:
        if any(p in name for p in patterns):
            return g
    return "glue"


def device_us_by_group(tr: Trace, groups) -> dict:
    out = {g: 0.0 for g, _ in groups}
    out["glue"] = 0.0
    for name, s, e in tr.device:
        g = group_of(name, groups)
        out[g] += e - s
    return out


def device_us_by_name(tr: Trace) -> dict:
    out = {}
    for name, s, e in tr.device:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def idle_gaps_us(tr: Trace) -> dict:
    """{host operation: microseconds}: each gap of the device's busy union
    between the trace's first and last event, charged to the innermost host operation
    running at its midpoint ("(host between operations)" where none runs)."""
    lo, hi = tr.span_us
    busy = union((d[1], d[2]) for d in tr.device)
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    host = sorted(tr.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    out = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        name = "(host between operations)"
        i = bisect.bisect_right(starts, mid) - 1
        for k in range(i, max(i - 5000, -1), -1):
            if host[k][2] >= mid:
                name = host[k][0]
                break
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def top(d: dict, n: int = 10) -> list:
    """[[name, seconds]] of the n largest microsecond sums."""
    return [[k[:160], v * 1e-6] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:n]]
