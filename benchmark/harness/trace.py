"""Reduction of a ``torch.profiler`` trace to the numbers the metrics read.

Device operations are the profiler's events on the device (kernels, and
the copies and fills the device runs), each an interval on the device's
clock. The device is busy where the union of those intervals covers the
time, never their sum, which counts twice what runs at once. The span runs
from the first device operation to the last; idle is the span less the
union. An idle gap is named by the host operation that was running on the
main thread through its middle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

Interval = Tuple[float, float]  # (start, end) in microseconds


def union_length(intervals: Sequence[Interval]) -> float:
    """The length of the union of ``intervals``."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def gaps(intervals: Sequence[Interval]) -> List[Interval]:
    """The stretches between the union's pieces, in time order."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


@dataclass
class TraceSummary:
    n_device_ops: int = 0
    busy_us: float = 0.0  # the union of the device intervals
    span_us: float = 0.0  # first device operation to the last
    top_ops: List[Tuple[str, float]] = field(default_factory=list)  # (name, seconds)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host op, seconds)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_us / self.span_us


def summarize(events, top: int = 10) -> TraceSummary:
    """``events`` are ``prof.events()`` of a profiler that recorded the CPU
    and the device."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name, e.thread))
    out = TraceSummary()
    if not dev:
        return out
    ivs = [(s, e) for s, e, _ in dev]
    out.n_device_ops = len(dev)
    out.busy_us = union_length(ivs)
    out.span_us = max(e for _, e in ivs) - min(s for s, _ in ivs)
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    out.top_ops = [(n, t / 1e6) for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    main = _main_thread(host)
    named = []
    for s, e in sorted(gaps(ivs), key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        inside = [h for h in host if h[3] == main and h[0] <= mid <= h[1]]
        name = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "(no host op)"
        named.append((name, (e - s) / 1e6))
    out.idle_gaps = named
    return out


def _main_thread(host) -> int:
    """The thread that ran the most host time."""
    per = {}
    for s, e, _, t in host:
        per[t] = per.get(t, 0.0) + (e - s)
    return max(per, key=per.get) if per else -1
