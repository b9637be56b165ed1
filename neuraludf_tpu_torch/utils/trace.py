"""Program spans and counters, on ``torch.profiler``'s clock.

``span(name)`` marks a stretch of host work of one layer. While tracing is
off (the default) it returns one shared no-op object after a single flag
check. ``enable()`` turns tracing on (``cli.py --profile_dir`` does, for
the training it profiles); then a span enters
``torch.profiler.record_function(name)``, so that under an active profiler
it appears in the trace, nested in its parent, on the trace's own clock,
and it adds its host time to per-name aggregates: calls, total ns, self ns
(total less the time its child spans on the same thread cover), and the
shortest call's total ns (a call that waited on the device only lasts
longer, so a reader can tell the work from the wait).
``count(name, n)`` adds to a counter while tracing is on. ``snapshot()``
and ``reset()`` are for readers. Nothing is kept per call.

The names in use, and what reads them, are listed in ``PERF.md`` (section
3): ``runner.*`` in ``Runner.train``, ``window.*`` in ``TrainWindow``,
``step.*`` in the step body, ``op.*`` at the fused distance op and K3.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

import torch

_on = False
_lock = threading.Lock()
_spans: Dict[str, list] = {}  # name -> [calls, total ns, self ns, shortest ns]
_counts: Dict[str, int] = {}
_local = threading.local()  # .stack: the open spans of this thread


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "mark", "t0", "child_ns")

    def __init__(self, name: str):
        self.name, self.child_ns = name, 0

    def __enter__(self):
        self.mark = torch.profiler.record_function(self.name)
        self.mark.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += dt
        self.mark.__exit__(*exc)
        with _lock:
            agg = _spans.setdefault(self.name, [0, 0, 0, dt])
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - self.child_ns
            agg[3] = min(agg[3], dt)
        return False


def span(name: str):
    """A context manager around one layer's work (module docstring)."""
    if not _on:
        return OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter ``name`` while tracing is on."""
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def snapshot() -> Dict[str, dict]:
    """{"spans": {name: {"calls", "total_ns", "self_ns", "min_ns"}},
    "counts": {name: n}}."""
    with _lock:
        return {"spans": {k: {"calls": c, "total_ns": t, "self_ns": s, "min_ns": m}
                          for k, (c, t, s, m) in _spans.items()},
                "counts": dict(_counts)}


def reset() -> None:
    """Clears the aggregates and the counters."""
    with _lock:
        _spans.clear()
        _counts.clear()
