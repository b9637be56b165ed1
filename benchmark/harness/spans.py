"""Per-layer numbers from the port's own spans and counters
(``neuraludf_tpu_torch/utils/trace.py``), for the readers of the runner,
the training window, the renderer and nets, and K3.

It runs once per traced run, at the first reader that asks, after the
readers of the harness's own trace (``trace.py``) have read:

* (A) tracing on, one window of ``Runner.train`` with no profiler: the
  spans' host aggregates and the window's counters;
* (B) tracing on, under ``torch.profiler`` (CPU and CUDA): one window of
  ``Runner.train``, then EAGER_STEPS iterations through ``Runner.train``,
  which a window that short runs eagerly (``Runner._train_window``), so
  that the step's spans hold their kernels. Tracing is off after it.

Host numbers are read only from windows that replayed every unit: none
eager, no capture (the counters ``window.replays``, ``window.eager_units``,
``window.captures``). Where the host runs ahead of the device, a call that
launches work blocks until the device's queue has room, so a span's total
holds the device's time too; the host's own work in a span that repeats is
its shortest call times its calls (the window's first units launch into the
queue the previous window's fetch emptied). On a program without the span
module every reader finds nothing and returns None.

Attribution, both on the profiler's clock:

* an idle stretch of (B)'s window (the host span of its ``runner.window``,
  less the union of the device operations in it) is the device's own
  (QUEUED) where the operation that ends it had been launched before the
  stretch began (its runtime call had returned), or shares its launch (the
  correlation id) with the operation before it, as the kernels of one
  replayed graph do: the device had the work and did not run it, whatever
  the host was doing. Any other stretch waits on the
  host, and goes to the innermost program span on the main thread through
  its middle, the rule ``trace.py`` names idle gaps by, or to PROFILER
  where the profiler's own buffer request holds that middle;
* an operation belongs to the window whose span holds its launch (on the
  spans' clock; the device's clock may lie milliseconds off it), and an
  eager device operation goes to the innermost span, on the thread that
  launched it, that holds its launch: the launch is the CUDA runtime call of
  the same correlation, its thread that of the host op the profiler links
  it to. Where that thread has no span there, it goes to the main thread's
  innermost span at the launch time.
"""

from __future__ import annotations

import bisect
import gc
import importlib
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import session
from .trace import union_length

EAGER_STEPS = 3  # iterations of (B) that run eagerly; fewer than a window
PREFIXES = ("runner.", "window.", "step.", "op.")  # the port's span names
NO_SPAN = "(no span)"
QUEUED = "(queued)"  # idle with its next operation already launched: the device's own
PROFILER = "(profiler)"  # idle while the host served the profiler's buffers
BUFFER_REQUEST = "Activity Buffer Request"  # CUPTI's overhead record of that
SMALL_GAP_US = 10.0  # idle stretches below this are printed apart


def is_span(name: str) -> bool:
    return name.startswith(PREFIXES)


class SpanIndex:
    """The program spans of each thread, for the innermost one at a time.
    Spans of a thread nest, so among those that hold t the innermost is the
    one that started last (of two that start together, the shorter)."""

    def __init__(self, spans: Dict[int, Sequence[Tuple[float, float, str]]]):
        self._by = {}
        for thread, items in spans.items():
            items = sorted(items, key=lambda x: (x[0], -x[1]))
            self._by[thread] = ([s for s, _, _ in items], items)

    def at(self, thread, t: float) -> Optional[str]:
        starts, items = self._by.get(thread, ((), ()))
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            s, e, name = items[i]
            if e >= t:
                return name
        return None


Op = Tuple[float, float, Optional[float], Optional[int]]  # start, end, ready, correlation


def idle_pieces(ops: Sequence[Op], lo: float, hi: float) -> List[Tuple[float, float, bool]]:
    """The stretches of [lo, hi] that no operation covers, each with whether
    it is the device's own (module docstring): the operation that ends it
    was ready (its launch had returned) when it began, or shares its
    correlation with the operation that began it. None is unknown."""
    out, at, before = [], lo, None
    for s, e, ready, corr in sorted(ops, key=lambda op: op[:2]):
        if s > at:
            own = (ready is not None and ready <= at) or (corr is not None and corr == before)
            out.append((at, min(s, hi), own))
        if e > at:
            at, before = e, corr
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi, False))
    return [p for p in out if p[1] > p[0]]


def attribute_idle(ops: Sequence[Op], lo: float, hi: float, index: SpanIndex,
                   main) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Idle microseconds of [lo, hi] by QUEUED or the innermost span on
    ``main`` through each stretch's middle (module docstring): (all
    stretches, those under SMALL_GAP_US)."""
    every, small = {}, {}
    for s, e, own in idle_pieces(ops, lo, hi):
        if own:
            name = QUEUED
        else:
            name = index.at(main, 0.5 * (s + e)) or NO_SPAN
        every[name] = every.get(name, 0.0) + (e - s)
        if e - s < SMALL_GAP_US:
            small[name] = small.get(name, 0.0) + (e - s)
    return every, small


def attribute_ops(ops, index: SpanIndex, main) -> Tuple[Dict[str, float], Dict[str, int]]:
    """``ops`` are (start, end, launching thread, launch time); returns the
    device microseconds and the operations by span (module docstring)."""
    us, n = {}, {}
    for s, e, thread, t in ops:
        name = index.at(thread, t) if thread is not None else None
        if name is None:
            name = index.at(main, t) or NO_SPAN
        us[name] = us.get(name, 0.0) + (e - s)
        n[name] = n.get(name, 0) + 1
    return us, n


# ----------------------------------------------------------------------------
# the profiler's events
# ----------------------------------------------------------------------------

@dataclass
class Events:
    device: List[Tuple[float, float, int, int]] = field(default_factory=list)  # s, e, corr, link
    spans: Dict[int, List[Tuple[float, float, str]]] = field(default_factory=dict)
    ops: Dict[int, Tuple[float, int]] = field(default_factory=dict)  # corr -> start, thread
    launches: Dict[int, Tuple[float, float, int]] = field(default_factory=dict)  # corr -> start, end, thread
    overhead: Dict[int, List[Tuple[float, float, str]]] = field(default_factory=dict)  # PROFILER


def events_of(prof) -> Events:
    """The profiler's raw events, in microseconds: device operations (not
    the device-side ranges of program spans, which carry the span's name),
    program spans by thread, host ops and runtime launch calls by
    correlation id (a graph's kernels share its launch's), and the
    profiler's buffer requests by thread."""
    from torch.autograd import DeviceType

    out = Events()
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        kind = ev.activity_type() if hasattr(ev, "activity_type") else ""
        s = ev.start_ns() / 1e3
        e = s + ev.duration_ns() / 1e3
        if ev.device_type() == DeviceType.CUDA:
            if kind != "gpu_user_annotation" and not is_span(name):
                out.device.append((s, e, ev.correlation_id(), ev.linked_correlation_id()))
            continue
        thread = ev.start_thread_id()
        # a torch without ``activity_type`` (2.11) names its runtime calls cu*
        if kind in ("cuda_runtime", "cuda_driver") or (not kind and name.startswith("cu")):
            out.launches[ev.correlation_id()] = (s, e, thread)
            continue
        if name == BUFFER_REQUEST:
            out.overhead.setdefault(thread, []).append((s, e, PROFILER))
            continue
        if is_span(name):
            out.spans.setdefault(thread, []).append((s, e, name))
        if ev.linked_correlation_id() == 0:
            out.ops[ev.correlation_id()] = (s, thread)
    return out


def launch_of(ev: Events, corr: int, link: int, fallback: float):
    """(thread, time) of a device operation's launch: the runtime call of its
    correlation, on the thread of the host op it is linked to."""
    op = ev.ops.get(link) if link else None
    call = ev.launches.get(corr)
    thread = op[1] if op is not None else (call[2] if call is not None else None)
    t = call[0] if call is not None else (op[0] if op is not None else fallback)
    return thread, t


# ----------------------------------------------------------------------------
# the runs
# ----------------------------------------------------------------------------

@dataclass
class Reading:
    steps_a: int = 0
    host: Optional[Dict[str, Dict[str, float]]] = None  # (A): name -> calls, total_ns, self_ns
    window_us: float = 0.0  # (B)'s runner.window
    idle_us: Optional[Dict[str, float]] = None  # (B)'s idle by span, or QUEUED
    eager_steps: int = 0
    eager_us: Optional[Dict[str, float]] = None  # device us of the eager steps by span
    eager_ops: int = 0
    replay_busy_us: float = 0.0  # the union of (B)'s window's device operations
    steps_b: int = 0
    notes: Dict[str, object] = field(default_factory=dict)


def _replayed_only(counts: Dict[str, int]) -> bool:
    return (counts.get("window.replays", 0) > 0 and not counts.get("window.eager_units")
            and not counts.get("window.captures"))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(runner) -> Optional[Reading]:
    """(A) and (B) on ``runner`` (module docstring); None on a program
    without the span module."""
    try:
        port = importlib.import_module("neuraludf_tpu_torch.utils.trace")
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile

    dev = runner.device
    out = Reading()
    t0 = time.time()
    gc.collect()  # the trace the readers before read leaves garbage behind
    port.reset()
    port.enable()
    try:
        first = runner.iter_step
        session.train_windows(runner, 1)
        _sync(dev)
        out.steps_a = runner.iter_step - first
        snap = port.snapshot()
        if _replayed_only(snap["counts"]):
            out.host = snap["spans"]
        out.notes["counts_a"] = snap["counts"]

        port.reset()
        gc.collect()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            first = runner.iter_step
            session.train_windows(runner, 1)
            out.steps_b = runner.iter_step - first
            runner.end_iter = runner.iter_step + EAGER_STEPS
            runner.train()
            _sync(dev)
        counts_b = port.snapshot()["counts"]
    finally:
        port.disable()
        port.reset()
    out.notes["counts_b"] = counts_b
    ev = events_of(prof)
    del prof
    _read_trace(out, ev, replayed=_replayed_only(counts_b))
    out.notes["seconds"] = time.time() - t0
    return out


def _read_trace(out: Reading, ev: Events, replayed: bool) -> None:
    windows = [(s, e, t) for t, items in ev.spans.items() for s, e, name in items
               if name == "runner.window"]
    windows.sort()
    if len(windows) != 2 or windows[0][2] != windows[1][2]:
        out.notes["windows"] = len(windows)
        return
    (w0, w1, main), (e0, e1, _) = windows
    index = SpanIndex(ev.spans)
    idle_index = SpanIndex({t: ev.spans.get(t, []) + ev.overhead.get(t, [])
                            for t in set(ev.spans) | set(ev.overhead)})
    # an operation belongs to the window that launched it: the launch is on the
    # spans' own clock, while the device's may lie some milliseconds off it
    ops = [(s, e, c, l) + launch_of(ev, c, l, s) for s, e, c, l in ev.device]
    in_window = [(s, e, ev.launches[c][1] if c in ev.launches else None, c)
                 for s, e, c, _, _, t in ops if w0 <= t <= w1]
    if replayed and in_window:
        out.window_us = w1 - w0
        out.replay_busy_us = union_length([op[:2] for op in in_window])
        out.idle_us, small = attribute_idle(in_window, w0, w1, idle_index, main)
        out.notes["idle_under_10us"] = small
        out.notes["window_ops_with_launch_call"] = [
            sum(1 for op in in_window if op[2] is not None), len(in_window)]
        out.notes["idle_ms_by_replay"] = _idle_by_replay(ev, in_window, w0, w1, main)
    picked = [op for op in ops if e0 <= op[5] <= e1]
    eager = [(s, e, thread, t) for s, e, _, _, thread, t in picked]
    steps = sum(1 for s, e, name in ev.spans.get(main, ()) if name == "step.adam"
                and e0 <= s <= e1)
    if eager and steps == EAGER_STEPS:
        out.eager_steps = steps
        out.eager_us, n = attribute_ops(eager, index, main)
        out.eager_ops = len(eager)
        out.notes["eager_ops_by_span"] = n
        out.notes["eager_linked_to_op"] = sum(1 for op in picked if op[3] in ev.ops)
        out.notes["eager_with_launch_call"] = sum(1 for op in picked if op[2] in ev.launches)


def _idle_by_replay(ev: Events, intervals, lo: float, hi: float, main) -> List[float]:
    """The idle milliseconds inside each ``window.replay`` of [lo, hi], in
    order: where in the window the idle lies."""
    pieces = idle_pieces(intervals, lo, hi)
    starts = [p[0] for p in pieces]
    out = []
    for s0, e0, name in sorted(ev.spans.get(main, ())):
        if name != "window.replay" or not lo <= s0 <= hi:
            continue
        idle = 0.0
        for s, e, _ in pieces[max(bisect.bisect_right(starts, s0) - 1, 0):]:
            if s >= e0:
                break
            idle += max(0.0, min(e, e0) - max(s, s0))
        out.append(round(idle / 1e3, 3))
    return out


def measured(ctx) -> Optional[Reading]:
    """(A) and (B) once a run, kept on the readers' context."""
    if not hasattr(ctx, "port_spans"):
        ctx.port_spans = run(ctx.runner)
        if ctx.port_spans is not None:
            report(ctx.port_spans)
    return ctx.port_spans


def report(r: Reading) -> None:
    """The attribution in full, to standard error."""
    def ms(d, n):
        return {k: round(v / 1e3 / n, 6) for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    lines = {"steps": [r.steps_a, r.steps_b, r.eager_steps], "notes": r.notes}
    if r.host is not None:  # total, self, shortest call × calls; calls
        lines["host_ms_a_step"] = {k: [round(v[key] / 1e6 / r.steps_a, 6)
                                       for key in ("total_ns", "self_ns", "work_ns")]
                                   + [v["calls"]] for k, v in _with_work(r.host).items()}
    if r.idle_us is not None:
        lines["window_ms"] = r.window_us / 1e3
        lines["replay_busy_ms_a_step"] = r.replay_busy_us / 1e3 / r.steps_b
        lines["idle_ms_a_step"] = ms(r.idle_us, r.steps_b)
    if r.eager_us is not None:
        lines["eager_device_ms_a_step"] = ms(r.eager_us, r.eager_steps)
        lines["eager_ops_a_step"] = r.eager_ops / r.eager_steps
    print("spans " + json.dumps(lines), file=sys.stderr)


# ----------------------------------------------------------------------------
# what the readers read
# ----------------------------------------------------------------------------

def _with_work(host: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """Each span's aggregates with ``work_ns``: its shortest call times its
    calls, the host's own time without the waits for the device's queue."""
    return {k: dict(v, work_ns=v["min_ns"] * v["calls"]) for k, v in host.items()}


def host_ms(ctx, names, part: str = "self") -> Optional[float]:
    """(A)'s host milliseconds a step in ``names``: their ``self`` or
    ``total`` time, or their ``work`` (``_with_work``)."""
    r = measured(ctx)
    if r is None or r.host is None or not r.steps_a:
        return None
    host = _with_work(r.host)
    return sum(host[n][part + "_ns"] for n in names if n in host) / 1e6 / r.steps_a


def idle_share(ctx, group: str) -> Optional[float]:
    """(B)'s idle put down to spans named ``<group>.*``, in % of its window."""
    r = measured(ctx)
    if r is None or r.idle_us is None or r.window_us <= 0:
        return None
    return 100.0 * sum(v for k, v in r.idle_us.items() if k.startswith(group + ".")) / r.window_us


def device_ms(ctx, names) -> Optional[float]:
    """The eager steps' device milliseconds a step put down to ``names``;
    None where none of them holds a device operation."""
    r = measured(ctx)
    if r is None or r.eager_us is None or not any(n in r.eager_us for n in names):
        return None
    return sum(r.eager_us.get(n, 0.0) for n in names) / 1e3 / r.eager_steps
