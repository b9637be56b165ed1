"""The benchmark's command:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell once on one card and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted`` (the steps
of the measured window; in a campaign of S scans a step is an iteration of
every scan), ``failed`` (those of them that failed),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number compared beside its limit, which also end standard
error (in a campaign each number's worst scan, which ``readings`` names
under ``worst_scan``; where the window ran the runner's periodic actions,
the numbers of that crossing too, ``check.crossing_numbers``). With
``--trace 1`` a cell with a crossing runs the runner's periodic actions
once more after the traced windows, each action under a profiler of its
own (``profile_crossing``). Without a CUDA device, or
with fewer than the cell asks for, it exits with 2 and prints no result;
with JAX or the JAX package in ``sys.modules`` once the window has closed,
it exits with 3 and names them.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from . import cells, check, session, trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "neuraludf_tpu")
FD_REPS = 50  # warm launches a timing of the fused distance op averages


def forbidden_modules(names) -> List[str]:
    """The modules whose top-level name (before the first dot) is, whole,
    one of FORBIDDEN."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def process_start() -> float:
    """The wall-clock time this process started, from /proc."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])  # starttime, the 22nd field, in clock ticks after boot
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


class Context:
    """What the metric readers read: the measured window (``window``; the
    seconds from its start at which each runner window ended, ``ends``, and
    whether each ran the runner's periodic actions, ``crossed``), the trace,
    the profiled crossing (``crossing``, ``profile_crossing``'s; None where
    there is none), the cell's configuration and model (``models/<m>.py``);
    ``fd_op_ms`` times the fused distance op on its own once, at first
    use."""

    def __init__(self, cell, cfg, runner, window: Dict[str, float], setup_s: float,
                 peak_bytes: int, summary: Optional[trace_mod.TraceSummary],
                 profiled_steps: int, seed: int, model, ends: List[float],
                 crossed: List[bool], crossing: Optional[Dict[str, Dict[str, float]]] = None):
        self.cell, self.cfg, self.runner = cell, cfg, runner
        self.window, self.setup_s, self.peak_bytes = window, setup_s, peak_bytes
        self.trace, self.profiled_steps, self.seed = summary, profiled_steps, seed
        self.model, self.ends, self.crossed = model, ends, crossed
        self.crossing = crossing
        self._fd = None

    @property
    def step_s(self) -> float:
        """Seconds a step over the whole measured (unprofiled) window."""
        return self.window["seconds"] / self.window["steps"]

    def fd_op_ms(self) -> Dict[str, float]:
        """Milliseconds of one call of the port's op entry
        ``distance_value_feat_grad_fused`` (forward, K1) and of its autograd
        backward (K2), at the cell's rows, with the runner's parameters and
        tier, by CUDA events around a graph of FD_REPS warm calls."""
        if self._fd is None:
            from neuraludf_tpu_torch.ops import fused_distance as fd

            u = self.model.distance_cfg(self.cfg)
            rows = self.model.fd_rows(self.cfg)
            dev = self.runner.device
            gen = torch.Generator(device=dev).manual_seed(self.seed + 7)
            x = (torch.rand((rows, 3), generator=gen, device=dev) * 2.0 - 1.0) * 0.9
            params = {k: {n: t.detach().clone().requires_grad_(True) for n, t in v.items()}
                      for k, v in self.runner.params[self.model.DISTANCE_NET].items()}
            leaves = [t for v in params.values() for t in v.values()]
            cot = [torch.randn((rows, 1), generator=gen, device=dev),
                   torch.randn((rows, u.d_out - 1), generator=gen, device=dev),
                   torch.randn((rows, 3), generator=gen, device=dev)]

            def fwd():
                with torch.no_grad():
                    fd.distance_value_feat_grad_fused(params, x, u)

            side = torch.cuda.Stream(dev)  # the graphs' stream, and the forward's: its
            side.wait_stream(torch.cuda.current_stream(dev))  # backward runs there too
            with torch.cuda.stream(side):
                out = fd.distance_value_feat_grad_fused(params, x, u)

            def bwd():
                torch.autograd.grad(out, leaves, cot, retain_graph=True)

            self._fd = {"fwd": _event_ms(fwd, side), "bwd": _event_ms(bwd, side)}
            del out
        return self._fd


def _event_ms(fn, side, reps: int = FD_REPS) -> float:
    """Milliseconds a call of ``fn`` as the window runs it, inside a CUDA
    graph, with no host gap between launches: CUDA events around the replay
    of a graph of ``reps`` warm calls, captured on the stream ``side``."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def measure(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, cache=None) -> Dict[str, Any]:
    """The run (``session``'s module docstring) and its result object."""
    with tempfile.TemporaryDirectory(prefix="udfbench-") as exp_dir:
        setup = session.build(cell, seed, device, exp_dir,
                              cache=session.scene.CACHE if cache is None else cache)
        runner, periodic = setup.runner, setup.periodic
        on_card = device.type == "cuda"
        session.train_windows(runner, 1)  # warms Runner.train's host loop
        _sync(device)
        setup_s = time.time() - t_start - setup.reference_s  # the start's reference steps

        in_setup = len(periodic.events)
        before = session.launch_counts()
        first_iter = runner.iter_step + 1
        t0 = time.time()
        ends, crossed = [], []
        while True:
            seen = len(periodic.events)
            session.train_windows(runner, 1)
            ends.append(time.time() - t0)
            crossed.append(len(periodic.events) > seen)
            if ends[-1] >= seconds:
                break
        _sync(device)
        elapsed = time.time() - t0
        n = len(ends)
        print(f"set-up {setup_s:.3f} s; the start's reference steps {setup.reference_s:.3f} s",
              file=sys.stderr)
        print("window ends (s): " + " ".join(f"{e:.3f}" for e in ends), file=sys.stderr)
        after = session.launch_counts()
        steps = n * session.WINDOW
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        in_window = periodic.launched(in_setup)  # the periodic actions' renders and grids
        launched = {k: after[k] - before[k] - in_window[k] for k in after}
        rows = session.window_rows(runner, first_iter, runner.iter_step)
        n_scans = session.scans(cell.workload)
        why = session.failed_steps(rows, launched, setup.first["blending"], on_card, n_scans)
        why += crossing_faults(periodic, in_setup, cell.workload)
        timed_events = len(periodic.events)
        window = {"steps": steps, "seconds": elapsed,
                  "rays": steps * n_scans * setup.cfg.train.batch_size}

        summary, profiled, traced_s, crossing = None, 0, None, None
        if trace:
            summary, profiled, traced_s = profile(runner)
        if len(periodic.events) > timed_events:
            why.append(f"{periodic.windows(timed_events)} traced windows ran periodic actions")
        if trace and timed_events > in_setup:
            crossing = profile_crossing(runner, periodic.events[in_setup]["iter"],
                                        os.path.join(exp_dir, "profiled"), device)
        ctx = Context(cell, setup.cfg, runner, window, setup_s, peak, summary, profiled, seed,
                      setup.model, ends, crossed, crossing)
        wanted = cell.per_layer if trace else cell.end_to_end
        metrics = {}
        for m in wanted:
            value = cells.load_reader(m.name, cell.here).read(ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        del ctx
        failed = steps if why else 0

        firsts, scene_dirs, model = setup.firsts, setup.scene_dirs, setup.model
        port_sides = [session.program_side(f) for f in firsts]
        del setup, runner
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        session.tf32_off()
        refs = [session.reference_side(cell, f, d, device, exp_dir)
                for f, d in zip(firsts, scene_dirs)]
        made = crossing_readings(cell, model, periodic.events[in_setup:timed_events],
                                 scene_dirs[0], device, exp_dir)
    numbers, worst = check.compare_scans(port_sides, refs, model)
    numbers.update(made)
    limits = cell.workload["limits"]
    correct = check.judge(numbers, limits) and not why
    result = {"correct": bool(correct), "attempted": steps, "failed": failed,
              "metrics": metrics, "device": device_info(device, peak, summary, traced_s)}
    if trace and summary is not None and summary.n_device_ops:
        result["breakdown"] = {"device_ops": [[n_, s] for n_, s in summary.top_ops],
                               "idle_gaps": [[n_, s] for n_, s in summary.idle_gaps]}
    result["readings"] = {k: v for k, v in numbers.items() if k not in limits}
    if len(refs) > 1:
        result["readings"]["worst_scan"] = worst
    result["checks"] = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    if why:
        result["checks"]["failed_steps"] = {"value": failed, "limit": 0, "why": why}
    return result


def crossing_readings(cell, model, events, scene_dir, device, exp_dir: str) -> Dict[str, float]:
    """The numbers of the measured window's crossing
    (``check.crossing_numbers``; a cell holds one at most, ``session.build``);
    {} where it ran none."""
    if not events:
        return {}
    cfg = model.load_config(cell.conf_path, **session.overrides(exp_dir, str(scene_dir)))
    with session.exact_f32():
        return check.crossing_numbers(model, cfg, events[0], scene_dir, device)


def crossing_faults(periodic, in_setup: int, wl) -> List[str]:
    """What is wrong with the periodic actions of a run (``session.Periodic``)
    up to the measured window's end: any in set-up; in the measured window
    another number of runner windows with them than the workload's
    ``crossings``; an error the port logged in them. Each is printed."""
    for e in periodic.events:
        print(f"periodic actions at iteration {e['iter']}: {', '.join(e['hits'])}, "
              f"{e['seconds']:.3f} s, {e['errors']} errors", file=sys.stderr)
    why = []
    if in_setup:
        why.append(f"set-up ran periodic actions ({in_setup} calls)")
    n, want = periodic.windows(in_setup), session.crossings(wl)
    if n != want:
        why.append(f"{n} windows of the measured window ran periodic actions, not {want}")
    if periodic.errors():
        why.append(f"the periodic actions logged {periodic.errors()} errors")
    return why


def profile(runner):
    """PROFILE_WINDOWS windows of ``Runner.train`` under torch.profiler;
    returns (summary, steps profiled, seconds of the traced window)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        session.train_windows(runner, session.PROFILE_WINDOWS)
        torch.cuda.synchronize()
        traced_s = time.time() - t0
    summary = trace_mod.summarize(prof.events())
    return summary, session.PROFILE_WINDOWS * session.WINDOW, traced_s


def profile_crossing(runner, it: int, out_dir: str, device) -> Dict[str, Dict[str, float]]:
    """The runner's periodic actions once more, as at iteration ``it`` (the
    measured window's crossing; the state is the one after the traced
    windows), writing under ``out_dir``, each of its actions
    (``session.ACTIONS``) under a ``torch.profiler`` of its own: for each
    action that ran, its host seconds (synchronized at both ends), its
    device operations (``ops``) and its device seconds, the union of their
    intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    out: Dict[str, Dict[str, float]] = {}

    def profiled(name, method):
        def call(*args, **kwargs):
            _sync(device)
            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with torch_profile(activities=activities) as prof:
                t0 = time.time()
                result = method(*args, **kwargs)
                _sync(device)
                host_s = time.time() - t0
            ivs = [(e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            out[name] = {"host_s": host_s, "ops": len(ivs),
                         "device_s": trace_mod.union_length(ivs) / 1e6}
            return result

        return call

    saved = runner.iter_step, runner.base_exp_dir
    for name in session.ACTIONS:
        setattr(runner, name, profiled(name, getattr(runner, name)))
    runner.iter_step, runner.base_exp_dir = it, out_dir
    try:
        runner._periodic_actions(session.WINDOW)
    finally:
        runner.iter_step, runner.base_exp_dir = saved
        for name in session.ACTIONS:
            delattr(runner, name)  # the class's methods again
    return out


def device_info(device, peak: int, summary, traced_s) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
           "memory_peak_bytes": int(peak), "power_limit": power_limit()}
    if summary is not None:
        out["busy_s"] = summary.busy_us / 1e6
        out["window_s"] = traced_s
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = process_start() if t_start is None else t_start
    args = parse(argv)
    bench = cells.load_benchmark()
    cell = cells.load_cell(args.workload, bench)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                     t_start)
    return emit(result)


def emit(result: Dict[str, Any]) -> int:
    """Prints the checks to standard error and the result line last, unless
    JAX or the JAX package is loaded (then exits 3, with no result)."""
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in result.get("readings", {}).items():
        print(f"{name} {v!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
