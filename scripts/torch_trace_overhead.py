#!/usr/bin/env python3
"""What the port's spans (``neuraludf_tpu_torch/utils/trace.py``) cost, on the card.

    python3 scripts/torch_trace_overhead.py [--cell dtu.stage1] [--seeds 1 2 3]
        [--pairs 4] [--out exp/trace_overhead.json]

1. ``span()`` (entered and left) and ``count()`` per call with tracing off
   and on (no profiler), from loops of a million calls on the host, beside
   the empty loop's time.
2. For each seed, a benchmark cell's set-up (``benchmark/harness/session``:
   the seeded start, the first window, a warm window), then ``--pairs``
   pairs of whole windows of ``Runner.train``, tracing off and on in turns
   (the order alternates from pair to pair), each ended by a synchronize:
   rays a second of each.

Prints one JSON line (also written to ``--out``) with the card's name and
power limit. Needs one CUDA card; imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

import torch  # noqa: E402

from harness import cells, session  # noqa: E402
from neuraludf_tpu_torch.utils import trace  # noqa: E402


def per_call_ns(n: int = 1_000_000) -> dict:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    out = {"empty_loop_ns": (time.perf_counter_ns() - t0) / n}
    for on in (False, True):
        (trace.enable if on else trace.disable)()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("overhead.probe"):
                pass
        t1 = time.perf_counter_ns()
        for _ in range(n):
            trace.count("overhead.probe")
        t2 = time.perf_counter_ns()
        out["on" if on else "off"] = {"span_ns": (t1 - t0) / n, "count_ns": (t2 - t1) / n}
    trace.disable()
    trace.reset()
    return out


def window_rate(runner, on: bool) -> float:
    (trace.enable if on else trace.disable)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session.train_windows(runner, 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    trace.disable()
    trace.reset()
    return session.WINDOW * runner.cfg.train.batch_size / dt


def card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": out.stdout.strip()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cell", default="dtu.stage1")
    p.add_argument("--seeds", type=int, nargs="+", default=[2**31 + 101, 2**31 + 102,
                                                              2**31 + 103])
    p.add_argument("--pairs", type=int, default=4)
    p.add_argument("--out", default="exp/trace_overhead.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    result = {"card": card(), "cell": args.cell, "torch": torch.__version__,
              "per_call_ns": per_call_ns(), "seeds": []}
    cell = cells.load_cell(args.cell)
    dev = torch.device("cuda:0")
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="udftrace-") as exp_dir:
            setup = session.build(cell, seed, dev, exp_dir)
            runner = setup.runner
            session.train_windows(runner, 1)
            rates = {"off": [], "on": []}
            for i in range(args.pairs):
                for on in ((False, True) if i % 2 == 0 else (True, False)):
                    rates["on" if on else "off"].append(window_rate(runner, on))
            row = {"seed": seed, "rays_per_s": rates,
                   "median_off": statistics.median(rates["off"]),
                   "median_on": statistics.median(rates["on"])}
            row["on_over_off"] = row["median_on"] / row["median_off"] - 1.0
            print(json.dumps(row), file=sys.stderr, flush=True)
            result["seeds"].append(row)
            del setup, runner
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
