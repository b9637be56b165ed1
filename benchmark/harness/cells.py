"""Finds a cell's files by name.

Everything that belongs to one cell, one configuration or one metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``workloads/<cell>.json``: the cell's traffic (its stage, the steps that
  set-up trains first, the steps the comparison follows) and the limits of
  the numbers that decide ``correct``;
* ``configs/<file>``: a frozen copy of a published ``.conf`` (HOCON), with
  a ``scene`` block that names the scene the cell trains on;
* ``metrics/<metric>.py``: a reader with ``read(ctx)`` that returns the
  metric's value, or None when it finds nothing to read.

Which metrics a cell reports is read from ``BENCHMARK.json``: every
end-to-end metric without a ``workloads`` key or that lists the cell, and
every per-layer metric that lists the cell, or, without a ``workloads`` key,
that moves an end-to-end metric the cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HERE.parent  # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_name(name: str, what: str = "name") -> str:
    """``name`` if it is a valid name (letters a-z and A-Z, digits, ``_``,
    ``.``, ``-``; at most 64, not starting with ``.`` or ``-``); else raises."""
    if not isinstance(name, str) or not NAME.match(name) or ".." in name:
        raise ValueError(f"bad {what}: {name!r}")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise ValueError(f"bad unit: {unit!r}")
    return unit


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    per_layer: bool


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    workload: Dict[str, Any]  # workloads/<cell>.json
    conf_path: Path  # the stage's frozen .conf
    end_to_end: List[Metric]
    per_layer: List[Metric]
    here: Path  # the benchmark's folder the files came from


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _metrics(entries, cell: str, per_layer: bool, reported_e2e=None) -> List[Metric]:
    out = []
    for m in entries:
        listed = m.get("workloads")
        if listed is not None:
            if cell not in listed:
                continue
        elif per_layer and m["moves"] not in reported_e2e:
            continue
        out.append(Metric(check_name(m["name"], "metric"), check_unit(m["unit"]), m["better"],
                          m["source"], per_layer))
    return out


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None, here: Path = HERE) -> Cell:
    """The cell ``name``: its entry in ``BENCHMARK.json`` and its files."""
    check_name(name, "workload")
    bench = load_benchmark(here.parent) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    with open(here / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: workloads/{name}.json names config {workload['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    conf = here / "configs" / check_name(workload["conf"], "conf file")
    if not conf.is_file():
        raise FileNotFoundError(conf)
    e2e = _metrics(bench["end_to_end"], name, False)
    per = _metrics(bench["per_layer"], name, True, {m.name for m in e2e})
    return Cell(name, check_name(entry["config"], "config"), workload, conf, e2e, per, here)


def load_reader(metric: str, here: Path = HERE) -> ModuleType:
    """``metrics/<metric>.py`` as a module; it defines ``read(ctx)``."""
    path = here / "metrics" / f"{check_name(metric, 'metric')}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise TypeError(f"{path} defines no read(ctx)")
    return module
