"""The models the benchmark runs, each found by name.

A configuration names its model in its frozen ``.conf``, in a block of the
benchmark's own beside ``scene``::

    benchmark { model = <name> }

and ``models/<name>.py`` is that model's module. A configuration without
the block is NeuralUDF's (``DEFAULT``). The harness (``harness/session.py``,
``weights.py``, ``counts.py``, ``check.py``, ``faults.py``, ``calibrate.py``
and the metric readers) reaches a model only through its module, which
gives the names of ``INTERFACE``:

* the plain reference: ``load_config(path, **overrides)``, the reference's
  configuration; ``step_body(cfg, blending)``, its training step (f32);
  ``rounded(fwd, bwd)``, the context in which its products round to the
  control's types; ``distance_value(cfg, params, x)``, its distance
  network's value at points (``harness.meshes``); ``reference_image(cfg,
  params, scene_dir, view, level, calls, device)``, its render of the
  runner's validation image (``harness.images``), from the calls that
  ``render_draws(runner, gen)`` records while it hands the runner's
  renderer the benchmark's draws; ``init_adam(params)``, its optimizer state;
  ``load_scene(scene_dir, views, device, sources=0)``, its scene tensors;
  ``schedule_rows(cfg, start_iter, n, finetune=, reg_weights_schedule=,
  flags=)``, the schedule rows of iterations start_iter .. start_iter + n - 1;
* the inputs made from the seed: ``init_weights(cfg, seed, device)``,
  ``initial_trainability(cfg)``, ``make_draws(cfg, n_views_hw, k, seed,
  device)``;
* the comparison: ``TERMS`` (a number of ``harness.check`` -> the metric
  key of the step it reads) and ``DISTANCE_NET`` (the parameters' subtree
  of the distance network, whose layers K2 writes);
* the counts the readers read: ``distance_cfg(cfg)`` (the distance
  network's configuration, K1's and K2's), ``fd_rows(cfg)`` and
  ``step_flops(cfg)``;
* the faults' sites: ``FAULT_SITES`` (what ``harness.faults`` replaces, as
  (module, attribute path) of the port), and the witness,
  ``port_in_f32()`` with ``F32_OVERRIDES``.

So a model is added with new files alone: ``models/<m>.py`` and its
reference package, ``configs/<c>.conf`` naming it, ``workloads/<cell>.json``,
readers where it needs its own, and new entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
DEFAULT = "neuraludf"
INTERFACE = ("NAME", "load_config", "step_body", "rounded", "distance_value",
             "reference_image", "render_draws", "init_adam", "load_scene",
             "schedule_rows", "init_weights", "initial_trainability", "make_draws", "TERMS",
             "DISTANCE_NET", "distance_cfg", "fd_rows", "step_flops", "FAULT_SITES",
             "port_in_f32", "F32_OVERRIDES")
_BLOCK = re.compile(r"^\s*benchmark\s*\{([^}]*)\}", re.MULTILINE)
_MODEL = re.compile(r"\bmodel\s*[=:]\s*\"?([A-Za-z0-9_]+)\"?")
_LOADED: Dict[Path, ModuleType] = {}


def name_of(conf_path: Path) -> str:
    """The model a frozen configuration names (``benchmark { model = m }``),
    ``DEFAULT`` where it names none."""
    block = _BLOCK.search(Path(conf_path).read_text())
    found = _MODEL.search(block.group(1)) if block else None
    return found.group(1) if found else DEFAULT


def load(name: str, here: Path = HERE) -> ModuleType:
    """``models/<name>.py`` of the benchmark folder ``here``, loaded once;
    raises where it lacks a name of ``INTERFACE``."""
    if not re.fullmatch(r"[A-Za-z0-9_]{1,64}", name):
        raise ValueError(f"bad model name: {name!r}")
    path = (Path(here) / "models" / f"{name}.py").resolve()
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(f"bench_model_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        missing = [n for n in INTERFACE if not hasattr(module, n)]
        if missing:
            raise TypeError(f"{path} lacks {', '.join(missing)}")
        _LOADED[path] = module
    return _LOADED[path]


def for_cell(cell) -> ModuleType:
    """The model of a cell (``harness.cells.Cell``): the one its stage's
    configuration names."""
    return load(name_of(cell.conf_path), cell.here)
