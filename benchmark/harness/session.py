"""One run of one cell: set-up, the measured window, the trace, the check.

Whatever belongs to the cell's model (the plain reference, the seeded
weights and draws, the schedule rows, the counts) comes from its module,
``models/<m>.py``, found by the name its configuration gives
(``models.for_cell``).

Set-up loads the frozen configuration through the port's ``config.load``,
writes the scene once (``scene.ensure_scene``), builds the port's
``Runner`` and hands it the start the benchmark made from the seed: in a
``stage1`` cell the seeded weights (the model's ``init_weights``) and a
zero Adam state, at iteration ``start_iter`` (the workload's; 0 unless
given: the schedules and the views start there, the state is the seeded
one all the same; ``fixed_init_seed`` draws every network from one
fixed seed, the same in every run, ``seeded_weights``); in
a ``finetune`` cell the state after ``setup_steps`` stage-1 iterations of
the plain reference from those weights (``reference_start``: parameters,
Adam state and the beta/variance trainability, on draws from the seed, in
``Runner.train``'s view order), which is what a finetune loads from its
stage-1 checkpoint. Those reference steps are the benchmark making its
input: they run before the port's set-up, in f32 with TF32 off, and count
neither in ``setup_s`` nor in the peak memory. The first window then
runs through the runner's own ``TrainWindow`` (its two eager warm-up steps,
the capture of its graph, and replays), fed with draws made from the seed,
and keeps what the reference follows (``check``). One more window through
``Runner.train`` warms the runner's host loop; set-up ends there.

The measured window runs whole windows of ``Runner.train`` (``end_iter``
advanced one window at a time) until ``seconds`` have passed, and is ended
by a synchronize. Every step of it must have launched K1 and K2 once (and
K3 once in a blending cell, with nonzero pixel and patch terms), and every
loss must be finite; a step that did not is a failed one. The runner's
periodic actions (a validation render, a checkpoint, the meshes, at
multiples of their frequencies) are watched (``Periodic``): the measured
window must hold exactly the workload's ``crossings`` runner windows that
run them (0 unless given), set-up and the traced windows none, and none
may log an error; their own launches of K1, K2 and K3 are not a step's.

With ``trace`` two more windows run under ``torch.profiler``, and the
per-layer readers read the trace, the measured window and, where they ask
for it, the fused distance op timed on its own (``Context.fd_op_ms``).

Once the window has closed and the peak memory is read, the port's state
is freed and the plain reference follows the first steps.

A workload whose file gives ``"scans": S`` (a ``stage1`` cell) is a
campaign: S scans trained as one graph by the port's ``MultiScanRunner``,
scan i as its ``Runner(seed + i)``, on the scene of the file's ``scenes[i]``
(the configuration's scene with that entry's keys, such as a ``radius``).
Scan i starts from ``init_weights(cfg, seed + i)`` with a zero Adam state,
draws from a stream of its own, and takes its views in the order of
RandomState(i), as the runner orders them. The first window runs through
the runner's own ``MultiScanWindow``; a step of the measured window is one
iteration of every scan, and failed where a scan's row is missing or its
loss is not finite, or where K1 or K2 did not launch S times. The reference
follows each scan on its own (``check.compare_scans``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import logging
import math
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import models
import reference.hocon as ref_hocon

from . import cells, check, images, meshes, scene

WINDOW = 50  # iterations a runner window holds (the runner's own choice, checked)
PROFILE_WINDOWS = 2  # runner windows under the profiler in a traced run


# ----------------------------------------------------------------------------
# configuration and inputs
# ----------------------------------------------------------------------------

def scene_spec(conf_path: Path) -> Dict[str, Any]:
    raw = ref_hocon.parse_file(str(conf_path))
    spec = dict(raw["scene"])
    for key in ("kind", "views", "height", "width", "focal"):
        if key not in spec:
            raise KeyError(f"{conf_path}: scene.{key} missing")
    return spec


def overrides(exp_dir: str, data_dir: str) -> Dict[str, Any]:
    """What a run sets beside the frozen file: where it writes and reads."""
    return {"general__base_exp_dir": exp_dir, "general__recording": (),
            "dataset__data_dir": data_dir}


def image_indices(n_img: int, start: int, k: int,
                  rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """The views of iterations start .. start + k - 1 in ``Runner.train``'s
    order: permutations of ``rng`` (a fresh RandomState(0) unless given; a
    campaign's scan i takes RandomState(i)), one per pass over the views."""
    rng = np.random.RandomState(0) if rng is None else rng
    perm = rng.permutation(n_img)
    for _ in range(start // n_img):
        perm = rng.permutation(n_img)
    out = np.empty((k,), np.int64)
    for j in range(k):
        step = start + j
        out[j] = perm[step % n_img]
        if (step + 1) % n_img == 0:
            perm = rng.permutation(n_img)
    return out


class Snapshots:
    """The draws of a window, handed to ``TrainWindow`` as its ``noise``.
    The window asks for step i's draws just before it runs step i, so that
    is where the state after the steps before it is copied: the first
    moments after step 1 and the parameters after step ``check.FOLLOW``.
    Every ask copies again, so the last ask before step i runs is the copy
    that stays."""

    def __init__(self, draws, params, opt_state):
        self.draws, self.params, self.opt_state = draws, params, opt_state
        self.m1 = self.pN = None

    def __len__(self):
        return len(self.draws)

    def __getitem__(self, i):
        if i == 1:
            self.m1 = check.moments(self.opt_state)
        if i == check.FOLLOW:
            self.pN = check.snapshot_params(self.params)
        return self.draws[i]


class ScanSnapshots:
    """The draws of a campaign's window, ``noise[j][i]`` (scan i, step j),
    handed to ``MultiScanWindow``: scan i's ``Snapshots``. The window first
    reads every step's draws to check their shapes, and then step j's again
    just before it runs step j; that last read makes the copies that stay."""

    def __init__(self, scans: List[Snapshots]):
        self.scans = scans

    def __len__(self):
        return len(self.scans[0])

    def __getitem__(self, j):
        return [s[j] for s in self.scans]


# ----------------------------------------------------------------------------
# the port's side
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class Setup:
    runner: Any  # a Runner, or a campaign's MultiScanRunner
    cfg: Any
    firsts: List[Dict[str, Any]]  # what the reference follows, one a scan
    scene_dirs: List[Path]  # one a scan
    model: ModuleType  # models/<m>.py
    periodic: "Periodic"  # the runner's periodic actions, watched
    reference_s: float = 0.0  # seconds of the reference's steps that made the start

    @property
    def first(self) -> Dict[str, Any]:
        """The first scan's (a one-scan cell's only)."""
        return self.firsts[0]

    @property
    def scene_dir(self) -> Path:
        return self.scene_dirs[0]


def scans(wl) -> int:
    """Scans a workload trains at once: its ``scans``, 1 unless given."""
    return int(wl.get("scans", 1))


def start_iter(wl) -> int:
    """The iteration a workload's runner starts at: its ``start_iter``, 0
    unless given."""
    return int(wl.get("start_iter", 0))


def crossings(wl) -> int:
    """Runner windows of the measured window that must run the runner's
    periodic actions: the workload's ``crossings``, 0 unless given."""
    return int(wl.get("crossings", 0))


def _load_cfg(conf: Path, exp_dir: str, data_dir: str, extra=None):
    from neuraludf_tpu_torch import config as port_config

    return port_config.load(str(conf), **overrides(exp_dir, data_dir), **(extra or {}))


def _copy_tree(mine, theirs, what: str) -> None:
    """Copies every leaf of ``theirs`` into the same leaf of ``mine`` in place."""
    mine, theirs = dict(check.flat_leaves(mine)), dict(check.flat_leaves(theirs))
    if mine.keys() != theirs.keys():
        raise ValueError(f"{what} trees differ: {sorted(mine.keys() ^ theirs.keys())}")
    for path, t in mine.items():
        if t.shape != theirs[path].shape:
            raise ValueError(f"{path}: {tuple(t.shape)} != {tuple(theirs[path].shape)}")
        t.copy_(theirs[path])


def _seed_state(runner, start: Dict[str, Any]) -> None:
    """Hands the runner the benchmark's start: its parameters and Adam state
    copied in place (a zero state where the start has none), and its
    trainability."""
    with torch.no_grad():
        _copy_tree(runner.params, start["params"], "parameter")
        if start["opt"] is None:
            for _, t in check.flat_leaves(runner.opt_state):
                t.zero_()
        else:
            _copy_tree(runner.opt_state, start["opt"], "optimizer state")
    runner.beta_trainable = start["beta_trainable"]
    runner.variance_trainable = start["variance_trainable"]


def first_window(runner, seed: int, start: Dict[str, Any], model) -> Dict[str, Any]:
    """The runner's first window from the benchmark's ``start``, through its
    own ``TrainWindow`` on draws made from the seed; returns what the
    reference follows."""
    from neuraludf_tpu_torch.train import schedules as port_sched

    k = runner._window_size()
    if k != WINDOW:
        raise ValueError(f"the runner's window is {k} iterations, the benchmark's {WINDOW}")
    dev = runner.device
    start_iter = runner.iter_step
    if periodic_hits(runner.cfg, start_iter + k, k):
        raise ValueError(f"the first window ({start_iter} .. {start_iter + k}) would cross a "
                         "periodic action, which it does not run")
    scheds = [runner._schedules_at(start_iter + j) for j in range(k)]
    blending = port_sched.is_blending(scheds[0])
    if blending != port_sched.is_blending(scheds[-1]):
        raise ValueError("blending switches inside the first window")
    idxs = image_indices(runner.dataset.n_images, start_iter, k)
    images = runner.dataset.scene["images"]
    draws = model.make_draws(runner.cfg, images.shape[:3], k, seed, dev)
    state0 = {"p0": check.snapshot_params(runner.params), "m0": check.moments(runner.opt_state),
              "start": start}
    snaps = Snapshots(draws, runner.params, runner.opt_state)
    window_fn = runner._get_window_fn(blending, k)
    rows = torch.from_numpy(port_sched.schedule_rows(scheds)).to(dev)
    mat = window_fn(runner.params, runner.opt_state, runner.dataset.scene,
                    torch.from_numpy(idxs).to(dev), runner.generator, rows, noise=snaps)
    runner.iter_step += k
    from neuraludf_tpu_torch.train.step import METRIC_KEYS

    rows_n = mat[:check.FOLLOW].cpu().tolist()
    losses = [row[METRIC_KEYS.index("loss")] for row in rows_n]
    terms = [dict(zip(METRIC_KEYS, row)) for row in rows_n]
    return {**state0, "m1": snaps.m1, "pN": snaps.pN, "losses": losses, "terms": terms,
            "start_iter": start_iter,
            "idxs": idxs[:check.FOLLOW], "draws": draws[:check.FOLLOW], "blending": blending}


def build(cell: cells.Cell, seed: int, device, exp_dir: str, dataset=None,
          cache: Path = scene.CACHE, extra=None) -> Setup:
    """Everything up to and including the first window (module docstring).
    ``extra`` adds configuration overrides (``calibrate.py``'s witness)."""
    from neuraludf_tpu_torch.data.dataset import Dataset
    from neuraludf_tpu_torch.train.runner import Runner

    wl = cell.workload
    model = models.for_cell(cell)
    if crossings(wl) > 1 or (crossings(wl) and scans(wl) > 1):
        raise ValueError(f"{cell.name}: the harness checks one crossing of one scan")
    if crossings(wl):  # what the periodic actions build at first use, built here
        from neuraludf_tpu_torch.mesh import build as mesh_build
        from neuraludf_tpu_torch.ops import build as ops_build

        mesh_build.ensure_built()  # the meshes' host engine
        if device.type == "cuda":
            ops_build.compile_sources(["strip_sample"])  # K3, the validation render's blending
    if scans(wl) > 1:
        return build_campaign(cell, seed, device, exp_dir, cache, extra)
    spec = scene_spec(cell.conf_path)
    scene_dir, _ = scene.ensure_scene(spec, cache)
    cfg = _load_cfg(cell.conf_path, exp_dir, str(scene_dir), extra)
    weights = seeded_weights(model, cfg, wl, seed, device)
    stage = wl["stage"]
    reference_s = 0.0
    if stage == "finetune":
        t0 = time.time()
        start = reference_start(cell, model, weights, int(spec["views"]), scene_dir, device,
                                exp_dir, seed)
        _sync(device)
        reference_s = time.time() - t0
        del weights
        _free()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
    elif stage == "stage1":
        ref_cfg = model.load_config(cell.conf_path, **overrides(exp_dir, str(scene_dir)))
        start = {"params": weights, "opt": None, **model.initial_trainability(ref_cfg)}
    else:
        raise ValueError(f"{cell.name}: unknown stage {stage!r}")
    if dataset is None:
        dataset = Dataset(cfg.dataset, device)
    runner = Runner(cfg, seed=seed, device=device, dataset=dataset,
                    is_finetune=stage == "finetune", **runner_flags(wl))
    _seed_state(runner, start)
    runner.iter_step = start_iter(wl)  # the schedules and the views start there
    runner.end_iter = runner.iter_step  # train() runs only what the caller asks for
    first = first_window(runner, seed, start, model)
    return Setup(runner, cfg, [first], [scene_dir], model,
                 Periodic([runner], model, seed), reference_s)


SCAN_STREAM = 2 ** 40  # times scan i, added to the seed for the draws of a campaign's scan i


def scan_specs(cell: cells.Cell) -> List[Dict[str, Any]]:
    """A campaign's scenes: the configuration's scene with each entry of the
    workload's ``scenes`` laid over it, one a scan."""
    spec, entries = scene_spec(cell.conf_path), cell.workload["scenes"]
    if len(entries) != scans(cell.workload):
        raise ValueError(f"{cell.name}: {len(entries)} scenes for {scans(cell.workload)} scans")
    return [{**spec, **e} for e in entries]


def seeded_weights(model, cfg, wl, seed: int, device):
    """The model's seeded weights; where the workload gives
    ``fixed_init_seed``, every network is drawn from that seed instead, the
    same in every run (the draws stay the run seed's)."""
    return model.init_weights(cfg, int(wl.get("fixed_init_seed", seed)), device)


def build_campaign(cell: cells.Cell, seed: int, device, exp_dir: str,
                   cache: Path = scene.CACHE, extra=None) -> Setup:
    """A campaign's set-up up to and including its first window (module
    docstring): the port's ``MultiScanRunner`` over the scans' scenes, each
    scan handed its seeded start."""
    from neuraludf_tpu_torch.parallel.multi_scan import MultiScanRunner

    wl = cell.workload
    model = models.for_cell(cell)
    if wl["stage"] != "stage1":
        raise ValueError(f"{cell.name}: a campaign of stage {wl['stage']!r}; only stage1 is built")
    if start_iter(wl):
        raise ValueError(f"{cell.name}: a campaign starts at iteration 0")
    dirs = [scene.ensure_scene(spec, cache)[0] for spec in scan_specs(cell)]
    if len(set(dirs)) != len(dirs):
        raise ValueError(f"{cell.name}: two scans on one scene; each writes its own log there")
    cfg = _load_cfg(cell.conf_path, exp_dir, str(dirs[0]), extra)
    ref_cfg = model.load_config(cell.conf_path, **overrides(exp_dir, str(dirs[0])))
    runner = MultiScanRunner(cfg, [str(d) for d in dirs], out_dir=exp_dir, seed=seed,
                             device=device, **runner_flags(wl))
    starts = []
    for i, scan in enumerate(runner.scans):
        starts.append({"params": seeded_weights(model, cfg, wl, seed + i, device), "opt": None,
                       **model.initial_trainability(ref_cfg)})
        _seed_state(scan, starts[-1])
    runner.end_iter = runner.iter_step  # train() runs only what the caller asks for
    return Setup(runner, cfg, campaign_window(runner, seed, starts, model), dirs, model,
                 Periodic(runner.scans, model, seed))


def campaign_window(runner, seed: int, starts: List[Dict[str, Any]],
                    model) -> List[Dict[str, Any]]:
    """A campaign's first window from the benchmark's starts, through the
    runner's own ``MultiScanWindow`` on draws made from the seed (scan i's
    from ``seed + i * SCAN_STREAM``) and on each scan's views; returns what
    the reference follows, one a scan."""
    from neuraludf_tpu_torch.train import schedules as port_sched
    from neuraludf_tpu_torch.train.step import METRIC_KEYS

    k = runner.scans[0]._window_size()
    if k != WINDOW:
        raise ValueError(f"the runner's window is {k} iterations, the benchmark's {WINDOW}")
    dev = runner.device
    start_iter = runner.iter_step
    scheds, rows = runner._schedule_rows(k)
    blending = port_sched.is_blending(scheds[0][0])
    if blending != port_sched.is_blending(scheds[-1][0]):
        raise ValueError("blending switches inside the first window")
    window_fn = runner._get_window_fn(blending, k)
    if window_fn.unroll != 1:
        raise ValueError(f"a unit of {window_fn.unroll} steps: the snapshots need one a unit")
    idxs, draws, snaps, state0 = [], [], [], []
    for i, scan in enumerate(runner.scans):
        idxs.append(image_indices(scan.dataset.n_images, start_iter, k,
                                  np.random.RandomState(i)))
        draws.append(model.make_draws(scan.cfg, scan.dataset.scene["images"].shape[:3], k,
                                      seed + i * SCAN_STREAM, dev))
        snaps.append(Snapshots(draws[i], scan.params, scan.opt_state))
        state0.append({"p0": check.snapshot_params(scan.params),
                       "m0": check.moments(scan.opt_state), "start": starts[i]})
    mat = window_fn([s.params for s in runner.scans], [s.opt_state for s in runner.scans],
                    [s.dataset.scene for s in runner.scans],
                    torch.from_numpy(np.stack(idxs, axis=1)).to(dev),
                    [s.generator for s in runner.scans], rows, noise=ScanSnapshots(snaps))
    runner.iter_step += k
    for scan in runner.scans:
        scan.iter_step = runner.iter_step
    rows_n = mat[:check.FOLLOW].cpu().tolist()  # [FOLLOW][S][M]
    out = []
    for i in range(len(runner.scans)):
        terms = [dict(zip(METRIC_KEYS, step[i])) for step in rows_n]
        out.append({**state0[i], "m1": snaps[i].m1, "pN": snaps[i].pN,
                    "losses": [t["loss"] for t in terms], "terms": terms,
                    "start_iter": start_iter, "idxs": idxs[i][:check.FOLLOW],
                    "draws": draws[i][:check.FOLLOW], "blending": blending})
    return out


def reg_weights(wl) -> bool:
    """Whether the cell's launcher passes --reg_weights_schedule."""
    return bool(wl.get("reg_weights_schedule", False))


def runner_flags(wl) -> Dict[str, Any]:
    """The launcher's flags the cell's traffic sets."""
    return {"reg_weights_schedule": reg_weights(wl)}


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_windows(runner, n: int) -> None:
    """n whole windows through ``Runner.train``."""
    runner.end_iter = runner.iter_step + n * WINDOW
    runner.train()


PERIODIC = ("val_freq", "save_freq", "val_mesh_freq")  # the frequencies of Runner._periodic_actions
RENDER_STREAM = 2 ** 33  # added to the seed for the draws of the validation render
# the methods Runner._periodic_actions calls, each timed alone by main.profile_crossing
ACTIONS = ("validate", "save_checkpoint", "validate_mesh", "extract_udf_mesh")


def periodic_hits(cfg, iter_step: int, k: int) -> List[str]:
    """The periodic actions a runner window of k iterations that ends at
    ``iter_step`` runs, by their frequency's name: those whose frequency has
    a multiple in the window (``Runner._periodic_actions``'s rule)."""
    t = cfg.train
    return [name for name in PERIODIC
            if getattr(t, name) > 0 and iter_step // getattr(t, name)
            > (iter_step - k) // getattr(t, name)]


class _Errors(logging.Handler):
    """Counts the error records of the port's loggers (the runner logs a
    failed render or mesh and goes on)."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.n = 0

    def emit(self, record):
        self.n += 1


class Periodic:
    """The runners' periodic actions, watched. Each runner's
    ``_periodic_actions`` is wrapped on the instance; a call that runs an
    action (``periodic_hits``: the validation render, a checkpoint, the
    meshes) is an event: the scan (the runner's index), the iteration, the
    actions, its seconds, the launches of K1, K2 and K3 it made (its renders
    and grid queries, which are not training steps), the errors the port
    logged in it; where it renders the validation image, the render's calls
    (``renders``: its renderer takes the benchmark's draws, the model's
    ``render_draws``, from ``seed + RENDER_STREAM``) and the image
    (``images.written``); where it writes meshes, the meshes
    (``meshes.written``); and where it does either, a copy of the whole
    parameter tree (``state``) as the image and the meshes were made from
    it."""

    def __init__(self, runners, model, seed: int):
        self.events: List[Dict[str, Any]] = []
        for i, r in enumerate(runners):
            r._periodic_actions = self._watched(i, r, r._periodic_actions, model, seed)

    def _watched(self, scan: int, runner, original, model, seed: int):
        def periodic_actions(k: int):
            hits = periodic_hits(runner.cfg, runner.iter_step, k)
            if not hits:
                return original(k)
            event = {"scan": scan, "iter": runner.iter_step, "hits": hits}
            if {"val_freq", "val_mesh_freq"} & set(hits):
                event["state"] = _clone_tree(runner.params)
            calls: List[Dict[str, Any]] = []
            renders = contextlib.nullcontext(calls)
            if "val_freq" in hits:
                gen = torch.Generator(device=runner.device).manual_seed(seed + RENDER_STREAM)
                renders = model.render_draws(runner, gen)
            errors, port_log = _Errors(), logging.getLogger("neuraludf_tpu_torch")
            port_log.addHandler(errors)
            before, t0 = launch_counts(), time.time()
            try:
                with renders as calls:
                    return original(k)
            finally:
                _sync(runner.device)
                event["seconds"] = time.time() - t0
                port_log.removeHandler(errors)
                after = launch_counts()
                event.update(errors=errors.n, renders=calls,
                             launched={n: after[n] - before[n] for n in after},
                             image=images.written(runner.base_exp_dir, event["iter"]),
                             meshes=meshes.written(runner.base_exp_dir, event["iter"]))
                self.events.append(event)

        return periodic_actions

    def windows(self, since: int = 0) -> int:
        """Runner windows with a periodic action among the events from
        ``since`` on (a campaign's scans each make one a window)."""
        return len({e["iter"] for e in self.events[since:]})

    def launched(self, since: int = 0) -> Dict[str, int]:
        """The kernels' launches of the events from ``since`` on."""
        out = {"K1": 0, "K2": 0, "K3": 0}
        for e in self.events[since:]:
            for n, v in e["launched"].items():
                out[n] += v
        return out

    def errors(self, since: int = 0) -> int:
        return sum(e["errors"] for e in self.events[since:])


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def launch_counts() -> Dict[str, int]:
    from neuraludf_tpu_torch.ops import fused_distance, strip_sample

    return {"K1": fused_distance.fused_forward.launches,
            "K2": fused_distance.fused_backward.launches,
            "K3": strip_sample.strip_sample.launches}


def window_rows(runner, first_iter: int, last_iter: int) -> List[List[Optional[Dict]]]:
    """The metric rows ``Runner.train`` logged for iterations first..last
    (each scan of a ``MultiScanRunner`` in its own log): one list a step,
    one row a scan, None where a row is missing."""
    by_scan = []
    for scan in getattr(runner, "scans", [runner]):
        rows = {}
        with open(Path(scan.base_exp_dir) / "logs" / "metrics.jsonl") as f:
            for line in f:
                row = json.loads(line)
                if first_iter <= row["iter"] <= last_iter:
                    rows[row["iter"]] = row
        by_scan.append([rows.get(i) for i in range(first_iter, last_iter + 1)])
    return [list(step) for step in zip(*by_scan)]


def failed_steps(rows, launched: Dict[str, int], blending: bool, on_card: bool,
                 n_scans: int = 1) -> List[str]:
    """Why steps of the window failed: a scan's row missing or with a
    non-finite loss, a blending step with a zero pixel or patch term, a
    kernel that did not launch once a step of each scan (on the card)."""
    why = []
    n = len(rows)
    bad = [i for i, step in enumerate(rows)
           if any(r is None or not math.isfinite(r["loss"]) for r in step)]
    if bad:
        why.append(f"{len(bad)} steps without a finite loss")
    if blending:
        dead = [i for i, step in enumerate(rows) if any(
            r is not None and (r["color_pixel_loss"] == 0.0 or r["color_patch_loss"] == 0.0)
            for r in step)]
        if dead:
            why.append(f"{len(dead)} blending steps with a zero pixel or patch term")
    if on_card:
        n *= n_scans
        want = {"K1": n, "K2": n, "K3": n if blending else 0}
        for k, v in want.items():
            if launched[k] != v:
                why.append(f"{k} launched {launched[k]} times in {n} steps")
    return why


# ----------------------------------------------------------------------------
# the reference's side
# ----------------------------------------------------------------------------

SETUP_STREAM = 2 ** 32  # added to the seed for the draws of a finetune's start


@contextlib.contextmanager
def exact_f32():
    """f32 products with TF32 off inside; the flags as they were after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32_off()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _ref_state(start: Dict[str, Any], device, model):
    """The reference's parameters and Adam state, fresh copies of a start."""
    params = {}
    for path, t in check.flat_leaves(start["params"]):
        check.put(params, path, t.detach().clone().to(device).requires_grad_(True))
    opt = model.init_adam(params)
    if start["opt"] is not None:
        with torch.no_grad():
            _copy_tree(opt, start["opt"], "optimizer state")
    return params, opt


def reference_start(cell: cells.Cell, model, weights, n_views: int, scene_dir: Path, device,
                    exp_dir: str, seed: int) -> Dict[str, Any]:
    """A finetune cell's start, made by the benchmark: the plain reference's
    ``setup_steps`` stage-1 iterations (the cell's ``setup_conf``) from the
    seeded weights, in f32 with TF32 off, on draws from the seed (a stream
    of their own), in ``Runner.train``'s view order. As in the runner, the
    trainability is fixed for a window of WINDOW steps and updated after it
    by the runner's rule: beta becomes trainable once the variance is below
    0.01 and below twice beta. Returns the parameters, the Adam state and
    the trainability."""
    wl = cell.workload
    cfg = model.load_config(cell.here / "configs" / cells.check_name(wl["setup_conf"]),
                            **overrides(exp_dir, str(scene_dir)))
    k = int(wl["setup_steps"])
    idxs = image_indices(n_views, 0, k)
    flags = model.initial_trainability(cfg)
    beta_flag = True
    with exact_f32():
        scene_t = model.load_scene(scene_dir, idxs, device)
        draws = model.make_draws(cfg, scene_t["images"].shape[:3], k, seed + SETUP_STREAM,
                                 device)
        params, opt = _ref_state({"params": weights, "opt": None}, device, model)
        body = model.step_body(cfg, blending=False)
        for w0 in range(0, k, WINDOW):
            n = min(WINDOW, k - w0)
            rows = torch.as_tensor(model.schedule_rows(
                cfg, w0, n, finetune=False, reg_weights_schedule=reg_weights(wl), flags=flags),
                device=device)
            ms = [body(params, opt, scene_t, int(idxs[w0 + j]), rows[j], noise=draws[w0 + j])
                  for j in range(n)]
            for j, m in enumerate(ms):
                loss, var, beta = float(m["loss"]), float(m["variance"]), float(m["beta"])
                if not math.isfinite(loss):
                    raise FloatingPointError(
                        f"the reference's start: loss {loss} at step {w0 + j}")
                if var < 2 * beta and var < 0.01 and beta_flag and flags["variance_trainable"]:
                    flags["beta_trainable"], beta_flag = True, False
    out = {}
    for path, t in check.flat_leaves(params):
        check.put(out, path, t.detach())
    return {"params": out, "opt": opt, **flags}


def reference_side(cell: cells.Cell, setup_first: Dict[str, Any], scene_dir: Path, device,
                   exp_dir: str, rounding: Optional[tuple] = None) -> Dict[str, object]:
    """The plain reference's FOLLOW steps from the benchmark's start (the
    seeded weights, or in a finetune cell ``reference_start``'s state), on
    the same draws, views and schedules; its readings. With ``rounding`` the
    reference rounds its products' operands and cotangents to that pair of
    types (``reference.mlp.rounded``; the control)."""
    f = setup_first
    model = models.for_cell(cell)
    cfg = model.load_config(cell.conf_path, **overrides(exp_dir, str(scene_dir)))
    scene_t = model.load_scene(scene_dir, f["idxs"], device, sources=8 if f["blending"] else 0)
    params, opt = _ref_state(f["start"], device, model)
    flags = {k: f["start"][k] for k in ("beta_trainable", "variance_trainable")}
    rows = model.schedule_rows(cfg, f["start_iter"], check.FOLLOW,
                               finetune=cell.workload["stage"] == "finetune",
                               reg_weights_schedule=reg_weights(cell.workload), flags=flags)
    body = model.step_body(cfg, blending=f["blending"])
    p0, m0 = check.snapshot_params(params), check.moments(opt)
    losses, terms, m1 = [], [], None
    ctx = model.rounded(*rounding) if rounding is not None else contextlib.nullcontext()
    with ctx:
        for j in range(check.FOLLOW):
            sched = torch.as_tensor(rows[j], device=device)
            noise = {k: v.to(device) for k, v in f["draws"][j].items()}
            m = body(params, opt, scene_t, int(f["idxs"][j]), sched, noise=noise)
            losses.append(float(m["loss"]))
            terms.append({k: float(v) for k, v in m.items()})
            if j == 0:
                m1 = check.moments(opt)
    out = check.readings(losses, m0, m1, p0, check.snapshot_params(params))
    out["terms"] = terms
    return out


def program_side(first: Dict[str, Any]) -> Dict[str, object]:
    out = check.readings(first["losses"], first["m0"], first["m1"], first["p0"], first["pN"])
    out["terms"] = first["terms"]
    return out


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
