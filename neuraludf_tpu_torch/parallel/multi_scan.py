"""Multi-scan training: S independent scans at once on one card
(counterpart of ``neuraludf_tpu/parallel/multi_scan.py``).

Each scan keeps its own parameters, optimizer state, scene, draws
(``torch.Generator``), schedules and trainability state machines. The JAX
package vmaps the step over a stacked scan axis and shards that axis over
its devices; here one ``MultiScanWindow`` holds the S step bodies of a unit
and, on a CUDA device, captures them into one CUDA graph, so that one replay
runs an iteration of every scan. Nothing is vmapped, so nothing is stacked:
the scans are a list. Scans must still share their resolution and view
count, as in the JAX package, so that both packages take the same inputs.

The same machinery runs a hyperparameter sweep: the same data directory S
times with per-scan ``train_overrides``. Only fields that reach the step
through its schedule row may differ (``SWEEPABLE_TRAIN_FIELDS``), so every
scan runs the same step bodies and one graph holds them all.

Scan i is a ``Runner(seed=seed + i)``: initialised from seed ``seed + i``
(the JAX package's ``stack_params``), drawing from a generator seeded
``seed + i + 1``; it takes its images in the order of
``np.random.RandomState(i)``. Given the same image indices, scan i is draw
for draw the single-scan run of ``Runner(seed=seed + i)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.dataset import Dataset
from ..render.renderer import UDFRenderer
from ..train import schedules as sched_mod
from ..train.runner import Runner, default_device, iter_rate, rate_text
from ..train.schedules import SCHEDULE_KEYS
from ..train.step import (METRIC_KEYS, Noise, Params, TrainWindow, build_step_body,
                          draw_noise)
from ..utils.watchdog import StallWatchdog

log = logging.getLogger(__name__)

# TrainConfig fields that reach the step only through its schedule row
# (train/schedules.py), so they may differ from scan to scan in a sweep.
# end_iter is not one: it is also the length of the runner's loop.
SWEEPABLE_TRAIN_FIELDS = frozenset({
    "sparse_weight", "igr_weight", "igr_ns_weight", "mask_weight",
    "learning_rate", "learning_rate_geo", "learning_rate_alpha",
    "same_lr", "warm_up_end", "anneal_end", "fix_geo_end",
})


class MultiScanWindow(TrainWindow):
    """``window`` iterations of S scans a call (``build_multi_scan_window``).

    A unit runs ``unroll`` step bodies of every scan, each over its own
    parameters, optimizer state, scene, draws, view and schedule row. On a
    CUDA device every scan's bodies run on a side stream of their own,
    forked from the unit's stream and joined to it, so that the scans' many
    small kernels overlap (autograd runs each backward operator on its
    forward operator's stream); the whole unit is captured into one CUDA
    graph of S branches and replayed, as ``TrainWindow`` does for one scan
    (two eager warm-up units, the capture, replays; the graph is dropped and
    captured again when any scan's tensors are replaced; the launch counters
    advance by the capture's count, S launches of each kernel, at every
    replay). Each scan's kernels see the same inputs in the same order as in
    a single-scan window, so each scan's results are that window's, bit for
    bit. The branches cannot share memory: the graph's pool holds S bodies'
    blocks (PERF.md §5). On the CPU the bodies run one scan after the other
    on the same buffers."""

    def __init__(self, cfg: Config, body: Callable, window: int, unroll: int, n_scans: int):
        super().__init__(cfg, body, window, unroll)
        self.n_scans = n_scans
        self.branches: Optional[List[torch.cuda.Stream]] = None

    def __call__(self, params: Sequence[Params], opt_states: Sequence[Params],
                 scenes: Sequence[Dict[str, torch.Tensor]], img_idxs: torch.Tensor,
                 generators: Sequence[Optional[torch.Generator]], scheds: torch.Tensor,
                 noise: Optional[Sequence[Sequence[Noise]]] = None) -> torch.Tensor:
        """img_idxs [window, S] and scheds [window, S, len(SCHEDULE_KEYS)] on
        the scenes' device; ``noise[j][i]``, scan i's draws at step j,
        replaces the draws from ``generators[i]``. Returns the metric rows
        [window, S, len(METRIC_KEYS)] on the device; each scan's parameters
        and optimizer state are updated in place."""
        k, u, S = self.window, self.unroll, self.n_scans
        if not len(params) == len(opt_states) == len(scenes) == len(generators) == S:
            raise ValueError(f"a window of {S} scans takes {S} parameter sets, optimizer states, "
                             f"scenes and generators")
        if (tuple(img_idxs.shape) != (k, S)
                or tuple(scheds.shape) != (k, S, len(SCHEDULE_KEYS))):
            raise ValueError(f"a window of {k} steps of {S} scans takes img_idxs [{k}, {S}] and "
                             f"scheds [{k}, {S}, {len(SCHEDULE_KEYS)}], got "
                             f"{tuple(img_idxs.shape)} and {tuple(scheds.shape)}")
        if noise is not None and (len(noise) != k or any(len(n) != S for n in noise)):
            raise ValueError(f"noise: draws for {k} steps of {S} scans expected")
        dev = scenes[0]["images"].device
        rows = torch.empty((k, S, len(METRIC_KEYS)), dtype=torch.float32, device=dev)
        by_scan = lambda xs: dict(enumerate(xs))  # scan -> tree, as TrainWindow's trees
        for r in range(0, k, u):
            # each scan consumes its own generator in its steps' order
            draws = [[noise[r + j][i] if noise is not None
                      else draw_noise(self.cfg, scenes[i], generators[i]) for i in range(S)]
                     for j in range(u)]
            st = self._buffers(draws, dev)
            for j in range(u):
                for i, d in enumerate(draws[j]):
                    if d.keys() != st["noise"][j][i].keys():
                        raise ValueError(f"draws {sorted(d)} differ from the window's "
                                         f"{sorted(st['noise'][j][i])}")
                    for key, t in d.items():
                        st["noise"][j][i][key].copy_(t)
            st["idx"].copy_(img_idxs[r:r + u])
            st["sched"].copy_(scheds[r:r + u])
            self._run(by_scan(params), by_scan(opt_states), by_scan(scenes), dev)
            rows[r:r + u].copy_(st["rows"])
        return rows

    def _buffers(self, draws: Sequence[Sequence[Noise]], dev) -> Dict:
        if self.static is None:
            S = self.n_scans
            self.static = {
                "noise": [[{key: torch.empty_like(t, device=dev) for key, t in d.items()}
                           for d in step] for step in draws],
                "idx": torch.zeros((self.unroll, S), dtype=torch.long, device=dev),
                "sched": torch.zeros((self.unroll, S, len(SCHEDULE_KEYS)), dtype=torch.float32,
                                     device=dev),
                "rows": torch.zeros((self.unroll, S, len(METRIC_KEYS)), dtype=torch.float32,
                                    device=dev),
            }
        return self.static

    def _unit(self, params, opt_state, scene) -> None:
        """params, opt_state, scene: scan -> that scan's tree."""
        st = self.static
        dev = st["idx"].device
        main = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        if main is not None and self.branches is None:
            self.branches = [torch.cuda.Stream(dev) for _ in range(self.n_scans)]
        for i in range(self.n_scans):
            branch = contextlib.nullcontext()
            if main is not None:
                self.branches[i].wait_stream(main)
                branch = torch.cuda.stream(self.branches[i])
            with branch:
                rows = [self.body(params[i], opt_state[i], scene[i], st["idx"][j, i],
                                  st["sched"][j, i], noise=st["noise"][j][i])
                        for j in range(self.unroll)]
                st["rows"][:, i].copy_(torch.stack(
                    [torch.stack([m[name] for name in METRIC_KEYS]) for m in rows]))
        if main is not None:
            for side in self.branches:
                main.wait_stream(side)


def build_multi_scan_window(cfg: Config, renderer: UDFRenderer, *, blending: bool, window: int,
                            n_scans: int, unroll: int = 1) -> MultiScanWindow:
    """window_fn(params_S, opt_states_S, scenes_S, img_idxs [W, S],
    generators_S, scheds [W, S, K], noise=None) -> metric rows [W, S, M]:
    ``window`` iterations of ``n_scans`` scans, ``unroll`` step bodies of
    each scan a graph (``MultiScanWindow``). A window of 1 is the JAX
    package's ``build_multi_scan_step``. ``unroll`` must divide ``window``."""
    if unroll < 1 or window % unroll != 0:
        raise ValueError(f"unroll {unroll} must divide window {window}")
    return MultiScanWindow(cfg, build_step_body(cfg, renderer, blending=blending), window,
                           unroll, n_scans)


class MultiScanRunner:
    """S independent scans trained at once, each as a single-scan ``Runner``
    would train it (counterpart of the JAX package's ``MultiScanRunner``).

    Scan i is a ``Runner(seed=seed + i)`` over its case's dataset (loaded
    once for every scan that shares its directory) with its experiment
    directory ``<out_dir>/<case>``. Those runners keep the scans' state
    (parameters, optimizer state, generator, trainability) and do what one
    scan does alone: its checkpoints, in the single-scan format, its
    validation renders and meshes, its metric log
    (``<out_dir>/<case>/logs/metrics.jsonl``). This runner steps them
    together: full windows of one step body through one
    ``MultiScanWindow`` (one graph replay an iteration of every scan on a
    CUDA device); a window where blending switches on, a shorter last
    window, and blending windows without ``train.blend_scan_window`` step
    each scan one iteration at a time."""

    def __init__(self, cfg: Config, data_dirs: List[str], case_names: Optional[List[str]] = None,
                 *, out_dir: str = "./exp/multi_scan", seed: int = 0, is_continue: bool = False,
                 is_finetune: bool = False, reg_weights_schedule: bool = False,
                 train_overrides: Optional[List[Optional[Dict[str, object]]]] = None,
                 device=None):
        """device: cuda:0 unless given (tests pass "cpu")."""
        self.device = torch.device(device) if device is not None else default_device()
        self.cfg = cfg
        self.cases = case_names or [os.path.basename(os.path.normpath(d)) for d in data_dirs]
        S = self.S = len(data_dirs)
        if S == 0 or len(self.cases) != S:
            raise ValueError(f"{S} data directories for {len(self.cases)} case names")
        overrides = train_overrides if train_overrides is not None else [None] * S
        if len(overrides) != S:
            raise ValueError(f"{len(overrides)} train overrides for {S} scans")
        # only schedule-borne fields may differ: anything else would need
        # other step bodies than the one graph of the window holds
        bad = sorted({key for ov in overrides if ov for key in ov} - SWEEPABLE_TRAIN_FIELDS)
        if bad:
            raise ValueError(f"train overrides {bad} do not reach the step through its schedule "
                             f"row; sweepable: {sorted(SWEEPABLE_TRAIN_FIELDS)}")

        datasets: Dict[str, Dataset] = {}
        for d in data_dirs:
            if d not in datasets:
                datasets[d] = Dataset(dataclasses.replace(cfg.dataset, data_dir=d), self.device)
        shapes = {(ds.n_images, ds.H, ds.W) for ds in datasets.values()}
        if len(shapes) != 1:
            raise ValueError(f"the scans must share their resolution and view count, as the JAX "
                             f"package stacks them; got (views, H, W) {sorted(shapes)}")
        self.scans = []
        for i, (d, case, ov) in enumerate(zip(data_dirs, self.cases, overrides)):
            cfg_i = dataclasses.replace(
                cfg, train=dataclasses.replace(cfg.train, **(ov or {})),
                general=dataclasses.replace(cfg.general, base_exp_dir=os.path.join(out_dir, case),
                                            expname=""),
                dataset=dataclasses.replace(cfg.dataset, data_dir=d))
            self.scans.append(Runner(cfg_i, "validate", is_finetune=is_finetune,
                                     reg_weights_schedule=reg_weights_schedule, seed=seed + i,
                                     device=self.device, dataset=datasets[d]))
        self.renderer = self.scans[0].renderer
        self.iter_step = 0
        self.end_iter = cfg.train.end_iter
        # each scan's image order: its own stream, as in the JAX package
        self._perm_rngs = [np.random.RandomState(i) for i in range(S)]
        self._perms = [rng.permutation(r.dataset.n_images)
                       for rng, r in zip(self._perm_rngs, self.scans)]
        self._window_fns: Dict[tuple, MultiScanWindow] = {}
        self._rate_mark = None  # (iteration, time) of train's previous report
        if is_continue:
            self._resume()

    # -- checkpoints ---------------------------------------------------------

    def save_checkpoints(self, prefix: str = "ckpt") -> List[str]:
        """Every scan's checkpoint, in the single-scan format, under
        ``<out_dir>/<case>/checkpoints/<prefix>_<iter>.ckpt``."""
        return [r.save_checkpoint(prefix) for r in self.scans]

    def _resume(self):
        """Resume every scan from the newest checkpoint iteration that all of
        them have (the scans save together; crash_* checkpoints are never
        taken), and replay the image permutation streams up to it."""
        common = set.intersection(*(set(r.checkpoint_names()) for r in self.scans))
        if not common:
            return
        name = sorted(common)[-1]
        for r in self.scans:
            r.load_checkpoint(os.path.join(r._ckpt_dir(), name))
        self.iter_step = self.scans[0].iter_step  # 0 for a finetune: it restarts the clock
        for i, r in enumerate(self.scans):
            n_img = r.dataset.n_images
            for _ in range(self.iter_step // n_img):
                self._perms[i] = self._perm_rngs[i].permutation(n_img)
        log.info("resumed %d scans from %s (iter %d)", self.S, name, self.iter_step)

    # -- training --------------------------------------------------------------

    def _get_window_fn(self, blending: bool, window: int) -> MultiScanWindow:
        """The multi-scan window of one body, built at first use;
        ``train.scan_unroll`` step bodies of each scan a graph, lowered to a
        divisor of the window."""
        unroll = max(1, self.cfg.train.scan_unroll)
        while window % unroll != 0:
            unroll -= 1
        key = (blending, window, unroll)
        if key not in self._window_fns:
            self._window_fns[key] = build_multi_scan_window(
                self.cfg, self.renderer, blending=blending, window=window, n_scans=self.S,
                unroll=unroll)
        return self._window_fns[key]

    def _next_img_indices(self, k: int) -> np.ndarray:
        """The views of the next k iterations of every scan, [k, S]; advances
        the permutation streams."""
        out = np.empty((k, self.S), np.int64)
        for j in range(k):
            step = self.iter_step + j
            for i, r in enumerate(self.scans):
                n_img = r.dataset.n_images
                out[j, i] = self._perms[i][step % n_img]
                if (step + 1) % n_img == 0:
                    self._perms[i] = self._perm_rngs[i].permutation(n_img)
        return out

    def train(self, report_hook=None):
        """Trains every scan to ``end_iter``. ``report_hook(it, metrics)`` is
        called every ``report_freq`` iterations with a dict of [S] arrays."""
        tcfg = self.cfg.train
        window = self.scans[0]._window_size()
        self._rate_mark = None  # a train call's first report gives no rate
        logs = []
        for r in self.scans:
            os.makedirs(os.path.join(r.base_exp_dir, "logs"), exist_ok=True)
        watchdog = StallWatchdog(tcfg.stall_warn_s,
                                 tag_fn=lambda: f"iter {self.iter_step}").start()
        try:
            logs = [open(os.path.join(r.base_exp_dir, "logs", "metrics.jsonl"), "a")
                    for r in self.scans]
            while self.iter_step < self.end_iter:
                k = min(window, self.end_iter - self.iter_step)
                mat = self._train_window(k, window, self._next_img_indices(k)).cpu().numpy()
                watchdog.beat()
                for j in range(k):
                    it = self.iter_step - k + 1 + j
                    self._post_step_host(it, mat[j], logs, report_hook)
                for f in logs:
                    f.flush()
                for r in self.scans:
                    r.iter_step = self.iter_step
                    r._periodic_actions(k)
        finally:
            watchdog.stop()
            for f in logs:
                f.close()

    def _schedule_rows(self, k: int):
        """The schedules of every scan at each of the next k iterations
        (each scan's own train config and trainability), and their rows
        [k, S, len(SCHEDULE_KEYS)]."""
        scheds = [[r._schedules_at(self.iter_step + j) for r in self.scans] for j in range(k)]
        rows = np.stack([sched_mod.schedule_rows(step) for step in scheds])
        return scheds, torch.from_numpy(rows).to(self.device)

    def _train_window(self, k: int, window: int, img_idxs: np.ndarray) -> torch.Tensor:
        """k iterations of every scan from iter_step on: metric rows
        [k, S, M] on the device (``Runner._train_window``'s dispatch). The
        scans share their colour weights, so they switch to blending
        together."""
        scheds, rows = self._schedule_rows(k)
        first, last = sched_mod.is_blending(scheds[0][0]), sched_mod.is_blending(scheds[-1][0])
        idxs = torch.from_numpy(img_idxs).to(self.device)
        if first == last and k == window and (self.cfg.train.blend_scan_window or not first):
            window_fn = self._get_window_fn(first, k)
            mat = window_fn([r.params for r in self.scans], [r.opt_state for r in self.scans],
                            [r.dataset.scene for r in self.scans], idxs,
                            [r.generator for r in self.scans], rows)
            self.iter_step += k
            return mat
        out = []
        for j in range(k):
            step_rows = []
            for i, r in enumerate(self.scans):
                m = r.step_body(scheds[j][i])(r.params, r.opt_state, r.dataset.scene, idxs[j, i],
                                              rows[j, i], r.generator)
                step_rows.append(torch.stack([m[name] for name in METRIC_KEYS]))
            out.append(torch.stack(step_rows))
            self.iter_step += 1
        return torch.stack(out)

    def _post_step_host(self, it: int, mat: np.ndarray, logs, report_hook):
        """Iteration it's metric rows [S, M]: each scan's log line and
        trainability state machine; a non-finite loss saves every scan's
        state as ``crash_*`` (the window's updates are applied already) and
        raises. The reported rate is ``runner.iter_rate``'s."""
        for i, r in enumerate(self.scans):
            m = dict(zip(METRIC_KEYS, mat[i].tolist()))
            logs[i].write(json.dumps({"iter": it, **m}) + "\n")
            if not math.isfinite(m["loss"]):
                for rr in self.scans:
                    rr.iter_step = self.iter_step
                paths = self.save_checkpoints(prefix="crash")
                raise FloatingPointError(f"non-finite loss at iter {it} in scan "
                                         f"{self.cases[i]}: {m}; states saved to {paths}")
            r.update_trainability(it, m)
        if it % self.cfg.train.report_freq == 0:
            loss = mat[:, METRIC_KEYS.index("loss")]
            ips, self._rate_mark = iter_rate(self._rate_mark, it)
            log.info("iter %d per-scan loss %s (%s)", it, np.round(loss, 4), rate_text(ips))
            if report_hook:
                report_hook(it, {name: mat[:, n] for n, name in enumerate(METRIC_KEYS)})

    def final_meshes(self, resolution: int = 512) -> List[str]:
        """Every scan's closing MeshUDF extraction (world space, distance
        threshold ratio 5), as the single-scan CLI ends its training."""
        paths = []
        for r in self.scans:
            r.iter_step = self.iter_step
            paths.append(r.extract_udf_mesh(world_space=True, resolution=resolution,
                                            dist_threshold_ratio=5.0))
        return paths
