"""Multi-scan training: S independent scans at once on one card
(counterpart of ``neuraludf_tpu/parallel/multi_scan.py``).

Each scan keeps its own parameters, optimizer state, scene, draws
(``torch.Generator``), schedules and trainability state machines. The JAX
package vmaps the step over a stacked scan axis; here the scans are a list
and train through the single scan's loop (``train.runner.train_scans``) and
window (``train.step.TrainWindow``), of which one scan is the case S = 1: a
``MultiScanWindow`` holds the S step bodies of a unit in one CUDA graph, so
that one replay runs an iteration of every scan. Scans must still share
their resolution and view count, so that both packages take the same inputs.

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

import dataclasses
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.dataset import Dataset
from ..render.renderer import UDFRenderer
from ..train.runner import Runner, cached_window, default_device, scan_schedules, train_scans
from ..train.step import METRIC_KEYS, TrainWindow, build_step_body

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
    """``step.TrainWindow`` of S scans called in its form for S scans
    (``TrainWindow.call_scans``; ``build_multi_scan_window``)."""

    __call__ = TrainWindow.call_scans


def build_multi_scan_window(cfg: Config, renderer: UDFRenderer, *, blending: bool, window: int,
                            n_scans: int, unroll: int = 1) -> MultiScanWindow:
    """window_fn(params_S, opt_states_S, scenes_S, img_idxs [W, S],
    generators_S, scheds [W, S, K], noise=None) -> metric rows [W, S, M]:
    ``window`` iterations of ``n_scans`` scans, ``unroll`` step bodies of
    each scan a graph (``MultiScanWindow``). A window of 1 is the JAX
    package's ``build_multi_scan_step``. ``unroll`` must divide ``window``."""
    return MultiScanWindow(cfg, build_step_body(cfg, renderer, blending=blending), window,
                           unroll, n_scans)


class MultiScanRunner:
    """S independent scans trained at once, each as a single-scan ``Runner``
    would train it (counterpart of the JAX package's ``MultiScanRunner``).

    Scan i is a ``Runner(seed=seed + i)`` over its case's dataset (loaded
    once for every scan that shares its directory) in ``<out_dir>/<case>``.
    Those runners keep the scans' state and do what one scan does alone:
    its checkpoints (in the single-scan format), validation renders, meshes
    and metric log. This runner steps them together through
    ``Runner.train``'s loop, its full windows through one ``MultiScanWindow``."""

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

        datasets = {d: Dataset(dataclasses.replace(cfg.dataset, data_dir=d), self.device)
                    for d in dict.fromkeys(data_dirs)}
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
        self._window_fns: Dict[tuple, MultiScanWindow] = {}
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
        taken)."""
        common = set.intersection(*(set(r.checkpoint_names()) for r in self.scans))
        if not common:
            return
        name = sorted(common)[-1]
        for r in self.scans:
            r.load_checkpoint(os.path.join(r._ckpt_dir(), name))
        self.iter_step = self.scans[0].iter_step  # 0 for a finetune: it restarts the clock
        log.info("resumed %d scans from %s (iter %d)", self.S, name, self.iter_step)

    # -- training --------------------------------------------------------------

    def _get_window_fn(self, blending: bool, window: int) -> MultiScanWindow:
        """The multi-scan window of one body (``runner.cached_window``)."""
        return cached_window(self._window_fns, self.cfg, self.renderer, blending, window,
                             build_multi_scan_window, n_scans=self.S)

    def train(self, report_hook=None):
        """Trains every scan to ``end_iter`` (``runner.train_scans``).
        ``report_hook(it, metrics)`` is called every ``report_freq``
        iterations with a dict of [S] arrays."""
        train_scans(self, self.scans, report_hook)

    def _schedule_rows(self, k: int):
        """The schedules of every scan at each of the next k iterations and
        their rows [k, S, len(SCHEDULE_KEYS)] (``runner.scan_schedules``)."""
        return scan_schedules(self.scans, self.iter_step, k, self.device)

    def _call_window(self, window_fn, idxs: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        return window_fn([r.params for r in self.scans], [r.opt_state for r in self.scans],
                         [r.dataset.scene for r in self.scans], idxs,
                         [r.generator for r in self.scans], rows)

    def _report(self, it: int, rows: np.ndarray, rate: str) -> Dict[str, np.ndarray]:
        """The log line of iteration it's metric rows [S, M]; returns the
        report hook's metrics, [S] arrays."""
        log.info("iter %d per-scan loss %s (%s)", it,
                 np.round(rows[:, METRIC_KEYS.index("loss")], 4), rate)
        return {name: rows[:, n] for n, name in enumerate(METRIC_KEYS)}

    def _crash(self, it: int, scan: int, m: Dict[str, float]):
        """A non-finite loss of a scan at iteration it: every scan's state
        (the window's updates are applied already) is saved as ``crash_*``."""
        paths = self.save_checkpoints(prefix="crash")
        raise FloatingPointError(f"non-finite loss at iter {it} in scan {self.cases[scan]}: "
                                 f"{m}; states saved to {paths}")

    def final_meshes(self, resolution: int = 512) -> List[str]:
        """Every scan's closing MeshUDF extraction (world space, distance
        threshold ratio 5), as the single-scan CLI ends its training."""
        return [r.extract_udf_mesh(world_space=True, resolution=resolution,
                                   dist_threshold_ratio=5.0) for r in self.scans]
