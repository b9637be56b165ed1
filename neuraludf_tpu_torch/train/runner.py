"""Experiment runner: training and mesh extraction (counterpart of
``neuraludf_tpu/train/runner.py``).

The host computes the schedules, drives the beta/variance trainability
state machine, logs, and saves checkpoints; each iteration runs eagerly on
the runner's device. Metrics of a whole window of iterations move to the
host in one transfer, and every iteration's scalars go to
``<exp>/logs/metrics.jsonl``. Every ``val_mesh_freq`` iterations the runner
writes the classic and the MeshUDF mesh of the field (``validate_mesh``,
``extract_udf_mesh``), their grids filled on the runner's device.

Validation renders are not ported yet (ROADMAP slice 4): ``train`` runs
without them.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import pickle
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import convert
from ..config import Config
from ..data.dataset import Dataset
from ..mesh import grid as mesh_grid
from ..mesh import mc as mesh_mc
from ..mesh.meshudf import get_mesh_udf
from ..mesh.ply import export_ply
from ..nets import fields
from ..render.renderer import UDFRenderer
from . import schedules as sched_mod
from .optim import init_adam_state
from .step import METRIC_KEYS, build_step_body

log = logging.getLogger(__name__)

SKIPPED = "validate is not ported yet (ROADMAP: slice 4); training runs without it"


def init_params(generator: torch.Generator, cfg: Config, device="cpu") -> Dict[str, Any]:
    """Every network's parameters, drawn in order from one CPU generator and
    moved to device as leaves that require grad."""
    params = {
        "udf": fields.init_distance_field(generator, cfg.model.udf_network),
        "color": fields.init_residual_color(generator, cfg.model.rendering_network),
        "nerf": fields.init_background_nerf(generator, cfg.model.nerf),
        "variance": fields.init_variance(cfg.model.variance_network),
        "beta": fields.init_beta(cfg.model.beta_network),
    }
    return convert.to_torch(convert.to_numpy(params), device, requires_grad=True)


def default_device(gpu: int = 0) -> torch.device:
    """cuda:<gpu>; raises when there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the trainer runs on a CUDA device and none is available; "
                           "pass device='cpu' explicitly to run on the CPU")
    return torch.device(f"cuda:{gpu}")


class Runner:
    def __init__(self, cfg: Config, *, is_continue: bool = False, is_finetune: bool = False,
                 reg_weights_schedule: bool = False, seed: int = 0, device=None):
        """device: cuda:0 unless given (tests pass "cpu")."""
        self.device = torch.device(device) if device is not None else default_device()
        # model_type 'neus' trains a signed field with the inside_outside init
        self.model_type = cfg.general.model_type
        if self.model_type == "neus" and cfg.model.udf_network.udf_type != "sdf":
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, udf_network=dataclasses.replace(
                    cfg.model.udf_network, udf_type="sdf", inside_outside=True)))
            log.info("model_type=neus: distance field switched to signed")
        self.cfg = cfg
        self.is_finetune = is_finetune
        self.reg_weights_schedule = reg_weights_schedule

        self.base_exp_dir = os.path.join(cfg.general.base_exp_dir, cfg.general.expname)
        os.makedirs(self.base_exp_dir, exist_ok=True)

        self.dataset = Dataset(cfg.dataset, self.device)
        self.renderer = UDFRenderer(cfg.model)

        self.iter_step = 0
        self.end_iter = cfg.train.end_iter

        self.params = init_params(torch.Generator().manual_seed(seed), cfg, self.device)
        self.opt_state = init_adam_state(self.params)
        # pixel draws and render noise
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

        # runtime trainability state machine
        self.beta_trainable = cfg.model.beta_network.requires_grad_beta
        self.variance_trainable = (cfg.model.variance_network.requires_grad
                                   and not cfg.train.freeze_variance)
        self._beta_flag = True
        self._step_bodies = {}
        self._mesh_caches = {}  # resolution -> incremental extraction cache

        if is_continue:
            latest = self._latest_checkpoint()
            if latest is not None:
                self.load_checkpoint(latest)
        log.info(SKIPPED)

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def _ckpt_dir(self) -> str:
        d = os.path.join(self.base_exp_dir, "checkpoints")
        os.makedirs(d, exist_ok=True)
        return d

    def _latest_checkpoint(self) -> Optional[str]:
        d = self._ckpt_dir()
        names = sorted(n for n in os.listdir(d) if n.endswith(".ckpt"))
        return os.path.join(d, names[-1]) if names else None

    def save_checkpoint(self) -> str:
        payload = {
            "params": convert.to_numpy(self.params),
            "opt_state": convert.to_numpy(self.opt_state),
            "iter_step": self.iter_step,
            "beta_trainable": self.beta_trainable,
            "variance_trainable": self.variance_trainable,
            "torch_rng": self.generator.get_state().numpy(),
        }
        path = os.path.join(self._ckpt_dir(), f"ckpt_{self.iter_step:0>6d}.ckpt")
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        log.info("saved checkpoint %s", path)
        return path

    def load_checkpoint(self, path: str):
        """Loads a checkpoint of the port or of the JAX trainer. A JAX
        checkpoint's random key does not carry over: the draws continue from
        this runner's generator."""
        payload = convert.load_checkpoint(path, self.device)
        convert.check_like(payload["params"], self.params)
        self.params = payload["params"]
        self.opt_state = payload["opt_state"]
        self.iter_step = payload["iter_step"]
        self.beta_trainable = bool(payload.get("beta_trainable", self.beta_trainable))
        self.variance_trainable = (bool(payload.get("variance_trainable", True))
                                   and not self.cfg.train.freeze_variance)
        if "torch_rng" in payload:
            self.generator.set_state(torch.as_tensor(payload["torch_rng"]))
        if self.is_finetune:  # a finetune restarts the schedule clock
            self.iter_step = 0
        log.info("loaded checkpoint %s (iter %d)", path, self.iter_step)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _window_size(self) -> int:
        """Largest metric-flush window dividing every periodic frequency."""
        t = self.cfg.train
        g = math.gcd(math.gcd(t.report_freq, t.save_freq), math.gcd(t.val_freq, t.val_mesh_freq))
        for k in (50, 40, 25, 20, 10, 8, 5, 4, 2, 1):
            if g % k == 0:
                return k
        return 1

    def _schedules_at(self, step: int) -> sched_mod.StepSchedules:
        c = self.cfg.color_loss
        return sched_mod.compute_step_schedules(
            step, self.cfg.train,
            c.color_base_weight, c.color_weight, c.color_pixel_weight, c.color_patch_weight,
            is_finetune=self.is_finetune, reg_weights_schedule=self.reg_weights_schedule,
            same_lr=self.cfg.train.same_lr, beta_trainable=self.beta_trainable,
            variance_trainable=self.variance_trainable)

    def step_body(self, s: sched_mod.StepSchedules):
        """The step body of an iteration with schedule values ``s``: with the
        blending branches where a blending weight is positive, without them
        otherwise. One body per mode, built at first use."""
        blending = s.color_pixel_weight > 0 or s.color_patch_weight > 0
        if blending not in self._step_bodies:
            self._step_bodies[blending] = build_step_body(self.cfg, self.renderer,
                                                          blending=blending)
        return self._step_bodies[blending]

    def train(self):
        n_img = self.dataset.n_images
        perm_rng = np.random.RandomState(0)
        image_perm = perm_rng.permutation(n_img)
        # resume: replay the permutation stream up to iter_step
        for _ in range(self.iter_step // n_img):
            image_perm = perm_rng.permutation(n_img)

        window = self._window_size()
        log_dir = os.path.join(self.base_exp_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        t_start = time.time()
        with open(os.path.join(log_dir, "metrics.jsonl"), "a") as metrics_log:
            while self.iter_step < self.end_iter:
                k = min(window, self.end_iter - self.iter_step)
                rows = []
                for _ in range(k):
                    s = self._schedules_at(self.iter_step)
                    body = self.step_body(s)
                    img_idx = int(image_perm[self.iter_step % n_img])
                    if (self.iter_step + 1) % n_img == 0:
                        image_perm = perm_rng.permutation(n_img)
                    m = body(self.params, self.opt_state, self.dataset.scene, img_idx,
                             dataclasses.asdict(s), self.generator)
                    rows.append(torch.stack([m[name] for name in METRIC_KEYS]))
                    self.iter_step += 1
                mat = torch.stack(rows).cpu().numpy()  # one [k, M] transfer
                for j in range(k):
                    it = self.iter_step - k + 1 + j
                    m = dict(zip(METRIC_KEYS, mat[j].tolist()))
                    metrics_log.write(json.dumps({"iter": it, **m}) + "\n")
                    self._post_step_host(it, m, t_start)
                metrics_log.flush()
                self._periodic_actions(k)

    def _periodic_actions(self, k: int):
        """Saves a checkpoint, and writes the validation meshes, when a
        multiple of save_freq or val_mesh_freq lies in the last window of k
        iterations."""
        t = self.cfg.train
        hit = lambda freq: freq > 0 and self.iter_step // freq > (self.iter_step - k) // freq
        if hit(t.save_freq):
            self.save_checkpoint()
        if hit(t.val_mesh_freq):
            try:
                self.validate_mesh()
                self.extract_udf_mesh(world_space=True, dist_threshold_ratio=2.0)
            except Exception:  # a validation mesh must not end the training
                log.exception("mesh extraction failed at iter %d", self.iter_step)

    def _post_step_host(self, it: int, m: Dict[str, float], t_start: float):
        """Host-side bookkeeping of one iteration, at metric-flush time."""
        tcfg = self.cfg.train
        if not np.isfinite(m["loss"]):
            path = self.save_checkpoint()
            raise FloatingPointError(f"non-finite loss at iter {it}: {m}; state saved to {path}")
        # beta/variance trainability state machine
        if (m["variance"] < 2 * m["beta"] and m["variance"] < 0.01 and self._beta_flag
                and self.variance_trainable):
            log.info("make beta trainable (iter %d)", it)
            self.beta_trainable = True
            self._beta_flag = False
        if not self.variance_trainable and it > 20000 and not tcfg.freeze_variance:
            self.variance_trainable = True

        if it % tcfg.report_freq == 0:
            ips = it / max(time.time() - t_start, 1e-9)
            log.info("iter %d loss=%.4f color=%.4f eik=%.4f psnr=%.2f var=%.5f beta=%.5f "
                     "ws=%.3f udf_min=%.5f (%.1f it/s)",
                     it, m["loss"], m["color_total_loss"], m["gradient_error"], m["psnr"],
                     m["variance"], m["beta"], m["weight_sum"], m["udf_min"], ips)

    # ------------------------------------------------------------------
    # mesh extraction
    # ------------------------------------------------------------------

    def _bbox(self):
        return (np.asarray(self.dataset.object_bbox_min, np.float32),
                np.asarray(self.dataset.object_bbox_max, np.float32))

    def _to_world(self, verts: np.ndarray) -> np.ndarray:
        sm = self.dataset.scale_mats_np[0]
        return verts * sm[0, 0] + sm[:3, 3][None]

    def _out_path(self, sub: str, name: str) -> str:
        out = os.path.join(self.base_exp_dir, sub)
        os.makedirs(out, exist_ok=True)
        return os.path.join(out, name)

    def validate_mesh(self, world_space: bool = True, resolution: int = 256,
                      threshold: float = 0.005) -> str:
        """Classic marching cubes on the raw distance grid of the object's
        bounding box, written to ``meshes/``.

        model_type 'neus': classic MC runs on the NEGATED signed field at
        level 0 (inside positive after negation) instead of thresholding an
        unsigned field."""
        bound_min, bound_max = self._bbox()
        u = mesh_grid.extract_fields(self.params, self.cfg.model.udf_network,
                                     bound_min, bound_max, resolution)
        if self.model_type == "neus":
            u, threshold = -u, 0.0
        verts, faces = mesh_mc.marching_cubes_classic(u, threshold)
        verts = verts / (resolution - 1.0) * (bound_max - bound_min)[None] + bound_min[None]
        if world_space:
            verts = self._to_world(verts)
        path = self._out_path(
            "meshes", f"{self.iter_step:0>8d}_thresh{threshold:.4f}_res{resolution}.ply")
        export_ply(path, verts, faces)
        return path

    def extract_udf_mesh(self, world_space: bool = False, resolution: int = 256,
                         dist_threshold_ratio: float = 1.0, algorithm: str = "tets",
                         timings: Optional[Dict[str, float]] = None) -> str:
        """MeshUDF gradient-aware extraction, written to ``udf_meshes/``.

        With cfg.train.incremental_mesh, successive extractions at one
        resolution re-query only the voxels around the previous surface
        (one cache per resolution). ``timings`` receives the host-clock
        seconds of each stage (``meshudf.get_mesh_udf``)."""
        cache = None
        if self.cfg.train.incremental_mesh:
            cache = self._mesh_caches.setdefault(resolution, {})
        timings = {} if timings is None else timings
        verts, faces = get_mesh_udf(
            self.params, self.cfg.model.udf_network, resolution=resolution,
            dist_threshold_ratio=dist_threshold_ratio, cache=cache,
            signed=self.model_type == "neus", algorithm=algorithm, timings=timings)
        log.info("extract_udf_mesh %d³ at iter %d: %d faces in %.1f s (%s)", resolution,
                 self.iter_step, len(faces), sum(timings.values()),
                 ", ".join(f"{k} {v:.1f} s" for k, v in timings.items()))
        if world_space:
            verts = self._to_world(verts)
        suffix = "" if algorithm == "tets" else f"_{algorithm}"
        path = self._out_path("udf_meshes",
                              f"udf_res{resolution}_step{self.iter_step}{suffix}.ply")
        export_ply(path, verts, faces)
        return path

    def validate_fields(self, resolution: int = 128) -> str:
        """The distance grid of the object's bounding box, to ``fields/`` as .npy."""
        bound_min, bound_max = self._bbox()
        u = mesh_grid.extract_fields(self.params, self.cfg.model.udf_network,
                                     bound_min, bound_max, resolution)
        path = self._out_path("fields", f"{self.iter_step:0>8d}_dist.npy")
        np.save(path, u)
        return path
