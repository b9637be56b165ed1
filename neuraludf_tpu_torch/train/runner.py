"""Experiment runner: training and mesh extraction (counterpart of
``neuraludf_tpu/train/runner.py``).

The host computes the schedules, drives the beta/variance trainability
state machine, logs, and saves checkpoints. Training runs in windows of
iterations, as the JAX runner's: a full window whose iterations share one
step body goes through ``step.build_train_window`` (on a CUDA device,
replays of a captured CUDA graph); a window where blending switches on, a
shorter last window, and blending windows without
``train.blend_scan_window`` step one eager iteration at a time. Either way
a window's schedules and views go to the device at once, its metrics come
back in one transfer, and every iteration's scalars go to
``<exp>/logs/metrics.jsonl``; a ``StallWatchdog`` warns when no window ends
for ``train.stall_warn_s`` seconds. Every ``val_freq`` iterations the runner
renders a validation view (``validate``: colour, pixel-blended colour,
normals, depth), every ``val_mesh_freq`` iterations it writes the classic
and the MeshUDF mesh of the field (``validate_mesh``, ``extract_udf_mesh``),
and with ``vis_ray`` the ray statistics of a column of pixels
(``visualize_one_ray``). Renders and grids run on the runner's device; a
validation render moves to the host once per window of up to 8 chunks.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import pickle
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import convert
from ..config import Config
from ..data.dataset import Dataset, near_far_from_sphere, ref_src_info
from ..data.png import write_png
from ..mesh import grid as mesh_grid
from ..mesh import mc as mesh_mc
from ..mesh.meshudf import get_mesh_udf
from ..mesh.ply import export_ply
from ..nets import fields
from ..render.projector import camera_inverse
from ..render.renderer import RenderOptions, UDFRenderer
from ..utils.hdf5 import write_dataset
from ..utils.plot import plot_curves
from ..utils.watchdog import StallWatchdog
from . import schedules as sched_mod
from .colormap import colorize_depth
from .optim import init_adam_state
from .step import METRIC_KEYS, build_step_body, build_train_window

log = logging.getLogger(__name__)

VAL_WINDOW = 8  # validation chunks per host transfer


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


def resolve_device(name: str) -> torch.device:
    """A device named on a command line ("cuda", "cuda:<i>" or "cpu"); a
    CUDA one must exist (``default_device``)."""
    dev = torch.device(name)
    return default_device(dev.index or 0) if dev.type == "cuda" else dev


class Runner:
    def __init__(self, cfg: Config, mode: str = "train", *, is_continue: bool = False,
                 is_finetune: bool = False, reg_weights_schedule: bool = False,
                 vis_ray: bool = False, seed: int = 0, device=None,
                 dataset: Optional[Dataset] = None):
        """device: cuda:0 unless given (tests pass "cpu"). A ``mode``
        starting with "train" snapshots the sources (``file_backup``).
        ``dataset``, already loaded on ``device``, replaces the one the
        configuration names (the multi-scan runner's scans share theirs)."""
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
        self.vis_ray = vis_ray

        self.base_exp_dir = os.path.join(cfg.general.base_exp_dir, cfg.general.expname)
        os.makedirs(self.base_exp_dir, exist_ok=True)

        self.dataset = dataset if dataset is not None else Dataset(cfg.dataset, self.device)
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
        self._window_fns = {}  # (blending, window, unroll) -> step.TrainWindow
        self._mesh_caches = {}  # resolution -> incremental extraction cache

        if is_continue:
            latest = self._latest_checkpoint()
            if latest is not None:
                self.load_checkpoint(latest)
        if mode.startswith("train"):
            self.file_backup()

    def file_backup(self):
        """Copy the ``.py`` files of each directory in
        ``cfg.general.recording`` (one level, not recursive) and the
        configuration's repr into ``<exp>/recording/``."""
        rec_dir = os.path.join(self.base_exp_dir, "recording")
        os.makedirs(rec_dir, exist_ok=True)
        for dir_name in self.cfg.general.recording:
            if not os.path.isdir(dir_name):
                continue
            cur = os.path.join(rec_dir, dir_name)
            os.makedirs(cur, exist_ok=True)
            for fname in os.listdir(dir_name):
                if fname.endswith(".py"):
                    try:
                        shutil.copyfile(os.path.join(dir_name, fname), os.path.join(cur, fname))
                    except OSError:
                        log.warning("file_backup: could not copy %s/%s", dir_name, fname)
        with open(os.path.join(rec_dir, "config.txt"), "w") as f:
            f.write(repr(self.cfg))

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def _ckpt_dir(self) -> str:
        d = os.path.join(self.base_exp_dir, "checkpoints")
        os.makedirs(d, exist_ok=True)
        return d

    def checkpoint_names(self) -> list:
        """The names of the checkpoints to resume from, oldest first. crash_*
        checkpoints (a multi-scan run's, saved for autopsy when a loss turns
        non-finite) are never among them."""
        return sorted(n for n in os.listdir(self._ckpt_dir())
                      if n.startswith("ckpt_") and n.endswith(".ckpt"))

    def _latest_checkpoint(self) -> Optional[str]:
        names = self.checkpoint_names()
        return os.path.join(self._ckpt_dir(), names[-1]) if names else None

    def save_checkpoint(self, prefix: str = "ckpt") -> str:
        """``<exp>/checkpoints/<prefix>_<iter>.ckpt``."""
        payload = {
            "params": convert.to_numpy(self.params),
            "opt_state": convert.to_numpy(self.opt_state),
            "iter_step": self.iter_step,
            "beta_trainable": self.beta_trainable,
            "variance_trainable": self.variance_trainable,
            "torch_rng": self.generator.get_state().numpy(),
        }
        path = os.path.join(self._ckpt_dir(), f"{prefix}_{self.iter_step:0>6d}.ckpt")
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
        self._window_fns = {}  # their graphs hold the tensors just replaced
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
        """Largest window dividing every periodic frequency."""
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
        blending = sched_mod.is_blending(s)
        if blending not in self._step_bodies:
            self._step_bodies[blending] = build_step_body(self.cfg, self.renderer,
                                                          blending=blending)
        return self._step_bodies[blending]

    def _get_window_fn(self, blending: bool, window: int):
        """The window of ``window`` iterations of one body, built (and on a
        CUDA device captured) at first use; ``train.scan_unroll`` step bodies
        a graph, lowered to a divisor of the window."""
        unroll = max(1, self.cfg.train.scan_unroll)
        while window % unroll != 0:
            unroll -= 1
        key = (blending, window, unroll)
        if key not in self._window_fns:
            self._window_fns[key] = build_train_window(self.cfg, self.renderer,
                                                       blending=blending, window=window,
                                                       unroll=unroll)
        return self._window_fns[key]

    def train(self, report_hook=None):
        """Trains to ``end_iter``. ``report_hook(it, metrics)`` is called every
        ``report_freq`` iterations with that iteration's metric floats."""
        n_img = self.dataset.n_images
        perm_rng = np.random.RandomState(0)
        image_perm = perm_rng.permutation(n_img)
        # resume: replay the permutation stream up to iter_step
        for _ in range(self.iter_step // n_img):
            image_perm = perm_rng.permutation(n_img)

        def next_img_indices(k: int) -> np.ndarray:
            nonlocal image_perm
            out = np.empty((k,), np.int64)
            for j in range(k):
                step = self.iter_step + j
                out[j] = image_perm[step % n_img]
                if (step + 1) % n_img == 0:
                    image_perm = perm_rng.permutation(n_img)
            return out

        window = self._window_size()
        log_dir = os.path.join(self.base_exp_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        t_start = time.time()
        watchdog = StallWatchdog(self.cfg.train.stall_warn_s,
                                 tag_fn=lambda: f"iter {self.iter_step}").start()
        try:
            with open(os.path.join(log_dir, "metrics.jsonl"), "a") as metrics_log:
                while self.iter_step < self.end_iter:
                    k = min(window, self.end_iter - self.iter_step)
                    mat = self._train_window(k, window, next_img_indices(k)).cpu().numpy()
                    watchdog.beat()
                    for j in range(k):
                        it = self.iter_step - k + 1 + j
                        m = dict(zip(METRIC_KEYS, mat[j].tolist()))
                        metrics_log.write(json.dumps({"iter": it, **m}) + "\n")
                        self._post_step_host(it, m, t_start, report_hook)
                    metrics_log.flush()
                    self._periodic_actions(k)
        finally:
            watchdog.stop()

    def _train_window(self, k: int, window: int, img_idxs: np.ndarray) -> torch.Tensor:
        """k iterations from iter_step on: their metric rows [k, M] on the
        device. A full window of one body is a ``build_train_window`` call;
        a boundary window (blending switches on within it), a shorter last
        window, and a blending window without ``blend_scan_window`` step one
        iteration at a time, as the JAX runner's do."""
        scheds = [self._schedules_at(self.iter_step + j) for j in range(k)]
        first, last = sched_mod.is_blending(scheds[0]), sched_mod.is_blending(scheds[-1])
        rows = torch.from_numpy(sched_mod.schedule_rows(scheds)).to(self.device)
        idxs = torch.from_numpy(img_idxs).to(self.device)
        scene = self.dataset.scene
        if first == last and k == window and (self.cfg.train.blend_scan_window or not first):
            window_fn = self._get_window_fn(first, k)
            mat = window_fn(self.params, self.opt_state, scene, idxs, self.generator, rows)
            self.iter_step += k
            return mat
        out = []
        for j in range(k):
            m = self.step_body(scheds[j])(self.params, self.opt_state, scene, idxs[j], rows[j],
                                          self.generator)
            out.append(torch.stack([m[name] for name in METRIC_KEYS]))
            self.iter_step += 1
        return torch.stack(out)

    def _periodic_actions(self, k: int):
        """The actions whose frequency has a multiple in the last window of k
        iterations: the ray statistics (``vis_ray``, every 2 val_mesh_freq),
        a validation render (val_freq), a checkpoint (save_freq) and the
        validation meshes (val_mesh_freq). A failed render or mesh is logged
        and training goes on. The checkpoint follows the render, whose random
        draws it then holds, so a resumed run continues the same stream."""
        t = self.cfg.train
        hit = lambda freq: freq > 0 and self.iter_step // freq > (self.iter_step - k) // freq
        if self.vis_ray and hit(t.val_mesh_freq * 2):
            try:
                H, W = self.dataset.H, self.dataset.W
                idx = min(33, self.dataset.n_images - 1)
                for dy in range(-H // 4, H // 4, max(20, H // 8)):
                    self.visualize_one_ray(idx, W // 2, H // 2 + dy)
            except Exception:  # a validation plot must not end the training
                log.exception("vis_ray failed at iter %d", self.iter_step)
        if hit(t.val_freq):
            try:
                self.validate()
            except Exception:  # a validation render must not end the training
                log.exception("validate failed at iter %d", self.iter_step)
        if hit(t.save_freq):
            self.save_checkpoint()
        if hit(t.val_mesh_freq):
            try:
                self.validate_mesh()
                self.extract_udf_mesh(world_space=True, dist_threshold_ratio=2.0)
            except Exception:  # a validation mesh must not end the training
                log.exception("mesh extraction failed at iter %d", self.iter_step)

    def _post_step_host(self, it: int, m: Dict[str, float], t_start: float, report_hook=None):
        """Host-side bookkeeping of one iteration, at metric-flush time."""
        tcfg = self.cfg.train
        if not np.isfinite(m["loss"]):
            path = self.save_checkpoint()
            raise FloatingPointError(f"non-finite loss at iter {it}: {m}; state saved to {path}")
        self.update_trainability(it, m)
        if it % tcfg.report_freq == 0:
            ips = it / max(time.time() - t_start, 1e-9)
            log.info("iter %d loss=%.4f color=%.4f eik=%.4f psnr=%.2f var=%.5f beta=%.5f "
                     "ws=%.3f udf_min=%.5f (%.1f it/s)",
                     it, m["loss"], m["color_total_loss"], m["gradient_error"], m["psnr"],
                     m["variance"], m["beta"], m["weight_sum"], m["udf_min"], ips)
            if report_hook:
                report_hook(it, m)

    def update_trainability(self, it: int, m: Dict[str, float]):
        """The beta/variance trainability state machine after iteration it
        with metrics m: beta becomes trainable once the variance falls below
        2 beta and 0.01; the variance after 20,000 iterations."""
        if (m["variance"] < 2 * m["beta"] and m["variance"] < 0.01 and self._beta_flag
                and self.variance_trainable):
            log.info("make beta trainable (iter %d)", it)
            self.beta_trainable = True
            self._beta_flag = False
        if not self.variance_trainable and it > 20000 and not self.cfg.train.freeze_variance:
            self.variance_trainable = True

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

    def save_hdf5(self, resolution: int = 128) -> str:
        """The distance grid at (resolution + 1)³ over the object's bounding
        box, divided by its maximum and halved, as the float32 dataset
        ``"{resolution}_sdf"`` of ``hdf5/out.hdf5``."""
        bound_min, bound_max = self._bbox()
        u = mesh_grid.extract_fields(self.params, self.cfg.model.udf_network,
                                     bound_min, bound_max, resolution + 1)
        path = self._out_path("hdf5", "out.hdf5")
        write_dataset(path, f"{resolution}_sdf", u / u.max() * 0.5)
        return path

    # ------------------------------------------------------------------
    # validation renders
    # ------------------------------------------------------------------

    def render_chunk(self, rays_o: torch.Tensor, rays_d: torch.Tensor, img_idx: int, *,
                     pixel_blending: bool, cos_anneal: float) -> Dict[str, Any]:
        """One chunk of rays [B, 3] through the renderer, without gradient.
        With ``pixel_blending`` the nearest 8 source views of ``img_idx`` are
        warped in (pixel blending only, as the reference's validation does).
        Perturbed unless the configuration's ``perturb`` is 0; the draws come
        from the runner's generator."""
        near, far = near_far_from_sphere(rays_o, rays_d)
        blending = None
        if pixel_blending:
            ref_c2w, src_c2ws, src_intr, src_images = ref_src_info(self.dataset.scene, img_idx)
            blending = {"color_maps": src_images, "w2cs": camera_inverse(src_c2ws),
                        "intrinsics": src_intr, "query_c2w": ref_c2w, "rays_uv": None,
                        "img_index": None}
        opts = RenderOptions(perturb=self.cfg.model.udf_renderer.perturb > 0,
                             pixel_blending=pixel_blending)
        background = (torch.ones((1, 3), device=rays_o.device)
                      if self.cfg.train.use_white_bkgd else None)
        with torch.no_grad():
            return self.renderer.render(
                self.params, rays_o, rays_d, near, far, generator=self.generator,
                cos_anneal_ratio=cos_anneal, flip_saturation=1.0, background_rgb=background,
                blending=blending, opts=opts)

    @staticmethod
    def image_rows(ret: Dict[str, Any]) -> torch.Tensor:
        """A chunk's per-pixel outputs [B, 10]: colour, pixel-blended colour
        (zeros without blending), the weighted normal inside the unit sphere,
        depth."""
        n_fg = ret["gradients_flip"].shape[1]
        normal = torch.sum(ret["gradients_flip"] * ret["weights"][:, :n_fg, None]
                           * ret["inside_sphere"][..., None], dim=1)
        color_pixel = ret["color_pixel"]
        if color_pixel is None:
            color_pixel = torch.zeros_like(ret["color"])
        return torch.cat([ret["color"], color_pixel, normal, ret["depth"]], dim=-1)

    def render_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor, img_idx: int, *,
                    pixel_blending: bool, cos_anneal: float) -> np.ndarray:
        """Rays [N, 3] in chunks of ``batch_size * 8``, windows of up to 8
        chunks, one host transfer per window: returns [N, 10] (``image_rows``).
        The last window is padded with zero origins and unit directions."""
        bs = self.cfg.train.batch_size * 8
        n = rays_o.shape[0]
        n_chunks = min(VAL_WINDOW, -(-n // bs))
        step = bs * n_chunks
        pad = (-n) % step
        dev = rays_o.device
        rays_o = torch.cat([rays_o, torch.zeros((pad, 3), device=dev)])
        rays_d = torch.cat([rays_d, torch.ones((pad, 3), device=dev)])
        out = []
        for i in range(0, n + pad, step):
            rows = [self.image_rows(self.render_chunk(ro, rd, img_idx,
                                                      pixel_blending=pixel_blending,
                                                      cos_anneal=cos_anneal))
                    for ro, rd in zip(rays_o[i:i + step].split(bs), rays_d[i:i + step].split(bs))]
            out.append(torch.cat(rows).cpu().numpy())  # one transfer per window
        return np.concatenate(out)[:n]

    def validate(self, idx: int = -1, resolution_level: int = -1, only_color: bool = False):
        """Render view ``idx`` (drawn from the runner's generator if < 0) at
        ``resolution_level`` (the configuration's if < 0). Writes the
        colour, the pixel-blended colour (more than 8 views) and the ground
        truth stacked to ``validations_fine/``, the normals in camera space
        to ``normals/`` and the depth in the plasma map to ``depth/``; with
        ``only_color`` the colour and the ground truth to ``novel_view/``."""
        if idx < 0:
            idx = int(torch.randint(self.dataset.n_images, (1,), generator=self.generator,
                                    device=self.generator.device))
        if resolution_level < 0:
            resolution_level = self.cfg.train.validate_resolution_level
        rays_o, rays_d = self.dataset.gen_rays_at(idx, resolution_level)
        H, W, _ = rays_o.shape
        pixel_blending = self.dataset.n_images > 8
        out = self.render_rays(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), idx,
                               pixel_blending=pixel_blending,
                               cos_anneal=sched_mod.cos_anneal_ratio(self.iter_step,
                                                                     self.cfg.train))
        img_fine = (out[:, 0:3].reshape(H, W, 3) * 256).clip(0, 255)
        rot = np.linalg.inv(self.dataset.scene["poses"][idx, :3, :3].cpu().numpy())
        normal_img = ((rot[None] @ out[:, 6:9, None]).reshape(H, W, 3) * 128 + 128).clip(0, 255)
        pred_depth = out[:, 9].reshape(H, W)
        gt = self.dataset.image_at(idx, resolution_level)
        name = f"{self.iter_step:0>8d}_{idx}.png"
        for sub in ("validations_fine", "normals", "depth"):
            os.makedirs(os.path.join(self.base_exp_dir, sub), exist_ok=True)

        if only_color:
            write_png(self._out_path("novel_view", f"pred_{idx}.png"), img_fine.astype(np.uint8))
            write_png(self._out_path("novel_view", f"gt_{idx}.png"), gt)
            return
        rgbs = [img_fine]
        if pixel_blending:
            rgbs.append((out[:, 3:6].reshape(H, W, 3) * 256).clip(0, 255))
        write_png(self._out_path("validations_fine", name),
                  np.concatenate(rgbs + [gt]).astype(np.uint8))
        write_png(self._out_path("normals", name), normal_img[:, :, ::-1].astype(np.uint8))
        write_png(self._out_path("depth", name), colorize_depth(pred_depth)[:, :, ::-1])

    def validate_novel_image(self, idx_0: int, idx_1: int, ratio: float, out_idx: int,
                             resolution_level: int = 4) -> str:
        """The colour render from a pose between views idx_0 and idx_1
        (``Dataset.gen_rays_between``), to ``render/<out_idx>.png``, with
        cos_anneal 1 and no blending. The float image is rounded to uint8, as
        ``cv.imwrite`` of a float image does."""
        rays_o, rays_d = self.dataset.gen_rays_between(idx_0, idx_1, ratio, resolution_level)
        H, W, _ = rays_o.shape
        out = self.render_rays(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), idx_0,
                               pixel_blending=False, cos_anneal=1.0)
        img = (out[:, 0:3].reshape(H, W, 3) * 256).clip(0, 255)
        path = self._out_path("render", f"{out_idx}.png")
        write_png(path, np.rint(img).astype(np.uint8))
        return path

    def visualize_one_ray(self, img_idx: int, px: int, py: int) -> str:
        """Render the ray through pixel (px, py) of view img_idx unperturbed
        and write, under ``ray_statis/step<iter>/``, its ten sample curves
        against z - near (udf, |∇udf|, cos(ray, normal), weights, alpha,
        vis_prob, alpha_plus, alpha_minus, alpha_occ, raw_occ: one panel
        each, top to bottom) as ``statis_px<px>_py<py>.png`` and
        ``{"z_vals", "udf", "cos"}`` as the ``.npy`` of the same name."""
        data = self.dataset.gen_one_ray_at(img_idx, px, py)
        rays_o, rays_d = data[:, :3], data[:, 3:6]
        near, far = near_far_from_sphere(rays_o, rays_d)
        with torch.no_grad():
            ret = self.renderer.render(
                self.params, rays_o, rays_d, near, far, generator=self.generator,
                cos_anneal_ratio=sched_mod.cos_anneal_ratio(self.iter_step, self.cfg.train),
                flip_saturation=sched_mod.flip_saturation(self.iter_step, self.cfg.train,
                                                          is_finetune=self.is_finetune),
                opts=RenderOptions(perturb=False))
        row = lambda key: ret[key][0].cpu().numpy()
        z_vals = row("mid_z_vals") - float(near[0, 0])
        curves = {
            "udf values": row("udf"),
            "udf normal magnitude": row("gradient_mag"),
            "cos(ray, normal)": row("true_cos"),
            "weights": row("weights")[:z_vals.shape[0]],
            "alpha": row("alpha"),
            "vis_prob": row("vis_prob"),
            "alpha_plus": row("alpha_plus"),
            "alpha_minus": row("alpha_minus"),
            "alpha_occ": row("alpha_occ"),
            "raw_occ": row("raw_occ"),
        }
        save_dir = os.path.join(self.base_exp_dir, "ray_statis", f"step{self.iter_step}")
        os.makedirs(save_dir, exist_ok=True)
        fig_path = os.path.join(save_dir, f"statis_px{px}_py{py}.png")
        plot_curves(fig_path, z_vals, curves)
        np.save(os.path.join(save_dir, f"statis_px{px}_py{py}.npy"),
                {"z_vals": z_vals, "udf": curves["udf values"],
                 "cos": curves["cos(ray, normal)"]})
        return fig_path
