"""The training step: ray sampling → render → losses → Adam (counterpart of
``neuraludf_tpu/train/step.py``).

``build_loss_fn`` gives the total loss and the 19 ``METRIC_KEYS`` of one
iteration; ``build_step_body`` adds the backward pass and the Adam update
(``adam_step``, or ``flat_adam_step`` with ``cfg.train.flat_adam``).
Built with ``blending=True`` they render the pixel and patch blending
branches of the finetune and add their losses. A body takes its view as an
int or a 0-dim device tensor, and its schedule values as a row of
``schedules.SCHEDULE_KEYS`` (or a dict of floats). The random draws of an
iteration (pixels ``px``/``py`` and the render noise ``t_rand``/``t_r``)
come from a ``torch.Generator`` or are given in ``noise``; ``draw_noise``
makes them outside the body, as the body would.

``build_train_window`` runs ``window`` iterations a call, the counterpart of
the JAX package's ``lax.scan`` window: on a CUDA device as replays of one
CUDA graph of ``unroll`` step bodies over static buffers, into which each
replay's draws, views and schedule rows are copied first; on the CPU the
same bodies run eagerly on the same buffers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch

from ..config import Config
from ..data.dataset import draw_pixels, near_far_from_sphere, ref_src_info, sample_random_rays
from ..losses.color import ColorLossWeights, bce_mask_loss, color_loss, psnr
from ..render.projector import camera_inverse
from ..render.renderer import RenderOptions, UDFRenderer, uniform_draw
from .optim import adam_step, flat_adam_step, leaves, make_lr_fn, make_trainable_fn
from .schedules import SCHEDULE_KEYS, unpack_row

Params = Dict[str, Any]
Schedule = Union[torch.Tensor, Mapping[str, Any]]
Noise = Dict[str, torch.Tensor]

METRIC_KEYS: List[str] = [
    "loss", "color_total_loss", "color_base_loss", "color_loss",
    "color_pixel_loss", "color_patch_loss", "mask_loss", "gradient_error",
    "gradient_error_near_surface", "sparse_error", "psnr", "variance",
    "beta", "gamma", "udf_min", "udf_mean", "weight_sum", "weight_sum_fg_bg",
    "blend_strip_cover",
]


def build_loss_fn(cfg: Config, renderer: UDFRenderer, *, blending: bool = False) -> Callable:
    """loss_fn(params, scene, img_idx, sched, generator=None, noise=None)
    -> (total loss, metrics dict of 0-dim tensors). ``blending`` turns on the
    pixel and patch blending branches whose configured weight is positive.
    ``sched`` is a schedule row or a dict of SCHEDULE_KEYS."""
    tcfg, ccfg = cfg.train, cfg.color_loss
    use_mask_loss = tcfg.mask_weight > 0
    h_patch = ccfg.h_patch_size
    opts = RenderOptions(perturb=cfg.model.udf_renderer.perturb > 0,
                         pixel_blending=blending and ccfg.color_pixel_weight > 0,
                         patch_blending=blending and ccfg.color_patch_weight > 0)
    if opts.patch_blending and cfg.model.udf_renderer.h_patch_size != h_patch:
        # the patch size is configured in two places; they must agree or the
        # warped and the ground-truth patches differ in shape
        raise ValueError("model.udf_renderer.h_patch_size must equal color_loss.h_patch_size "
                         f"({cfg.model.udf_renderer.h_patch_size} != {h_patch})")

    def loss_fn(params: Params, scene, img_idx, sched: Schedule,
                generator: Optional[torch.Generator] = None, noise: Optional[Noise] = None):
        noise = noise or {}
        if isinstance(sched, torch.Tensor):
            sched = unpack_row(sched)
        sample = sample_random_rays(scene, img_idx, tcfg.batch_size, generator=generator,
                                    px=noise.get("px"), py=noise.get("py"),
                                    crop_patch=opts.patch_blending, h_patch_size=h_patch)
        data = sample["rays"]
        rays_o, rays_d = data[:, :3], data[:, 3:6]
        true_rgb, mask = data[:, 6:9], data[:, 9:10]
        mask = (mask > 0.5).to(torch.float32)
        near, far = near_far_from_sphere(rays_o, rays_d)

        blending_inputs = None
        if opts.pixel_blending or opts.patch_blending:
            ref_c2w, src_c2ws, src_intr, src_images = ref_src_info(scene, img_idx)
            blending_inputs = {
                "color_maps": src_images,
                "w2cs": camera_inverse(src_c2ws),
                "intrinsics": src_intr,
                "query_c2w": ref_c2w,
                "rays_uv": sample["rays_ndc_uv"] if opts.patch_blending else None,
                "img_index": None,
            }

        ret = renderer.render(
            params, rays_o, rays_d, near, far, generator=generator, noise=noise,
            cos_anneal_ratio=sched["cos_anneal_ratio"],
            flip_saturation=sched["flip_saturation"],
            background_rgb=(torch.ones((1, 3), device=rays_o.device)
                            if tcfg.use_white_bkgd else None),
            blending=blending_inputs, opts=opts)

        weight_sum = ret["weight_sum"]
        patch_mask = None
        if ret["patch_colors"] is not None:
            patch_mask = (ret["patch_mask"][:, None]
                          * (weight_sum > 0.5).to(torch.float32)) > 0.0
        pixel_mask = mask if use_mask_loss else None
        weights = ColorLossWeights(color_base=sched["color_base_weight"],
                                   color=sched["color_weight"],
                                   color_pixel=sched["color_pixel_weight"],
                                   color_patch=sched["color_patch_weight"])
        closs = color_loss(weights, ret["color_base"], ret["color"], true_rgb,
                           ret["color_pixel"], pixel_mask, ret["patch_colors"],
                           sample["rays_patch_color"], patch_mask,
                           patch_loss_type=ccfg.patch_loss_type, h_patch_size=h_patch)

        mask_l = bce_mask_loss(weight_sum, mask)
        total = (closs["loss"]
                 + mask_l * sched["mask_weight"]
                 + ret["gradient_error_near_surface"] * sched["igr_ns_weight"]
                 + ret["sparse_error"] * sched["sparse_weight"]
                 + ret["gradient_error"] * sched["igr_weight"])

        with torch.no_grad():
            mask_sum = mask.sum() + 1e-5
            ray_mask = (mask[:, 0] > 0.5).to(torch.float32)
            udf_min_per_ray = ret["udf"].min(dim=1).values
            udf_min = torch.sum(udf_min_per_ray * ray_mask) / torch.clamp(ray_mask.sum(), min=1.0)
            metrics = {
                "loss": total,
                "color_total_loss": closs["loss"],
                "color_base_loss": closs["color_base_loss"],
                "color_loss": closs["color_loss"],
                "color_pixel_loss": closs["color_pixel_loss"],
                "color_patch_loss": closs["color_patch_loss"],
                "mask_loss": mask_l,
                "gradient_error": ret["gradient_error"],
                "gradient_error_near_surface": ret["gradient_error_near_surface"],
                "sparse_error": ret["sparse_error"],
                "psnr": psnr(ret["color"], true_rgb, mask),
                "variance": torch.mean(ret["variance"]),
                "beta": torch.mean(ret["beta"]),
                "gamma": torch.mean(ret["gamma"]),
                "udf_min": udf_min,
                "udf_mean": torch.mean(ret["udf"]),
                "weight_sum": torch.sum(ret["weight_sum"] * mask) / mask_sum,
                "weight_sum_fg_bg": torch.sum(ret["weight_sum_fg_bg"] * mask) / mask_sum,
                "blend_strip_cover": ret["blend_strip_cover"],
            }
            metrics = {k: v.detach().reshape(()) for k, v in metrics.items()}
        return total, metrics

    return loss_fn


def param_grads(total: torch.Tensor, params: Params) -> Dict[tuple, torch.Tensor]:
    """d total / d leaf for every parameter leaf (None where unused)."""
    paths, tensors = zip(*leaves(params))
    grads = torch.autograd.grad(total, tensors, allow_unused=True)
    return dict(zip(paths, grads))


def build_step_body(cfg: Config, renderer: UDFRenderer, *, blending: bool = False) -> Callable:
    """body(params, opt_state, scene, img_idx, sched, generator=None,
    noise=None) -> metrics; updates params and opt_state in place."""
    loss_fn = build_loss_fn(cfg, renderer, blending=blending)
    bcfg = cfg.model.beta_network
    adam = flat_adam_step if cfg.train.flat_adam else adam_step

    def body(params, opt_state, scene, img_idx, sched: Schedule, generator=None, noise=None):
        if isinstance(sched, torch.Tensor):
            sched = unpack_row(sched)
        total, metrics = loss_fn(params, scene, img_idx, sched, generator, noise)
        grads = param_grads(total, params)
        lr_fn = make_lr_fn(sched["lr_geo"], sched["lr_main"], sched["lr_main"])
        trainable_fn = make_trainable_fn(bcfg, sched["variance_trainable"],
                                         sched["beta_trainable"])
        adam(params, grads, opt_state, lr_fn, trainable_fn)
        return metrics

    return body


def draw_noise(cfg: Config, scene, generator: torch.Generator) -> Noise:
    """One iteration's draws, in the order, shapes and on the devices in
    which the step body makes them when ``noise`` is not given (pixels, then
    the render's z perturbation and outside jitter), so that a run fed from
    here consumes the generator as an eager run does."""
    rcfg, batch = cfg.model.udf_renderer, cfg.train.batch_size
    px, py = draw_pixels(scene, batch, generator)
    noise = {"px": px, "py": py}
    dev = scene["images"].device
    if rcfg.perturb > 0:
        noise["t_rand"] = uniform_draw((batch, 1), generator, dev, torch.float32) - 0.5
        if rcfg.n_outside > 0:
            noise["t_r"] = uniform_draw((rcfg.n_outside,), generator, dev, torch.float32)
    return noise


def launch_counters() -> tuple:
    """The kernel entry points whose ``launches`` count the kernels a step
    launches (K1, K2, K3)."""
    from ..ops import fused_distance, strip_sample

    return fused_distance.fused_forward, fused_distance.fused_backward, strip_sample.strip_sample


N_WARMUP = 2  # eager units of a window's bodies before their capture


class TrainWindow:
    """``window`` iterations a call over static buffers (``build_train_window``).

    A unit is ``unroll`` consecutive step bodies. On a CUDA device the first
    ``N_WARMUP`` units run eagerly on a side stream (real iterations of the
    run: capture executes nothing, so none is skipped or repeated), then one
    unit is captured into a ``torch.cuda.CUDAGraph`` and every later unit is
    a replay of it. The graph holds the addresses of the parameters, the
    optimizer state and the scene; when the caller hands over other tensors
    it is dropped and captured again after a new warm-up. A capture that
    fails raises. The kernels' launch counts, which Python advances once at
    capture, advance by the capture's count at every replay."""

    def __init__(self, cfg: Config, body: Callable, window: int, unroll: int):
        self.cfg, self.body, self.window, self.unroll = cfg, body, window, unroll
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.bound: Optional[tuple] = None
        self.warm = 0
        self.per_replay: List[tuple] = []
        self.stream = None
        self.static: Optional[Dict[str, Any]] = None

    def __call__(self, params: Params, opt_state: Params, scene, img_idxs: torch.Tensor,
                 generator: Optional[torch.Generator], scheds: torch.Tensor,
                 noise: Optional[Sequence[Noise]] = None) -> torch.Tensor:
        """img_idxs [window] and scheds [window, len(SCHEDULE_KEYS)] on the
        scene's device; ``noise`` (one dict a step) replaces the draws from
        ``generator``. Returns the metric rows [window, len(METRIC_KEYS)] on
        the device; params and opt_state are updated in place."""
        k, u = self.window, self.unroll
        if tuple(img_idxs.shape) != (k,) or tuple(scheds.shape) != (k, len(SCHEDULE_KEYS)):
            raise ValueError(f"a window of {k} takes img_idxs [{k}] and scheds "
                             f"[{k}, {len(SCHEDULE_KEYS)}], got {tuple(img_idxs.shape)} "
                             f"and {tuple(scheds.shape)}")
        if noise is not None and len(noise) != k:
            raise ValueError(f"noise: {len(noise)} draws for a window of {k}")
        dev = scene["images"].device
        rows = torch.empty((k, len(METRIC_KEYS)), dtype=torch.float32, device=dev)
        for r in range(0, k, u):
            draws = [noise[r + j] if noise is not None else draw_noise(self.cfg, scene, generator)
                     for j in range(u)]
            st = self._buffers(draws, dev)
            for j, d in enumerate(draws):
                if d.keys() != st["noise"][j].keys():
                    raise ValueError(f"draws {sorted(d)} differ from the window's "
                                     f"{sorted(st['noise'][j])}")
                for key, t in d.items():
                    st["noise"][j][key].copy_(t)
            st["idx"].copy_(img_idxs[r:r + u])
            st["sched"].copy_(scheds[r:r + u])
            self._run(params, opt_state, scene, dev)
            rows[r:r + u].copy_(st["rows"])
        return rows

    def _buffers(self, draws: Sequence[Noise], dev) -> Dict[str, Any]:
        if self.static is None:
            self.static = {
                "noise": [{key: torch.empty_like(t, device=dev) for key, t in d.items()}
                          for d in draws],
                "idx": torch.zeros((self.unroll,), dtype=torch.long, device=dev),
                "sched": torch.zeros((self.unroll, len(SCHEDULE_KEYS)), dtype=torch.float32,
                                     device=dev),
                "rows": torch.zeros((self.unroll, len(METRIC_KEYS)), dtype=torch.float32,
                                    device=dev),
            }
        return self.static

    def _unit(self, params, opt_state, scene) -> None:
        st = self.static
        rows = [self.body(params, opt_state, scene, st["idx"][j], st["sched"][j],
                          noise=st["noise"][j]) for j in range(self.unroll)]
        st["rows"].copy_(torch.stack([torch.stack([m[name] for name in METRIC_KEYS])
                                      for m in rows]))

    def _run(self, params, opt_state, scene, dev) -> None:
        if dev.type != "cuda":
            self._unit(params, opt_state, scene)
            return
        bound = tuple(t.data_ptr() for tree in (params, opt_state, scene)
                      for _, t in leaves(tree))
        if self.graph is not None and bound != self.bound:
            self.graph, self.warm = None, 0  # captured over tensors that were replaced
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        if self.graph is None and self.warm < N_WARMUP:
            main = torch.cuda.current_stream(dev)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                self._unit(params, opt_state, scene)
            main.wait_stream(self.stream)
            self.warm += 1
            return
        if self.graph is None:
            self._capture(params, opt_state, scene, bound)
        self.graph.replay()
        for kernel, n in self.per_replay:
            kernel.launches += n

    def _capture(self, params, opt_state, scene, bound) -> None:
        kernels = launch_counters()
        before = [kernel.launches for kernel in kernels]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            self._unit(params, opt_state, scene)
        self.per_replay = [(kernel, kernel.launches - n) for kernel, n in zip(kernels, before)]
        for kernel, n in zip(kernels, before):  # the capture launched nothing
            kernel.launches = n
        self.graph, self.bound = graph, bound


def build_train_window(cfg: Config, renderer: UDFRenderer, *, blending: bool, window: int,
                       unroll: int = 1) -> TrainWindow:
    """window_fn(params, opt_state, scene, img_idxs, generator, scheds,
    noise=None) -> metric rows [window, len(METRIC_KEYS)]: ``window``
    iterations, ``unroll`` step bodies a graph (see ``TrainWindow``).
    ``unroll`` must divide ``window``."""
    if unroll < 1 or window % unroll != 0:
        raise ValueError(f"unroll {unroll} must divide window {window}")
    return TrainWindow(cfg, build_step_body(cfg, renderer, blending=blending), window, unroll)
