"""The training step: ray sampling → render → losses → Adam: a frozen copy
of the port's eager step body (``train/step.py``), with Adam leaf by leaf.

``build_loss_fn`` gives the total loss and the 19 ``METRIC_KEYS`` of one
iteration; ``build_step_body`` adds the backward pass and the Adam update.
Built with ``blending=True`` they render the pixel and patch blending
branches of the finetune and add their losses. A body takes its view as an
int or a 0-dim tensor, and its schedule values as a row of
``schedules.SCHEDULE_KEYS`` (or a dict of floats). The random draws of an
iteration (pixels ``px``/``py`` and the render noise ``t_rand``/``t_r``)
are given in ``noise``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import torch

from .config import Config
from .dataset import near_far_from_sphere, ref_src_info, sample_random_rays
from .color import ColorLossWeights, bce_mask_loss, color_loss, psnr
from .projector import camera_inverse
from .renderer import RenderOptions, UDFRenderer
from .optim import adam_step, leaves, make_lr_fn, make_trainable_fn
from .schedules import unpack_row

Params = Dict[str, Any]
Schedule = Union[torch.Tensor, Mapping[str, Any]]
Noise = Dict[str, torch.Tensor]
Grads = Dict[tuple, Optional[torch.Tensor]]

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
    ``sched`` is a schedule row or a dict of SCHEDULE_KEYS. A ``u_mask`` in
    ``noise`` draws 3/4 of the batch from the view's mask."""
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
                                    u_mask=noise.get("u_mask"),
                                    crop_patch=opts.patch_blending, h_patch_size=h_patch)
        data = sample["rays"]
        true_rgb, mask = data[:, 6:9], data[:, 9:10]
        mask = (mask > 0.5).to(torch.float32)
        rows = slice(None)
        rays_o, rays_d = data[rows, :3], data[rows, 3:6]
        near, far = near_far_from_sphere(rays_o, rays_d)
        render_noise = {key: noise[key][rows] if key == "t_rand" else noise[key]
                        for key in ("t_rand", "t_r") if key in noise}

        blending_inputs = None
        if opts.pixel_blending or opts.patch_blending:
            ref_c2w, src_c2ws, src_intr, src_images = ref_src_info(scene, img_idx)
            blending_inputs = {
                "color_maps": src_images,
                "w2cs": camera_inverse(src_c2ws),
                "intrinsics": src_intr,
                "query_c2w": ref_c2w,
                "rays_uv": sample["rays_ndc_uv"][rows] if opts.patch_blending else None,
                "img_index": None,
            }

        ret = renderer.render(
            params, rays_o, rays_d, near, far, generator=generator, noise=render_noise,
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

    def body(params, opt_state, scene, img_idx, sched: Schedule, generator=None, noise=None):
        if isinstance(sched, torch.Tensor):
            sched = unpack_row(sched)
        total, metrics = loss_fn(params, scene, img_idx, sched, generator, noise)
        grads = param_grads(total, params)
        lr_fn = make_lr_fn(sched["lr_geo"], sched["lr_main"], sched["lr_main"])
        trainable_fn = make_trainable_fn(bcfg, sched["variance_trainable"],
                                         sched["beta_trainable"])
        adam_step(params, grads, opt_state, lr_fn, trainable_fn)
        return metrics

    return body
