"""The UDF volume renderer, stage-1 path (counterpart of
``neuraludf_tpu/render/renderer.py``).

Occlusion-aware unsigned-distance rendering (NeuralUDF, CVPR 2023): an
occlusion density from a logistic PDF in the UDF, a visibility probability
``vis_prob`` that the first surface has not been crossed yet, the section
alpha ``alpha_plus * vis_prob + alpha_minus * (1 - vis_prob)``, and
transmittance compositing over the foreground samples followed by the NeRF++
background samples.

The random draws of a render are explicit inputs (``noise``): the z
perturbation ``t_rand`` [B,1] and the outside-z jitter ``t_r`` [n_outside].
Each one missing from ``noise`` is drawn from ``generator``.

``sparse_random_error``, the iso-surface probe on uniform random points that
the JAX ``render`` returns, is a method of its own: no loss reads it, so a
training step does not evaluate it.

The pixel and patch blending branches belong to the blending finetune and
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..config import ModelConfig
from ..nets import fields
from ..numerics import clip
from .alpha import sdf2alpha, transmittance_weights, udf2logistic
from .sampling import (
    _dists_with_tail,
    _ray_points,
    importance_sample_classical,
    importance_sample_mix,
)

Params = Dict[str, Any]

BLENDING_TODO = ("pixel/patch blending is not ported yet "
                 "(ROADMAP: slice 2, items 7-8, projector and strip sampler)")


@dataclass(frozen=True)
class RenderOptions:
    """Static rendering switches."""
    perturb: bool = True
    pixel_blending: bool = False
    patch_blending: bool = False


def _uniform(shape, generator: Optional[torch.Generator], device, dtype) -> torch.Tensor:
    if generator is None:
        raise ValueError("a random draw is needed: pass it in `noise` or give a generator")
    return torch.rand(shape, generator=generator, device=generator.device, dtype=dtype).to(device)


class UDFRenderer:
    """Holds the static configuration; every method is a function of
    (params, inputs)."""

    def __init__(self, model_cfg: ModelConfig):
        self.cfg = model_cfg
        self.rcfg = model_cfg.udf_renderer

    def udf_fn(self, params: Params):
        """Value-only distance queries of the no-grad up-sampling rounds."""
        ucfg = self.cfg.udf_network
        return lambda pts: fields.distance_value(params["udf"], pts, ucfg, role="sampling")[:, 0]

    # -- background (NeRF++) -------------------------------------------------

    def render_core_outside(self, params: Params, rays_o, rays_d, z_vals, sample_dist,
                            background_rgb=None):
        """Inverse-sphere background pass."""
        batch, n = z_vals.shape
        dists = _dists_with_tail(z_vals, sample_dist)
        mid_z = z_vals + dists * 0.5
        pts = _ray_points(rays_o, rays_d, mid_z)  # [B, n, 3]
        if self.rcfg.n_outside > 0:
            dist_to_center = torch.clamp(
                torch.linalg.vector_norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
            pts = torch.cat([pts / dist_to_center, 1.0 / dist_to_center], dim=-1)
        dirs = rays_d[:, None, :].expand(batch, n, 3)
        raw, sampled_color = fields.background_nerf_apply(
            params["nerf"], pts.reshape(batch * n, -1), dirs.reshape(batch * n, 3),
            self.cfg.nerf)
        alpha = 1.0 - torch.exp(-torch.relu(raw.reshape(batch, n)) * dists)
        weights = transmittance_weights(alpha)
        sampled_color = sampled_color.reshape(batch, n, 3)
        color = torch.sum(weights[:, :, None] * sampled_color, dim=1)
        if background_rgb is not None:
            color = color + background_rgb * (1.0 - weights.sum(-1, keepdim=True))
        return {"color": color, "sampled_color": sampled_color, "alpha": alpha,
                "weights": weights}

    # -- core ----------------------------------------------------------------

    def render_core(self, params: Params, rays_o, rays_d, z_vals, sample_dist, *,
                    cos_anneal_ratio=None, background_rgb=None, background_alpha=None,
                    background_sampled_color=None, flip_saturation=0.0,
                    blending: Optional[Dict[str, Any]] = None,
                    opts: RenderOptions = RenderOptions()) -> Dict[str, Any]:
        """Foreground pass."""
        if blending is not None and (opts.pixel_blending or opts.patch_blending):
            raise NotImplementedError(BLENDING_TODO)
        rcfg = self.rcfg
        batch, n = z_vals.shape
        dists = _dists_with_tail(z_vals, sample_dist)
        mid_z = z_vals + dists * 0.5
        pts = _ray_points(rays_o, rays_d, mid_z).reshape(-1, 3)
        dirs = rays_d[:, None, :].expand(batch, n, 3).reshape(-1, 3)

        udf, feature, gradients = fields.distance_value_and_gradient(
            params["udf"], pts, self.cfg.udf_network)  # [BN,1], [BN,F], [BN,3]

        grad_mag = torch.linalg.vector_norm(gradients, dim=-1, keepdim=True)
        grad_norm = gradients / (grad_mag + 1e-5)

        inv_s = clip(fields.variance_inv_s(params["variance"]), 1e-6, 1e6)  # [1]
        beta = clip(fields.beta_value(params["beta"], self.cfg.beta_network.beta_min), 1e-6, 1e6)
        gamma = clip(fields.gamma_value(params["beta"]), 1e-6, 1e6)

        if rcfg.use_norm_grad_for_cosine:
            true_cos = torch.sum(dirs * grad_norm, dim=-1, keepdim=True)
        else:
            true_cos = torch.sum(dirs * gradients, dim=-1, keepdim=True)

        cos = torch.sum(dirs * grad_norm, dim=-1, keepdim=True).detach()
        flip_sign = -torch.sign(cos)
        flip_sign = torch.where(flip_sign == 0, torch.ones_like(flip_sign), flip_sign)

        # occlusion probability along the ray
        raw_occ = udf2logistic(udf, beta, 1.0, 1.0).reshape(batch, n)
        alpha_occ = 1.0 - torch.exp(-torch.relu(raw_occ) * gamma * dists)

        # gradient-direction boost, shifted one sample forward
        vis_mask = (true_cos < 0.01).to(z_vals.dtype).reshape(batch, n)
        vis_mask = torch.cat([vis_mask[:, 1:], torch.ones_like(vis_mask[:, :1])], -1)

        factor = clip(1.0 - alpha_occ + flip_saturation * vis_mask, 0.0, 1.0) + 1e-7
        vis_prob = torch.cumprod(
            torch.cat([torch.ones_like(factor[:, :1]), factor], -1), -1)[:, :-1]
        vis_prob = clip(vis_prob, 0.0, 1.0)

        neg_abs_cos = -torch.abs(true_cos)
        alpha_plus = sdf2alpha(udf, neg_abs_cos, dists.reshape(-1, 1), inv_s, cos_anneal_ratio,
                               sdf2alpha_type=rcfg.sdf2alpha_type).reshape(batch, n)
        alpha_minus = sdf2alpha(-udf, neg_abs_cos, dists.reshape(-1, 1), inv_s,
                                cos_anneal_ratio,
                                sdf2alpha_type=rcfg.sdf2alpha_type).reshape(batch, n)
        alpha = alpha_plus * vis_prob + alpha_minus * (1.0 - vis_prob)

        udf_2d = udf.reshape(batch, n)

        color_base, color_s, _ = fields.residual_color_apply(
            params["color"], pts, grad_norm, dirs, feature, self.cfg.rendering_network)
        sampled_color_base = color_base.reshape(batch, n, 3)
        sampled_color = color_s.reshape(batch, n, 3)

        # eikonal masks
        pts_norm = torch.linalg.vector_norm(pts, dim=-1).reshape(batch, n)
        inside_sphere = (pts_norm < 1.0).to(z_vals.dtype)
        relax_inside = (pts_norm < 1.2).to(z_vals.dtype)
        near_surface = (udf_2d < 0.05).to(z_vals.dtype).detach()

        # compose with the background
        n_fg = n
        if background_alpha is not None:
            alpha = torch.cat([alpha, background_alpha[:, n_fg:]], dim=-1)
            sampled_color_base = torch.cat(
                [sampled_color_base, background_sampled_color[:, n_fg:]], dim=1)
            sampled_color = torch.cat([sampled_color, background_sampled_color[:, n_fg:]], dim=1)

        weights = transmittance_weights(alpha)
        weights_sum = weights.sum(-1, keepdim=True)

        color_base_out = torch.sum(sampled_color_base * weights[:, :, None], dim=1)
        color_out = torch.sum(sampled_color * weights[:, :, None], dim=1)

        depth = torch.sum(mid_z * weights[:, :n_fg], dim=-1, keepdim=True)
        if background_rgb is not None:
            color_out = color_out + background_rgb * (1.0 - weights_sum)

        grad_err_all = (torch.linalg.vector_norm(gradients.reshape(batch, n, 3), dim=-1)
                        - 1.0) ** 2
        gradient_error = torch.sum(relax_inside * grad_err_all) / (torch.sum(relax_inside) + 1e-5)
        gradient_error_near_surface = torch.sum(near_surface * grad_err_all) / (
            torch.sum(near_surface) + 1e-5)

        gradients3 = gradients.reshape(batch, n, 3)
        gradients_flip = flip_sign.reshape(batch, n, 1) * gradients3

        # relu keeps the term finite for signed heads (exp(-s·udf), udf < 0)
        sparse_term = torch.exp(-rcfg.sparse_scale_factor * clip(udf_2d, 0.0))
        if rcfg.sparse_depth_gate > 0.0:
            # spare the samples at the rendered depth on surface rays
            wsum = torch.sum(weights[:, :n_fg], dim=-1, keepdim=True).detach()
            d_surf = depth.detach() / torch.clamp(wsum, min=1e-3)
            protect = (torch.abs(mid_z - d_surf) <= rcfg.sparse_depth_gate) & (wsum > 0.5)
            sparse_term = torch.where(protect, torch.zeros_like(sparse_term), sparse_term)
        sparse_error = torch.mean(torch.sum(sparse_term, dim=1))

        return {
            "color_base": color_base_out,
            "color": color_out,
            "color_pixel": None,
            "patch_colors": None,
            "patch_mask": None,
            "weights": weights,
            "s_val": 1.0 / inv_s,
            "beta": 1.0 / beta,
            "gamma": gamma,
            "depth": depth,
            "gradient_error": gradient_error,
            "gradient_error_near_surface": gradient_error_near_surface,
            "normals": torch.sum(gradients_flip * weights[:, :n_fg, None], dim=1),
            "gradients": gradients3,
            "gradients_flip": gradients_flip,
            "inside_sphere": inside_sphere,
            "udf": udf_2d,
            "gradient_mag": grad_mag.reshape(batch, n),
            "true_cos": true_cos.reshape(batch, n),
            "vis_prob": vis_prob,
            "alpha": alpha[:, :n_fg],
            "alpha_plus": alpha_plus[:, :n_fg],
            "alpha_minus": alpha_minus[:, :n_fg],
            "mid_z_vals": mid_z,
            "dists": dists,
            "sparse_error": sparse_error,
            "alpha_occ": alpha_occ,
            "raw_occ": raw_occ,
            # the strip sampler's coverage; 1 without blending
            "blend_strip_cover": torch.ones((), dtype=z_vals.dtype, device=z_vals.device),
        }

    # -- public entry ----------------------------------------------------------

    def render(self, params: Params, rays_o, rays_d, near, far, *,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Dict[str, torch.Tensor]] = None,
               cos_anneal_ratio=None, flip_saturation=0.0, background_rgb=None,
               blending: Optional[Dict[str, Any]] = None,
               opts: RenderOptions = RenderOptions()) -> Dict[str, Any]:
        """Full forward. near/far: [B,1]."""
        rcfg = self.rcfg
        noise = noise or {}
        batch = rays_o.shape[0]
        dtype, dev = rays_o.dtype, rays_o.device
        near = torch.as_tensor(near, dtype=dtype, device=dev).expand(batch, 1)
        far = torch.as_tensor(far, dtype=dtype, device=dev).expand(batch, 1)

        sample_dist = torch.mean((far - near) / rcfg.n_samples)
        t = torch.linspace(0.0, 1.0, rcfg.n_samples, dtype=dtype, device=dev)
        z_vals = near + (far - near) * t[None, :]

        z_vals_outside = None
        if rcfg.n_outside > 0:
            z_vals_outside = torch.linspace(1e-3, 1.0 - 1.0 / (rcfg.n_outside + 1.0),
                                            rcfg.n_outside, dtype=dtype, device=dev)

        if opts.perturb and rcfg.perturb > 0:
            t_rand = noise.get("t_rand")
            if t_rand is None:
                t_rand = _uniform((batch, 1), generator, dev, dtype) - 0.5
            z_vals = z_vals + t_rand * 2.0 / rcfg.n_samples
            if rcfg.n_outside > 0:
                mids = 0.5 * (z_vals_outside[1:] + z_vals_outside[:-1])
                upper = torch.cat([mids, z_vals_outside[-1:]])
                lower = torch.cat([z_vals_outside[:1], mids])
                t_r = noise.get("t_r")
                if t_r is None:
                    t_r = _uniform(z_vals_outside.shape, generator, dev, dtype)
                z_vals_outside = lower + (upper - lower) * t_r

        if rcfg.n_outside > 0:
            z_vals_outside = far / torch.flip(z_vals_outside, [-1])[None, :] + 1.0 / rcfg.n_samples

        udf_fn = self.udf_fn(params)
        if rcfg.n_importance > 0:
            if rcfg.upsampling_type == "classical":
                z_vals = importance_sample_classical(
                    udf_fn, rays_o, rays_d, z_vals, sample_dist,
                    n_importance=rcfg.n_importance, up_sample_steps=rcfg.up_sample_steps,
                    sdf2alpha_type=rcfg.sdf2alpha_type)
            elif rcfg.upsampling_type == "mix":
                with torch.no_grad():
                    beta = torch.clamp(
                        fields.beta_value(params["beta"], self.cfg.beta_network.beta_min),
                        1e-6, 1e6)
                    gamma = torch.clamp(fields.gamma_value(params["beta"]), 1e-6, 1e6)
                z_vals = importance_sample_mix(
                    udf_fn, rays_o, rays_d, z_vals, sample_dist, beta, gamma,
                    n_importance=rcfg.n_importance, up_sample_steps=rcfg.up_sample_steps,
                    sdf2alpha_type=rcfg.sdf2alpha_type)
            else:
                raise ValueError(rcfg.upsampling_type)

        n_fg = z_vals.shape[-1]

        background_alpha = background_sampled_color = None
        if rcfg.n_outside > 0:
            z_feed = torch.sort(torch.cat([z_vals, z_vals_outside.expand(batch, -1)], dim=-1),
                                dim=-1).values
            ret_outside = self.render_core_outside(params, rays_o, rays_d, z_feed, sample_dist,
                                                   background_rgb)
            background_alpha = ret_outside["alpha"]
            background_sampled_color = ret_outside["sampled_color"]

        ret = self.render_core(
            params, rays_o, rays_d, z_vals, sample_dist,
            cos_anneal_ratio=cos_anneal_ratio, background_rgb=background_rgb,
            background_alpha=background_alpha,
            background_sampled_color=background_sampled_color,
            flip_saturation=flip_saturation, blending=blending, opts=opts)

        out = dict(ret)
        out["variance"] = ret["s_val"]
        out["weight_sum"] = ret["weights"][:, :n_fg].sum(-1, keepdim=True)
        out["weight_sum_fg_bg"] = ret["weights"].sum(-1, keepdim=True)
        out["z_vals"] = z_vals
        return out

    @torch.no_grad()
    def sparse_random_error(self, params: Params, pts_random: torch.Tensor) -> torch.Tensor:
        """Iso-surface regulariser on uniform random points in [-1, 1]^3
        ([P, 3]; JAX's ``render`` draws 1,024): the mean of exp(-k·udf) over
        the points with udf < 0.01, or 0 when 10 or fewer are that close.
        JAX's ``render`` returns it under the same key; no loss reads it."""
        udf = fields.distance_value(params["udf"], pts_random, self.cfg.udf_network)
        m = (udf < 0.01).to(udf.dtype)
        cnt = m.sum()
        masked_mean = torch.sum(
            torch.exp(-self.rcfg.sparse_scale_factor * torch.clamp(udf, min=0.0)) * m
        ) / torch.clamp(cnt, min=1.0)
        return torch.where(cnt > 10, masked_mean, torch.zeros_like(masked_mean))
