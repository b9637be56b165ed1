"""The UDF volume renderer (counterpart of
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

The blending finetune adds, per sample, the source views' colours at the
sample's projection (pixel blending) and at the homography warp of the
reference patch (patch blending), fused over the views with learned weights
(``fields.color_blend``). ``warp_sampler`` picks how the images are sampled:
``gather`` warps all samples with ``ops.interp``; ``strip`` warps the
``blend_top_k`` highest-weight samples of each ray through
``ops.strip_sample`` (kernel K3 for CUDA tensors, its plain version for CPU
tensors); ``auto`` is ``strip`` for CUDA tensors and ``gather`` on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..config import ModelConfig
from ..nets import fields
from ..numerics import clip, cumprod_nonzero
from ..ops.strip_sample import strip_sample
from .alpha import sdf2alpha, transmittance_weights, udf2logistic
from .projector import PatchProjector, camera_inverse
from .sampling import (
    _dists_with_tail,
    _ray_points,
    importance_sample_classical,
    importance_sample_mix,
)

Params = Dict[str, Any]


@dataclass(frozen=True)
class RenderOptions:
    """Static rendering switches."""
    perturb: bool = True
    pixel_blending: bool = False
    patch_blending: bool = False


def uniform_draw(shape, generator: Optional[torch.Generator], device, dtype) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` from ``generator``, on its device, moved to
    ``device``."""
    if generator is None:
        raise ValueError("a random draw is needed: pass it in `noise` or give a generator")
    return torch.rand(shape, generator=generator, device=generator.device, dtype=dtype).to(device)


class UDFRenderer:
    """Holds the static configuration; every method is a function of
    (params, inputs)."""

    def __init__(self, model_cfg: ModelConfig):
        self.cfg = model_cfg
        self.rcfg = model_cfg.udf_renderer
        self.projector = PatchProjector(self.rcfg.h_patch_size)

    def udf_fn(self, params: Params):
        """Value-only distance queries of the no-grad up-sampling rounds."""
        ucfg = self.cfg.udf_network
        return lambda pts: fields.distance_value(params["udf"], pts, ucfg, role="sampling")[:, 0]

    # -- blending warp sampler -------------------------------------------------

    def _strip_active(self, blending) -> bool:
        """Whether the blending warps go through ``ops.strip_sample``."""
        mode = self.rcfg.warp_sampler
        if mode == "gather":
            return False
        if mode == "strip":
            if self.rcfg.blend_top_k <= 0:
                raise ValueError("warp_sampler='strip' needs blend_top_k > 0")
            return True
        if mode != "auto":
            raise ValueError(f"warp_sampler must be auto|gather|strip, got {mode!r}")
        return self.rcfg.blend_top_k > 0 and blending["color_maps"].is_cuda

    def _blend_warp_strip(self, blending, pts3, normals_w, alpha_fg, opts):
        """Warp the blend_top_k highest-weight samples of each ray through
        ``strip_sample``. The warp positions are constants with respect to
        the networks, so sampling is forward-only.

        Returns (idx [B, K] sample indices in z order, pix_color [B, K, V, 3]
        or None, pix_mask, patch_color [B, K, V, 3, Npx] or None, patch_mask,
        coverage = the share of warp positions that lie in their image)."""
        rcfg = self.rcfg
        batch, n, _ = pts3.shape
        chunk = max(1, min(rcfg.blend_chunk, rcfg.blend_top_k, n))
        k = min(rcfg.blend_top_k, n)
        k -= k % chunk
        imgs = blending["color_maps"]  # [V, 3, H, W]
        v, _, h, w_img = imgs.shape

        with torch.no_grad():
            w_sel = transmittance_weights(alpha_fg)  # [B, n]
            # a stable descending sort keeps the lower index among equal
            # weights, the rule of jax.lax.top_k (torch.topk promises none)
            idx = torch.sort(w_sel, dim=-1, descending=True, stable=True).indices[:, :k]
            idx = torch.sort(idx, dim=-1).values  # z order
            take3 = lambda a: torch.gather(a, 1, idx[..., None].expand(-1, -1, 3))
            pts_k = take3(pts3)  # [B, K, 3]

            parts_x, parts_y = [], []
            npx = 0
            patch_geo_mask = pix_geo_valid = None
            if opts.patch_blending:
                pgx, pgy, patch_geo_mask = self.projector.patch_warp_positions(
                    pts_k, blending["rays_uv"], take3(normals_w), (h, w_img),
                    blending["intrinsics"][0], blending["intrinsics"], blending["query_c2w"],
                    camera_inverse(blending["w2cs"]), detach_normal=True)
                npx = pgx.shape[-1]  # [V, B, K, Npx]
                parts_x.append(pgx)
                parts_y.append(pgy)
            if opts.pixel_blending:
                xg, yg, pix_geo_valid = self.projector.pixel_warp_positions(
                    pts_k, blending["intrinsics"], blending["w2cs"], (h, w_img))  # [V, B, K]
                parts_x.append(xg[..., None])
                parts_y.append(yg[..., None])

            gx = torch.cat(parts_x, dim=-1)  # [V, B, K, stride]
            gy = torch.cat(parts_y, dim=-1)
            stride = gx.shape[-1]
            nchunks = k // chunk
            pc = chunk * stride
            colors, in_img = strip_sample(imgs, gx.reshape(v, batch * nchunks, pc),
                                          gy.reshape(v, batch * nchunks, pc))
            # [V, NW, 3, P] -> [V, B, K, 3, stride]
            colors = colors.reshape(v, batch, nchunks, 3, chunk, stride)
            colors = colors.permute(0, 1, 2, 4, 3, 5).reshape(v, batch, k, 3, stride)
            in_img = in_img.reshape(v, batch, k, stride)

            pix_color = pix_mask = patch_color = patch_mask = None
            if opts.patch_blending:
                patch_color = colors[..., :npx].permute(1, 2, 0, 3, 4)
                patch_mask = (patch_geo_mask & in_img[..., :npx]).permute(1, 2, 0, 3)
            if opts.pixel_blending:
                pix_color = colors[..., npx].permute(1, 2, 0, 3)  # [B, K, V, 3]
                pix_mask = (pix_geo_valid & in_img[..., npx]).permute(1, 2, 0)
            coverage = in_img.to(torch.float32).mean()
        return idx, pix_color, pix_mask, patch_color, patch_mask, coverage

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
        vis_prob = cumprod_nonzero(
            torch.cat([torch.ones_like(factor[:, :1]), factor], -1))[:, :-1]
        vis_prob = clip(vis_prob, 0.0, 1.0)

        neg_abs_cos = -torch.abs(true_cos)
        alpha_plus = sdf2alpha(udf, neg_abs_cos, dists.reshape(-1, 1), inv_s, cos_anneal_ratio,
                               sdf2alpha_type=rcfg.sdf2alpha_type).reshape(batch, n)
        alpha_minus = sdf2alpha(-udf, neg_abs_cos, dists.reshape(-1, 1), inv_s,
                                cos_anneal_ratio,
                                sdf2alpha_type=rcfg.sdf2alpha_type).reshape(batch, n)
        alpha = alpha_plus * vis_prob + alpha_minus * (1.0 - vis_prob)

        udf_2d = udf.reshape(batch, n)

        color_base, color_s, blending_logits = fields.residual_color_apply(
            params["color"], pts, grad_norm, dirs, feature, self.cfg.rendering_network)
        sampled_color_base = color_base.reshape(batch, n, 3)
        sampled_color = color_s.reshape(batch, n, 3)
        blending_logits = blending_logits.reshape(batch, n, -1)

        # pixel / patch blending
        sampled_color_pixel = sampled_color_patch = sampled_color_patch_mask = None
        blend_idx = None  # [B, K]: the sample subset under the strip sampler
        strip_coverage = None
        if blending is not None and (opts.pixel_blending or opts.patch_blending):
            pts3 = pts.reshape(batch, n, 3)
            normals_w = (flip_sign * grad_norm).reshape(batch, n, 3)
            if self._strip_active(blending):
                (blend_idx, pix_color, pix_mask, patch_color, patch_mask,
                 strip_coverage) = self._blend_warp_strip(blending, pts3, normals_w, alpha, opts)
                logits_sel = torch.gather(
                    blending_logits, 1,
                    blend_idx[..., None].expand(-1, -1, blending_logits.shape[-1]))
            else:
                pix_color = pix_mask = patch_color = patch_mask = None
                if opts.pixel_blending:
                    pix_color, pix_mask = self.projector.pixel_warp(
                        pts3, blending["color_maps"], blending["intrinsics"], blending["w2cs"])
                if opts.patch_blending:
                    patch_color, patch_mask = self.projector.patch_warp(
                        pts3, blending["rays_uv"], normals_w, blending["color_maps"],
                        blending["intrinsics"][0], blending["intrinsics"],
                        blending["query_c2w"], camera_inverse(blending["w2cs"]),
                        detach_normal=True)
                logits_sel = blending_logits
            pix_c, _, patch_c, patch_m = fields.color_blend(
                logits_sel, img_index=blending.get("img_index"),
                pts_pixel_color=pix_color, pts_pixel_mask=pix_mask,
                pts_patch_color=patch_color, pts_patch_mask=patch_mask)
            if opts.pixel_blending:
                sampled_color_pixel = pix_c  # [B, n, 3], or [B, K, 3] under strip
            if opts.patch_blending:
                sampled_color_patch = patch_c  # [B, n|K, 3, Npx]
                sampled_color_patch_mask = patch_m[..., 0]  # [B, n|K]

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
            if sampled_color_pixel is not None and blend_idx is None:
                scp = (sampled_color_pixel * inside_sphere[:, :, None]
                       + background_sampled_color[:, :n_fg] * (1.0 - inside_sphere)[:, :, None])
                sampled_color_pixel = torch.cat([scp, background_sampled_color[:, n_fg:]], dim=1)

        weights = transmittance_weights(alpha)
        weights_sum = weights.sum(-1, keepdim=True)

        color_base_out = torch.sum(sampled_color_base * weights[:, :, None], dim=1)
        color_out = torch.sum(sampled_color * weights[:, :, None], dim=1)

        # under the strip sampler the blended colours exist at the top-k
        # samples only: composite them with the same transmittance weights,
        # gathered at those samples
        weights_k = None
        if blend_idx is not None:
            weights_k = torch.gather(weights[:, :n_fg], 1, blend_idx)

        color_pixel = None
        if sampled_color_pixel is not None:
            if blend_idx is None:
                color_pixel = torch.sum(sampled_color_pixel * weights[:, :, None], dim=1)
            elif background_alpha is not None:
                inside_k = torch.gather(inside_sphere, 1, blend_idx)
                color_pixel = (
                    torch.sum(sampled_color_pixel * (weights_k * inside_k)[:, :, None], dim=1)
                    + torch.sum(background_sampled_color[:, :n_fg]
                                * (weights[:, :n_fg] * (1.0 - inside_sphere))[:, :, None], dim=1)
                    + torch.sum(background_sampled_color[:, n_fg:] * weights[:, n_fg:, None],
                                dim=1))
            else:
                color_pixel = torch.sum(sampled_color_pixel * weights_k[:, :, None], dim=1)

        fused_patch_colors = fused_patch_mask = None
        if sampled_color_patch is not None:
            w_patch = weights[:, :n_fg] if blend_idx is None else weights_k
            fused_patch_colors = torch.einsum("bscp,bs->bpc", sampled_color_patch, w_patch)
            fused_patch_mask = torch.sum(sampled_color_patch_mask.to(weights.dtype) * w_patch,
                                         dim=1)  # [B]

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
            "color_pixel": color_pixel,
            "patch_colors": fused_patch_colors,  # [B, Npx, 3]
            "patch_mask": fused_patch_mask,
            "blend_idx": blend_idx,  # [B, K] under the strip sampler, else None
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
            # the share of the strip sampler's warp positions that lie in their
            # image; 1 when it is off
            "blend_strip_cover": (strip_coverage if strip_coverage is not None else
                                  torch.ones((), dtype=z_vals.dtype, device=z_vals.device)),
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
        near, far = (v.to(dtype).expand(batch, 1) if isinstance(v, torch.Tensor)
                     else torch.full((batch, 1), v, dtype=dtype, device=dev) for v in (near, far))

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
                t_rand = uniform_draw((batch, 1), generator, dev, dtype) - 0.5
            z_vals = z_vals + t_rand * 2.0 / rcfg.n_samples
            if rcfg.n_outside > 0:
                mids = 0.5 * (z_vals_outside[1:] + z_vals_outside[:-1])
                upper = torch.cat([mids, z_vals_outside[-1:]])
                lower = torch.cat([z_vals_outside[:1], mids])
                t_r = noise.get("t_r")
                if t_r is None:
                    t_r = uniform_draw(z_vals_outside.shape, generator, dev, dtype)
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
