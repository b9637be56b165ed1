"""Hierarchical ray sampling for UDF rendering (counterpart of
``neuraludf_tpu/render/sampling.py``).

Every up-sampling round runs under ``torch.no_grad()``: the rounds only
decide where samples land. The distance queries inside them are value-only
MLP evaluations (``role="sampling"``), plain ``torch.matmul``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .alpha import sdf2alpha, transmittance_weights, udf2logistic

UdfFn = Callable[[torch.Tensor], torch.Tensor]  # [N,3] -> [N] udf values


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int, *, det: bool,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling (NeRF). bins: [B, n], weights: [B, n-1]; u [B, K]
    in [0, 1) must be given unless det (evenly spaced u).

    The bracket of each u is [inds-1, inds] with inds = #(cdf <= u), clamped
    to [0, n-1] at both edges (inds == 0 and inds == n), the brackets the
    JAX package builds from a dense prefix mask."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [B, n]
    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device).expand(shape)
    elif u is None:
        raise ValueError("sample_pdf(det=False) needs u")
    u = u.contiguous()
    n = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=n - 1)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_b, bins_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def _ray_points(rays_o, rays_d, z_vals):
    return rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]


def _dists_with_tail(z_vals, sample_dist):
    d = z_vals[..., 1:] - z_vals[..., :-1]
    if isinstance(sample_dist, torch.Tensor):
        tail = sample_dist.to(d.dtype).expand(d[..., :1].shape)
    else:
        tail = torch.full_like(d[..., :1], sample_dist)
    return torch.cat([d, tail], dim=-1)


@torch.no_grad()
def up_sample_unbias(rays_o, rays_d, z_vals, udf, sample_dist, n_importance: int, inv_s,
                     beta, gamma, *, sdf2alpha_type: str = "numerical"):
    """Occlusion-aware unbiased up-sampling: new samples at the first
    plausible surface crossing only."""
    batch, n = z_vals.shape
    pts = _ray_points(rays_o, rays_d, z_vals)
    radius = torch.linalg.vector_norm(pts, dim=-1)
    inside_sphere = ((radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)).to(z_vals.dtype)

    udf = udf.reshape(batch, n)
    dists_raw = _dists_with_tail(z_vals, sample_dist)

    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    prev_u, next_u = udf[:, :-1], udf[:, 1:]
    mid_udf = (prev_u + next_u) * 0.5
    dists = next_z - prev_z

    true_cos = (next_u - prev_u) / (next_z - prev_z + 1e-5)
    cos_val = -torch.abs(true_cos)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], -1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere

    vis_mask = (true_cos < 0.05).to(z_vals.dtype)
    vis_mask = torch.cat([torch.ones_like(vis_mask[:, :1]), vis_mask], -1)

    raw_occ = udf2logistic(udf, beta, 1.0, 1.0)
    alpha_occ = 1.0 - torch.exp(-torch.relu(raw_occ) * gamma * dists_raw)

    factor = torch.clamp(1.0 - alpha_occ + vis_mask, 0.0, 1.0) + 1e-7
    vis_prob = torch.cumprod(torch.cat([torch.ones_like(factor[:, :1]), factor], -1), -1)[:, :-1]

    signs_prob = vis_prob[:, :-1]
    alpha_plus = sdf2alpha(mid_udf, cos_val, dists, inv_s, sdf2alpha_type=sdf2alpha_type)
    alpha_minus = sdf2alpha(-mid_udf, cos_val, dists, inv_s, sdf2alpha_type=sdf2alpha_type)
    alpha = alpha_plus * signs_prob + alpha_minus * (1.0 - signs_prob)

    weights = transmittance_weights(alpha)
    return sample_pdf(z_vals, weights, n_importance, det=True)


@torch.no_grad()
def up_sample_no_occ_aware(rays_o, rays_d, z_vals, udf, sample_dist, n_importance: int,
                           inv_s, beta, gamma):
    """Samples near all plausible surfaces (no occlusion masking)."""
    batch, n = z_vals.shape
    udf = udf.reshape(batch, n)
    dists = _dists_with_tail(z_vals, sample_dist)
    raw_occ = udf2logistic(udf, beta, gamma, 1.0)
    alpha_occ = 1.0 - torch.exp(-torch.relu(raw_occ) * dists)
    return sample_pdf(z_vals, alpha_occ[:, :-1], n_importance, det=True)


@torch.no_grad()
def cat_z_vals(udf_fn: UdfFn, rays_o, rays_d, z_vals, new_z_vals, udf, *, last: bool):
    """Merge-sort new samples into z_vals, carrying udf along."""
    batch, _ = z_vals.shape
    n_new = new_z_vals.shape[1]
    z_all = torch.cat([z_vals, new_z_vals], dim=-1)
    if last:
        return torch.sort(z_all, dim=-1).values, udf
    pts = _ray_points(rays_o, rays_d, new_z_vals)
    new_udf = udf_fn(pts.reshape(-1, 3)).reshape(batch, n_new)
    udf_all = torch.cat([udf, new_udf], dim=-1)
    z_sorted, order = torch.sort(z_all, dim=-1)
    return z_sorted, torch.gather(udf_all, -1, order)


@torch.no_grad()
def importance_sample_classical(udf_fn: UdfFn, rays_o, rays_d, z_vals, sample_dist, *,
                                n_importance: int, up_sample_steps: int,
                                sdf2alpha_type: str = "numerical"):
    """Occlusion-aware up-sampling rounds with the stepped sharpness
    schedule of the reference."""
    batch, n0 = z_vals.shape
    pts = _ray_points(rays_o, rays_d, z_vals)
    udf = udf_fn(pts.reshape(-1, 3)).reshape(batch, n0)
    for i in range(up_sample_steps):
        new_z = up_sample_unbias(
            rays_o, rays_d, z_vals, udf, sample_dist,
            n_importance // up_sample_steps,
            64 * 2 ** i,
            64 * 2 ** (i + 1),
            float(np.clip(20 * 2 ** (up_sample_steps - i), 20, 320)),
            sdf2alpha_type=sdf2alpha_type,
        )
        z_vals, udf = cat_z_vals(udf_fn, rays_o, rays_d, z_vals, new_z, udf,
                                 last=(i + 1 == up_sample_steps))
    return z_vals


@torch.no_grad()
def importance_sample_mix(udf_fn: UdfFn, rays_o, rays_d, z_vals, sample_dist, beta, gamma, *,
                          n_importance: int, up_sample_steps: int,
                          sdf2alpha_type: str = "numerical"):
    """Garment-mode mix: no-occlusion rounds with the learned (beta, gamma),
    then one final unbiased round."""
    batch, n0 = z_vals.shape
    pts = _ray_points(rays_o, rays_d, z_vals)
    udf = udf_fn(pts.reshape(-1, 3)).reshape(batch, n0)
    n_per = n_importance // (up_sample_steps + 1)
    for i in range(up_sample_steps):
        new_z = up_sample_no_occ_aware(
            rays_o, rays_d, z_vals, udf, sample_dist, n_per,
            64 * 2 ** i, 64 * 2 ** (i + 1), gamma,
        )
        z_vals, udf = cat_z_vals(udf_fn, rays_o, rays_d, z_vals, new_z, udf, last=False)
    i = up_sample_steps - 1
    new_z = up_sample_unbias(
        rays_o, rays_d, z_vals, udf, sample_dist, n_per,
        64 * 2 ** i, 64 * 2 ** (i + 1),
        20.0 if i < 4 else 10.0,
        sdf2alpha_type=sdf2alpha_type,
    )
    z_vals, _ = cat_z_vals(udf_fn, rays_o, rays_d, z_vals, new_z, udf, last=True)
    return z_vals

