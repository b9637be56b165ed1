"""Density/alpha transforms for UDF volume rendering (counterpart of
``neuraludf_tpu/render/alpha.py``): plain elementwise math on tensors."""

from __future__ import annotations

from typing import Optional

import torch

from ..numerics import clip, cumprod_nonzero


def udf2logistic(udf, inv_s, gamma=20.0, abs_cos_val=1.0, cos_anneal_ratio=None):
    """Occlusion density, a logistic PDF in the UDF:
    raw = gamma * |cos| * s * sigmoid(s u) * sigmoid(-s u) (the stable form
    of s e^{-su} / (1 + e^{-su})^2)."""
    if cos_anneal_ratio is not None:
        abs_cos_val = (abs_cos_val * 0.5 + 0.5) * (1.0 - cos_anneal_ratio) + (
            abs_cos_val * cos_anneal_ratio
        )
    su = inv_s * udf
    raw = abs_cos_val * inv_s * torch.sigmoid(su) * torch.sigmoid(-su)
    return raw * gamma


def anneal_cos(true_cos, cos_anneal_ratio: Optional[float]):
    """NeuS cosine annealing; always non-positive."""
    if cos_anneal_ratio is None:
        return true_cos
    return -(
        torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
        + torch.relu(-true_cos) * cos_anneal_ratio
    )


def sdf2alpha(sdf, true_cos, dists, inv_s, cos_anneal_ratio=None,
              sdf2alpha_type: str = "numerical"):
    """NeuS-style section alpha from a signed distance and the ray/normal
    cosine ('numerical' or 'theorical', as in the JAX package)."""
    iter_cos = anneal_cos(true_cos, cos_anneal_ratio)
    if sdf2alpha_type == "numerical":
        est_next = sdf + iter_cos * dists * 0.5
        est_prev = sdf - iter_cos * dists * 0.5
        prev_cdf = torch.sigmoid(est_prev * inv_s)
        next_cdf = torch.sigmoid(est_next * inv_s)
        alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
        return clip(alpha, 0.0, 1.0)
    if sdf2alpha_type == "theorical":
        raw = torch.abs(iter_cos) * inv_s * (1.0 - torch.sigmoid(sdf * inv_s))
        return 1.0 - torch.exp(-torch.relu(raw) * dists)
    raise ValueError(sdf2alpha_type)


def _exclusive_cumprod(factor: torch.Tensor) -> torch.Tensor:
    ones = torch.ones_like(factor[:, :1])
    return cumprod_nonzero(torch.cat([ones, factor], dim=-1))[:, :-1]


def transmittance_weights(alpha: torch.Tensor) -> torch.Tensor:
    """w_i = alpha_i * prod_{j<i} (1 - alpha_j + 1e-7)."""
    return alpha * _exclusive_cumprod(1.0 - alpha + 1e-7)


def visibility_prob(alpha_occ: torch.Tensor, vis_boost: torch.Tensor) -> torch.Tensor:
    """vis_prob_i = prod_{j<i} clip(1 - alpha_occ_j + boost_j, 0, 1) + 1e-7."""
    return _exclusive_cumprod(clip(1.0 - alpha_occ + vis_boost, 0.0, 1.0) + 1e-7)
