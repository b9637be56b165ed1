"""Windowed patch similarity metrics, SSIM and NCC (a frozen copy of the port's
``losses/patch_metric.py``): one Gaussian-weighted moment per
patch, as weighted sums over the patch axis."""

from __future__ import annotations

import numpy as np
import torch


def gaussian_window(window_size: int, sigma: float = 1.5) -> np.ndarray:
    """Flattened 2D Gaussian window: the outer product of two normalised 1D
    windows."""
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).reshape(-1).astype(np.float32)


def _moments(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Gaussian-weighted patch mean over the Npx axis: x [..., Npx, C]."""
    return torch.einsum("...pc,p->...c", x, w)


def ssim_error(pred: torch.Tensor, gt: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """1 - SSIM per point. pred, gt: [N, Npx, 3]; window: [Npx]. Returns [N]."""
    mu1, mu2 = _moments(pred, window), _moments(gt, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _moments(pred * pred, window) - mu1_sq
    sigma2_sq = _moments(gt * gt, window) - mu2_sq
    sigma12 = _moments(pred * gt, window) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    values = 1.0 - ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.sum(values, dim=-1) / 2.0


def ncc_error(pred: torch.Tensor, gt: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """1 - NCC per point. Returns [N]."""
    mu1, mu2 = _moments(pred, window), _moments(gt, window)
    sigma1 = torch.sqrt(_moments(pred * pred, window) - mu1 ** 2 + 1e-4)
    sigma2 = torch.sqrt(_moments(gt * gt, window) - mu2 ** 2 + 1e-4)
    pred_n = (pred - mu1[..., None, :]) / (sigma1[..., None, :] + 1e-8)
    gt_n = (gt - mu2[..., None, :]) / (sigma2[..., None, :] + 1e-8)
    return 1.0 - torch.mean(_moments(pred_n * gt_n, window), dim=-1)
