"""Colour losses: pixel L1, the blended-pixel loss, the patch SSIM/NCC loss
with ranked outlier dropping, PSNR and the mask BCE (a frozen copy of the port's
``losses/color.py``)."""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Union

import torch

from .numerics import clip
from .patch_metric import gaussian_window, ncc_error, ssim_error

Scalar = Union[float, torch.Tensor]


@dataclass
class ColorLossWeights:
    """Floats, or 0-dim tensors of the step's schedule row."""
    color_base: Scalar
    color: Scalar
    color_pixel: Scalar
    color_patch: Scalar


@functools.lru_cache(maxsize=None)
def _window(size: int, device: torch.device) -> torch.Tensor:
    """The SSIM/NCC Gaussian window on ``device``, made once."""
    return torch.as_tensor(gaussian_window(size), device=device)


def pixel_l1(pred: torch.Tensor, gt: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """L1 summed over all entries and normalised by the mask count; like the
    reference, the numerator is not masked."""
    err = torch.abs(pred - gt)
    if mask is not None:
        return torch.sum(err) / (torch.sum(mask) + 1e-4)
    return torch.mean(err)


def patch_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, *,
               loss_type: str = "ssim", h_patch_size: int = 3,
               penalize_ratio: float = 0.3) -> torch.Tensor:
    """Patch similarity loss without the worst ``penalize_ratio`` of the valid
    patches. pred/gt: [N, Npx, 3]; mask: [N] or [N,1]."""
    mask = mask.reshape(-1).to(torch.float32)
    if loss_type == "l1":
        error = torch.sum(torch.mean(torch.abs(pred - gt), dim=-1), dim=-1)
    elif loss_type == "ssd":
        error = torch.sum(torch.mean((pred - gt) ** 2, dim=-1), dim=-1)
    else:
        window = _window(2 * h_patch_size + 1, pred.device)
        error = (ssim_error if loss_type == "ssim" else ncc_error)(pred, gt, window)

    error = error * mask
    order = torch.argsort(-error, stable=True)  # descending
    error_sorted, mask_sorted = error[order], mask[order]
    k = torch.floor(penalize_ratio * torch.sum(mask))
    rank = torch.arange(error.shape[0], device=error.device)
    keep = mask_sorted * (rank >= k).to(mask.dtype)
    return torch.sum(error_sorted * keep) / torch.clamp(torch.sum(keep), min=1.0)


def color_loss(weights: ColorLossWeights, color_base, color, gt_color, color_pixel,
               pixel_mask, patch_colors, gt_patch_colors, patch_mask, *,
               patch_loss_type: str = "ssim", h_patch_size: int = 3):
    """The weighted combination of the colour terms."""
    zero = torch.zeros((), dtype=gt_color.dtype, device=gt_color.device)
    base_l = pixel_l1(color_base, gt_color, pixel_mask) if color_base is not None else zero
    color_l = pixel_l1(color, gt_color, pixel_mask) if color is not None else zero
    pixel_l = pixel_l1(color_pixel, gt_color, patch_mask) if color_pixel is not None else zero
    patch_l = (patch_loss(patch_colors, gt_patch_colors, patch_mask,
                          loss_type=patch_loss_type, h_patch_size=h_patch_size)
               if patch_colors is not None else zero)
    denom = weights.color_base + weights.color + weights.color_pixel
    total = (base_l * weights.color_base + color_l * weights.color
             + pixel_l * weights.color_pixel) / denom + patch_l * weights.color_patch
    return {"loss": total, "color_base_loss": base_l, "color_loss": color_l,
            "color_pixel_loss": pixel_l, "color_patch_loss": patch_l}


def psnr(color: torch.Tensor, true_rgb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask_sum = torch.sum(mask) + 1e-5
    mse = torch.sum((color - true_rgb) ** 2 * mask) / (mask_sum * 3.0)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def bce_mask_loss(weight_sum: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on the clipped accumulated weights."""
    p = clip(weight_sum, 1e-3, 1.0 - 1e-3)
    return -torch.mean(mask * torch.log(p) + (1.0 - mask) * torch.log(1.0 - p))
