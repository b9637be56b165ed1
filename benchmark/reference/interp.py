"""Bilinear image sampling with zeros padding and ``align_corners=True``
(a frozen copy of the port's
``ops/interp.py``), the combination the
gather-path warps and the patch crop use. The JAX package computes these
outside any kernel, as gathers; here they are ``F.grid_sample``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d_xy(image: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                      channels_last: bool = True) -> torch.Tensor:
    """Sample ``image`` [C, H, W] at normalised coordinates ``gx``, ``gy``
    [...] in [-1, 1]. Returns [..., C], or [C, ...] with
    ``channels_last=False``. A bilinear corner outside the image counts 0."""
    grid = torch.stack([gx, gy], dim=-1).reshape(1, 1, -1, 2)
    out = F.grid_sample(image[None], grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)  # [1, C, 1, M]
    out = out.reshape(image.shape[0], *gx.shape)
    return torch.movedim(out, 0, -1) if channels_last else out


def grid_sample_2d(image: torch.Tensor, grid: torch.Tensor,
                   channels_last: bool = True) -> torch.Tensor:
    """``grid_sample_2d_xy`` with the coordinates stacked as ``grid`` [..., 2]
    of (x, y)."""
    return grid_sample_2d_xy(image, grid[..., 0], grid[..., 1], channels_last)
