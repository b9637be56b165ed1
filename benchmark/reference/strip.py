"""The blending warps' image sampler in plain PyTorch: a frozen copy of the
plain version of the port's kernel K3 (``ops/strip_sample.py``).

The blending finetune samples the source views bilinearly at the warp
positions of the top-k samples of every ray. The positions are constants
with respect to the networks, so sampling is forward-only. Positions are
absolute pixels; ``mask = 0 <= gx <= W-1 and 0 <= gy <= H-1``; positions
are clamped to the image and sampled bilinearly with ``align_corners=True``
semantics, so every colour is finite (a NaN position samples texel (0, 0)
and is masked out).
"""

from __future__ import annotations

from typing import Tuple

import torch



def strip_sample_plain(images: torch.Tensor, gx: torch.Tensor,
                       gy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K3: floor, four indexed gathers, four weights.

    images [V, 3, H, W]; gx, gy [V, NW, P] absolute pixel positions.
    Returns (colors [V, NW, 3, P] f32, mask [V, NW, P] bool)."""
    v, c, h, w = images.shape
    gx, gy = gx.detach(), gy.detach()
    mask = (gx >= 0) & (gx <= w - 1) & (gy >= 0) & (gy <= h - 1)
    # like the kernel's fmaxf/fminf, a NaN position samples texel (0, 0)
    x = torch.nan_to_num(gx, nan=0.0).clamp(0.0, w - 1.0)
    y = torch.nan_to_num(gy, nan=0.0).clamp(0.0, h - 1.0)
    xf, yf = torch.floor(x), torch.floor(y)
    x0, y0 = xf.long(), yf.long()
    # the upper neighbour of the last column or row has weight 0: clamp its index
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    wx1, wy1 = x - xf, y - yf
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1

    flat = images.detach().reshape(v, c, h * w)

    def corner(xi, yi, wgt):
        lin = (yi * w + xi).reshape(v, 1, -1).expand(v, c, -1)
        return torch.gather(flat, 2, lin).reshape(v, c, *gx.shape[1:]) * wgt[:, None]

    colors = (corner(x0, y0, wx0 * wy0) + corner(x1, y0, wx1 * wy0)
              + corner(x0, y1, wx0 * wy1) + corner(x1, y1, wx1 * wy1))  # [V, 3, NW, P]
    return colors.permute(0, 2, 1, 3).contiguous(), mask


strip_sample = strip_sample_plain
