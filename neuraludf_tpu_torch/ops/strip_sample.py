"""The blending warps' image sampler: kernel K3 (``csrc/strip_sample.cu``).

Counterpart of ``neuraludf_tpu/ops/strip_sample.py``. The blending finetune
samples the source views bilinearly at the warp positions of the top-k
samples of every ray. The positions are constants with respect to the
networks (z-values are sampled without gradient, normals are detached), so
sampling is forward-only: gradients reach the loss through the blending
logits and the compositing weights, never through the sampler.

Contract (that of the JAX ``strip_sample`` / ``strip_sample_reference``):
positions are absolute pixels; ``mask = 0 <= gx <= W-1 and 0 <= gy <= H-1``;
positions are clamped to the image and sampled bilinearly with
``align_corners=True`` semantics, so every colour is finite (a NaN position
samples texel (0, 0) and is masked out).

Two deltas to the TPU kernel, both deliberate. It copied one aligned strip
of the image per (view, chunk) and lost the positions outside it; a gather
loses none, so the mask here is the in-image mask alone, which is what the
TPU kernel returns when no position escapes. And it rounded images and
column weights to bf16 for its matrix unit; this one samples the f32 images
with f32 weights, and agrees with the TPU kernel to bf16's bound (5e-3).

``strip_sample`` launches the kernel for CUDA tensors and takes
``strip_sample_plain`` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..utils.trace import span
from . import build


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


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """csrc/strip_sample.cu, built at first use, with its argument types."""
    lib = build.load("strip_sample")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ss_forward.argtypes = [P, P, P, I, I, I, L, I, P, P, P]
    lib.ss_forward.restype = I
    return lib


class _StripSample:
    """K3's entry point with its launch count (one per launch)."""

    def __init__(self):
        self.launches = 0

    @torch.no_grad()
    def __call__(self, images: torch.Tensor, gx: torch.Tensor,
                 gy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [V, 3, H, W] f32; gx, gy [V, NW, P] f32 absolute pixel
        positions -> (colors [V, NW, 3, P] f32, mask [V, NW, P] bool).

        The kernel reads the images channel last ([V, H, W, 3] in memory). A
        [V, 3, H, W] view of such a tensor, as ``ref_src_info`` gives, is
        taken as it is; any other layout is copied once. P and NW need no
        padding."""
        if images.dim() != 4 or images.shape[1] != 3:
            raise ValueError(f"images: expected [V, 3, H, W], got {tuple(images.shape)}")
        if gx.shape != gy.shape or gx.dim() != 3 or gx.shape[0] != images.shape[0]:
            raise ValueError(f"gx, gy: expected two [V={images.shape[0]}, NW, P] tensors, got "
                             f"{tuple(gx.shape)} and {tuple(gy.shape)}")
        for name, t in (("images", images), ("gx", gx), ("gy", gy)):
            if t.dtype != torch.float32 or t.device != images.device:
                raise ValueError(f"{name}: need float32 on {images.device}, got {t.dtype} "
                                 f"on {t.device}")
        if not images.is_cuda:
            return strip_sample_plain(images, gx, gy)

        with span("op.strip_sample"):
            v, _, h, w = images.shape
            nw, p = gx.shape[1], gx.shape[2]
            img = images.detach().permute(0, 2, 3, 1).contiguous()  # [V, H, W, 3]
            gx, gy = gx.detach().contiguous(), gy.detach().contiguous()
            dev = images.device
            colors = torch.empty((v, nw, 3, p), dtype=torch.float32, device=dev)
            mask = torch.empty((v, nw, p), dtype=torch.bool, device=dev)
            lib = library()
            with torch.cuda.device(dev):
                rc = lib.ss_forward(img.data_ptr(), gx.data_ptr(), gy.data_ptr(), v, h, w, nw, p,
                                    colors.data_ptr(), mask.data_ptr(),
                                    torch.cuda.current_stream(dev).cuda_stream)
                self.launches += 1
        if rc != 0:
            raise RuntimeError(f"strip_sample failed: CUDA error {rc}")
        return colors, mask


strip_sample = _StripSample()  # K3
