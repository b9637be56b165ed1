"""Dataset: IDR-convention scene loading and training-ray sampling
(counterpart of ``neuraludf_tpu/data/dataset.py``).

``Dataset`` reads a scene directory (``cameras.npz``, ``image/*.png``,
``mask/*.png``) into a ``scene`` dict of tensors on one device: images
[V,H,W,3] (BGR, /256 like the reference), masks, intrinsics (and inverses)
c2w poses, and each view's nearest neighbours (``ref_src_pairs``).
``sample_random_rays`` draws a training batch from one view; its pixel draws
come from a ``torch.Generator`` or are given as ``px, py``. ``ref_src_info``
gathers the source views that the blending finetune warps into.

A ray through pixel (x, y) is ``normalize(pose_R @ K^-1 [x, y, 1])`` from
the camera centre.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, Optional

import numpy as np
import torch

from ..config import DatasetConfig
from ..ops.interp import grid_sample_2d
from ..render.projector import build_patch_offset
from .cameras import decompose_projection
from .png import read_png

Scene = Dict[str, torch.Tensor]


def near_far_from_sphere(rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Near/far for a unit-sphere scene: the ray's closest approach to the
    origin, -1 and +1."""
    a = torch.sum(rays_d ** 2, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    mid = 0.5 * (-b) / a
    return mid - 1.0, mid + 1.0


def pixels_to_rays(pixels_x, pixels_y, intrinsics_inv, pose):
    """World-space rays through pixel centres: (rays_o, unit rays_v), [..., 3]."""
    p = torch.stack([pixels_x, pixels_y, torch.ones_like(pixels_x)], dim=-1)
    p = torch.einsum("ij,...j->...i", intrinsics_inv[:3, :3], p)
    rays_v = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    rays_v = torch.einsum("ij,...j->...i", pose[:3, :3], rays_v)
    rays_o = pose[:3, 3].expand(rays_v.shape)
    return rays_o, rays_v


def _randint(high: int, n: int, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, high, (n,), generator=generator,
                         device=generator.device).to(device)


def _draw_pixels(scene: Scene, batch_size: int, generator: torch.Generator):
    """Integer pixel draws, uniform over the image."""
    _, H, W, _ = scene["images"].shape
    dev = scene["images"].device
    return _randint(W, batch_size, generator, dev), _randint(H, batch_size, generator, dev)


def sample_random_rays(scene: Scene, img_idx: int, batch_size: int, *,
                       generator: Optional[torch.Generator] = None,
                       px: Optional[torch.Tensor] = None,
                       py: Optional[torch.Tensor] = None,
                       crop_patch: bool = False,
                       h_patch_size: int = 3) -> Dict[str, Optional[torch.Tensor]]:
    """Random training rays from one view: {"rays": [B,10] (o, d, rgb, mask),
    "rays_ndc_uv": [B,2] in (-1,1), "rays_patch_color": [B,(2h+1)²,3] or
    None, "rays_patch_mask": [B,1] or None}. With ``crop_patch`` the ground
    truth patch around every pixel is cropped too (zeros outside the image)."""
    _, H, W, _ = scene["images"].shape
    if px is None or py is None:
        px, py = _draw_pixels(scene, batch_size, generator)
    dev = scene["images"].device
    px, py = px.to(dev).long(), py.to(dev).long()

    image = scene["images"][img_idx]
    mask_img = scene["masks"][img_idx]
    color = image[py, px]  # [B, 3]
    mask = (mask_img[py, px] > 0).to(torch.float32)
    pxf, pyf = px.to(torch.float32), py.to(torch.float32)
    rays_o, rays_v = pixels_to_rays(pxf, pyf, scene["intrinsics_inv"][img_idx],
                                    scene["poses"][img_idx])
    rays = torch.cat([rays_o, rays_v, color, mask[:, :1]], dim=-1)
    ndc_uv = torch.stack([2.0 * pxf / (W - 1) - 1.0, 2.0 * pyf / (H - 1) - 1.0], dim=-1)

    patch_color = patch_mask = None
    if crop_patch:
        offsets = torch.as_tensor(build_patch_offset(h_patch_size), device=dev)  # [Npx, 2]
        grid = torch.stack([pxf, pyf], dim=-1)[:, None, :] + offsets[None]  # [B, Npx, 2]
        grid_uv = torch.stack([2.0 * grid[..., 0] / (W - 1) - 1.0,
                               2.0 * grid[..., 1] / (H - 1) - 1.0], dim=-1)
        patch_color = grid_sample_2d(image.permute(2, 0, 1), grid_uv)  # [B, Npx, 3]
        h = h_patch_size
        patch_mask = ((px > h) & (px < W - h) & (py > h) & (py < H - h)).reshape(-1, 1)
    return {"rays": rays, "rays_ndc_uv": ndc_uv, "rays_patch_color": patch_color,
            "rays_patch_mask": patch_mask}


def ref_src_info(scene: Scene, img_idx: int, num: int = 8):
    """Blending inputs of a reference view: its c2w, and the c2ws, intrinsics
    and images [V, 3, H, W] of its ``num`` nearest source views (from
    ``scene["ref_src_pairs"]``). The images are a channel-first view of a
    channel-last copy, the layout ``ops.strip_sample`` reads."""
    src_idx = scene["ref_src_pairs"][img_idx, :num]
    src_images = scene["images"][src_idx].permute(0, 3, 1, 2)
    return (scene["poses"][img_idx], scene["poses"][src_idx], scene["intrinsics"][src_idx],
            src_images)


class Dataset:
    """Loads an IDR-convention scene directory onto one device."""

    def __init__(self, conf: DatasetConfig, device="cpu"):
        self.conf = conf
        self.device = torch.device(device)
        self.data_dir = conf.data_dir
        self.dataset_name = conf.dataset_name
        if self.dataset_name == "bmvs":
            raise NotImplementedError("the BlendedMVS JPEG layout needs a JPEG decoder, "
                                      "not ported yet (ROADMAP: slice 1, open item 6)")
        if conf.downsample_factor != 1.0:
            raise NotImplementedError("downsample_factor != 1 needs an image resize, "
                                      "not ported yet (ROADMAP: slice 1, open item 6)")

        camera_dict = np.load(os.path.join(self.data_dir, conf.render_cameras_name))
        self.images_lis = sorted(glob(os.path.join(self.data_dir, "image/*.png")))
        self.masks_lis = sorted(glob(os.path.join(self.data_dir, "mask/*.png")))
        self.n_images = len(self.images_lis)
        if self.n_images == 0:
            raise FileNotFoundError(f"no images found under {self.data_dir}")

        # BGR, /256: the reference convention
        self.images_np = np.stack([read_png(p) for p in self.images_lis]) / 256.0
        self.masks_np = np.stack([read_png(p) for p in self.masks_lis]) / 256.0

        self.world_mats_np = [camera_dict[f"world_mat_{i}"].astype(np.float32)
                              for i in range(self.n_images)]
        self.scale_mats_np = [camera_dict[f"scale_mat_{i}"].astype(np.float32)
                              for i in range(self.n_images)]

        intrinsics_all, pose_all = [], []
        for scale_mat, world_mat in zip(self.scale_mats_np, self.world_mats_np):
            intrinsics, pose = decompose_projection((world_mat @ scale_mat)[:3, :4])
            intrinsics_all.append(intrinsics)
            pose_all.append(pose)
        intrinsics_all = np.stack(intrinsics_all)
        pose_all = np.stack(pose_all)

        self.H, self.W = self.images_np.shape[1], self.images_np.shape[2]

        # mesh-extraction region of interest
        object_scale_mat = np.load(
            os.path.join(self.data_dir, conf.object_cameras_name))["scale_mat_0"]
        lo = np.array([-1.01, -1.01, -1.01, 1.0])
        hi = np.array([1.01, 1.01, 1.01, 1.0])
        inv0 = np.linalg.inv(self.scale_mats_np[0])
        self.object_bbox_min = (inv0 @ object_scale_mat @ lo[:, None])[:3, 0]
        self.object_bbox_max = (inv0 @ object_scale_mat @ hi[:, None])[:3, 0]

        to_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self.scene: Scene = {
            "images": to_dev(self.images_np),
            "masks": to_dev(self.masks_np),
            "intrinsics": to_dev(intrinsics_all),
            "intrinsics_inv": to_dev(np.linalg.inv(intrinsics_all)),
            "poses": to_dev(pose_all),
        }
        self.ref_src_pairs = self._prepare_ref_src_pairs(pose_all)
        self.scene["ref_src_pairs"] = torch.as_tensor(self.ref_src_pairs, dtype=torch.long,
                                                      device=self.device)

    @staticmethod
    def _prepare_ref_src_pairs(pose_all: np.ndarray) -> np.ndarray:
        """Up to 9 nearest cameras (by centre distance) per reference view."""
        centers = pose_all[:, :3, 3]
        d = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
        return np.argsort(d, axis=1)[:, 1:10].astype(np.int32)
