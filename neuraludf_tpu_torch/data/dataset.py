"""Dataset: IDR-convention scene loading and training-ray sampling
(counterpart of ``neuraludf_tpu/data/dataset.py``).

``Dataset`` reads a scene directory (``cameras.npz``, ``image/*.png``,
``mask/*.png``; for ``dataset_name = "bmvs"`` BlendedMVS's
``blended_images/*.jpg`` and ``masks/*.jpg``) into a ``scene`` dict of tensors on one device: images
[V,H,W,3] (BGR, /256 like the reference), masks, intrinsics (and inverses)
c2w poses, and each view's nearest neighbours (``ref_src_pairs``).
``sample_random_rays`` draws a training batch from one view; its pixel draws
come from a ``torch.Generator`` or are given as ``px, py``. ``ref_src_info``
gathers the source views that the blending finetune warps into. Both take
the view as an ``int`` or as a 0-dim integer tensor on the scene's device,
which they read by a gather (no host read: a captured step graph takes its
view from device memory). ``rays_at``
and the ``Dataset.gen_*`` methods make the full-frame, single-pixel and
in-between-pose rays of the validation renders.

A ray through pixel (x, y) is ``normalize(pose_R @ K^-1 [x, y, 1])`` from
the camera centre.
"""

from __future__ import annotations

import functools
import os
from glob import glob
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import DatasetConfig
from ..ops.interp import grid_sample_2d
from ..render.projector import build_patch_offset
from .cameras import decompose_projection
from .image import resize
from .jpeg import read_jpeg
from .png import read_png

Scene = Dict[str, torch.Tensor]
ViewIndex = Union[int, torch.Tensor]


def view_of(t: torch.Tensor, img_idx: ViewIndex) -> torch.Tensor:
    """``t[img_idx]`` for an int, or for a 0-dim integer tensor by
    ``index_select`` (indexing with a tensor scalar reads it on the host)."""
    if isinstance(img_idx, torch.Tensor):
        return t.index_select(0, img_idx.reshape(1)).squeeze(0)
    return t[img_idx]


@functools.lru_cache(maxsize=None)
def patch_offsets(h_patch_size: int, device: torch.device) -> torch.Tensor:
    """``build_patch_offset`` as a tensor on ``device``, made once."""
    return torch.as_tensor(build_patch_offset(h_patch_size), device=device)


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


def draw_pixels(scene: Scene, batch_size: int, generator: torch.Generator,
                importance_sample: bool = False) -> Dict[str, torch.Tensor]:
    """The pixel draws of a batch: {"px", "py"} integers, uniform over the
    image. With ``importance_sample`` these are the first quarter of the
    batch, and ``u_mask`` holds a U[0, 1) number for each of the other three
    quarters, which ``mask_pixels`` turns into an in-mask pixel of the view."""
    _, H, W, _ = scene["images"].shape
    dev = scene["images"].device
    n_uni = batch_size // 4 if importance_sample else batch_size
    draws = {"px": _randint(W, n_uni, generator, dev), "py": _randint(H, n_uni, generator, dev)}
    if importance_sample:
        draws["u_mask"] = torch.rand((batch_size - n_uni,), generator=generator,
                                     device=generator.device).to(dev)
    return draws


def mask_pixels(mask_img: torch.Tensor, u: torch.Tensor):
    """In-mask pixels (px, py) of a view's mask [H, W, 3] from U[0, 1)
    numbers u, by the inverse of the mask's cumulative count, as the JAX
    package's ``_draw_pixels`` (static shapes, no host read)."""
    H, W = mask_img.shape[:2]
    cdf = torch.cumsum((mask_img[..., 0] > 0).to(torch.float32).reshape(-1), 0)
    flat = torch.clamp(torch.searchsorted(cdf, u * cdf[-1], right=True), 0, H * W - 1)
    return flat % W, flat // W


def sample_random_rays(scene: Scene, img_idx: ViewIndex, batch_size: int, *,
                       generator: Optional[torch.Generator] = None,
                       px: Optional[torch.Tensor] = None,
                       py: Optional[torch.Tensor] = None,
                       u_mask: Optional[torch.Tensor] = None,
                       importance_sample: bool = False,
                       crop_patch: bool = False,
                       h_patch_size: int = 3) -> Dict[str, Optional[torch.Tensor]]:
    """Random training rays from one view: {"rays": [B,10] (o, d, rgb, mask),
    "rays_ndc_uv": [B,2] in (-1,1), "rays_patch_color": [B,(2h+1)²,3] or
    None, "rays_patch_mask": [B,1] or None}. The pixels are ``px, py`` or
    drawn from ``generator`` (``draw_pixels``); with ``importance_sample``,
    or when ``u_mask`` is given, 3/4 of the batch lies in the view's mask
    (``mask_pixels``) after the uniform quarter. With ``crop_patch`` the
    ground truth patch around every pixel is cropped too (zeros outside the
    image)."""
    _, H, W, _ = scene["images"].shape
    if px is None or py is None:
        draws = draw_pixels(scene, batch_size, generator, importance_sample)
        px, py, u_mask = draws["px"], draws["py"], draws.get("u_mask")
    dev = scene["images"].device
    px, py = px.to(dev).long(), py.to(dev).long()
    if u_mask is not None:
        mx, my = mask_pixels(view_of(scene["masks"], img_idx), u_mask.to(dev))
        px, py = torch.cat([px, mx]), torch.cat([py, my])

    image = view_of(scene["images"], img_idx)
    mask_img = view_of(scene["masks"], img_idx)
    color = image[py, px]  # [B, 3]
    mask = (mask_img[py, px] > 0).to(torch.float32)
    pxf, pyf = px.to(torch.float32), py.to(torch.float32)
    rays_o, rays_v = pixels_to_rays(pxf, pyf, view_of(scene["intrinsics_inv"], img_idx),
                                    view_of(scene["poses"], img_idx))
    rays = torch.cat([rays_o, rays_v, color, mask[:, :1]], dim=-1)
    ndc_uv = torch.stack([2.0 * pxf / (W - 1) - 1.0, 2.0 * pyf / (H - 1) - 1.0], dim=-1)

    patch_color = patch_mask = None
    if crop_patch:
        offsets = patch_offsets(h_patch_size, dev)  # [Npx, 2]
        grid = torch.stack([pxf, pyf], dim=-1)[:, None, :] + offsets[None]  # [B, Npx, 2]
        grid_uv = torch.stack([2.0 * grid[..., 0] / (W - 1) - 1.0,
                               2.0 * grid[..., 1] / (H - 1) - 1.0], dim=-1)
        patch_color = grid_sample_2d(image.permute(2, 0, 1), grid_uv)  # [B, Npx, 3]
        h = h_patch_size
        patch_mask = ((px > h) & (px < W - h) & (py > h) & (py < H - h)).reshape(-1, 1)
    return {"rays": rays, "rays_ndc_uv": ndc_uv, "rays_patch_color": patch_color,
            "rays_patch_mask": patch_mask}


def rays_at(scene: Scene, img_idx: int, resolution_level: int = 1):
    """Full-image ray grid at a resolution level: (rays_o, rays_v), each
    [H // level, W // level, 3]."""
    _, H, W, _ = scene["images"].shape
    tx, ty = _pixel_grid(H, W, resolution_level, scene["images"].device)
    return pixels_to_rays(tx, ty, scene["intrinsics_inv"][img_idx], scene["poses"][img_idx])


def _pixel_grid(H: int, W: int, level: int, device):
    tx = torch.linspace(0, W - 1, W // level, device=device)
    ty = torch.linspace(0, H - 1, H // level, device=device)
    return torch.meshgrid(tx, ty, indexing="xy")  # [H', W'] each


def ref_src_info(scene: Scene, img_idx: ViewIndex, num: int = 8):
    """Blending inputs of a reference view: its c2w, and the c2ws, intrinsics
    and images [V, 3, H, W] of its ``num`` nearest source views (from
    ``scene["ref_src_pairs"]``). The images are a channel-first view of a
    channel-last copy, the layout ``ops.strip_sample`` reads."""
    src_idx = view_of(scene["ref_src_pairs"], img_idx)[:num]
    src_images = scene["images"][src_idx].permute(0, 3, 1, 2)
    return (view_of(scene["poses"], img_idx), scene["poses"][src_idx],
            scene["intrinsics"][src_idx], src_images)


class Dataset:
    """Loads an IDR-convention scene directory onto one device."""

    def __init__(self, conf: DatasetConfig, device="cpu"):
        self.conf = conf
        self.device = torch.device(device)
        self.data_dir = conf.data_dir
        self.dataset_name = conf.dataset_name
        self.downsample_factor = conf.downsample_factor

        camera_dict = np.load(os.path.join(self.data_dir, conf.render_cameras_name))
        if self.dataset_name == "bmvs":  # BlendedMVS: baseline JPEGs
            self.images_lis = sorted(glob(os.path.join(self.data_dir, "blended_images/*.jpg")))
            self.masks_lis = sorted(glob(os.path.join(self.data_dir, "masks/*.jpg")))
            read = read_jpeg
        else:  # dtu / deepfashion3d / general: the PNG layout
            self.images_lis = sorted(glob(os.path.join(self.data_dir, "image/*.png")))
            self.masks_lis = sorted(glob(os.path.join(self.data_dir, "mask/*.png")))
            read = read_png
        self.n_images = len(self.images_lis)
        if self.n_images == 0:
            raise FileNotFoundError(f"no images found under {self.data_dir}")

        # BGR, /256: the reference convention
        self.images_np = np.stack([read(p) for p in self.images_lis]) / 256.0
        self.masks_np = np.stack([read(p) for p in self.masks_lis]) / 256.0

        self.world_mats_np = [camera_dict[f"world_mat_{i}"].astype(np.float32)
                              for i in range(self.n_images)]
        self.scale_mats_np = [camera_dict[f"scale_mat_{i}"].astype(np.float32)
                              for i in range(self.n_images)]

        intrinsics_all, pose_all = [], []
        for scale_mat, world_mat in zip(self.scale_mats_np, self.world_mats_np):
            intrinsics, pose = decompose_projection((world_mat @ scale_mat)[:3, :4])
            intrinsics[:2] *= self.downsample_factor
            intrinsics_all.append(intrinsics)
            pose_all.append(pose)
        intrinsics_all = np.stack(intrinsics_all)
        pose_all = np.stack(pose_all)

        if self.downsample_factor != 1.0:
            f = self.downsample_factor
            self.images_np = np.stack([resize(im, fx=f) for im in self.images_np])
            self.masks_np = np.stack([resize(m, fx=f) for m in self.masks_np])

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

    # -- validation rays -------------------------------------------------

    def gen_rays_at(self, img_idx: int, resolution_level: int = 1):
        return rays_at(self.scene, img_idx, resolution_level)

    def gen_one_ray_at(self, img_idx: int, x: int, y: int) -> torch.Tensor:
        """One [1, 10] ray row (o, d, rgb, mask) through pixel (x, y)."""
        color = self.scene["images"][img_idx, y, x][None]
        mask = (self.scene["masks"][img_idx, y, x] > 0).to(torch.float32)[None]
        dev = self.scene["images"].device
        rays_o, rays_v = pixels_to_rays(
            torch.tensor([float(x)], device=dev), torch.tensor([float(y)], device=dev),
            self.scene["intrinsics_inv"][img_idx], self.scene["poses"][img_idx])
        return torch.cat([rays_o, rays_v, color, mask[:, :1]], dim=-1)

    def gen_rays_between(self, idx_0: int, idx_1: int, ratio: float,
                         resolution_level: int = 1):
        """Full-image rays from a pose between two views: the rotations
        slerped, the centres mixed linearly; view 0's intrinsics."""
        from scipy.spatial.transform import Rotation, Slerp

        poses = self.scene["poses"].cpu().numpy()
        pose_0, pose_1 = np.linalg.inv(poses[idx_0]), np.linalg.inv(poses[idx_1])
        rot = Slerp([0, 1], Rotation.from_matrix(np.stack([pose_0[:3, :3], pose_1[:3, :3]])))(
            ratio)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot.as_matrix()
        pose[:3, 3] = ((1.0 - ratio) * pose_0 + ratio * pose_1)[:3, 3]
        pose = np.linalg.inv(pose)
        dev = self.scene["images"].device
        tx, ty = _pixel_grid(self.H, self.W, resolution_level, dev)
        return pixels_to_rays(tx, ty, self.scene["intrinsics_inv"][0],
                              torch.as_tensor(pose, device=dev))

    def near_far_from_sphere(self, rays_o, rays_d):
        return near_far_from_sphere(rays_o, rays_d)

    def image_at(self, idx: int, resolution_level: int) -> np.ndarray:
        """The ground-truth image at a resolution level, uint8 BGR."""
        img = (self.images_np[idx] * 256).astype(np.uint8)
        return resize(img, (self.W // resolution_level, self.H // resolution_level))
