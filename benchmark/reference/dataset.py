"""Scene loading and training-ray sampling: a frozen copy of the port's
``data/dataset.py`` (the PNG layout only).

``load_scene`` reads a scene directory (``cameras.npz``, ``image/*.png``,
``mask/*.png``) into a ``scene`` dict of tensors on one device: images
[V,H,W,3] (BGR, /256 like the published code), masks, intrinsics (and
inverses), c2w poses, and each view's nearest neighbours
(``ref_src_pairs``). ``sample_random_rays`` draws a training batch from one
view at given pixels ``px, py``. ``ref_src_info`` gathers the source views
that the blending finetune warps into.

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

from .interp import grid_sample_2d
from .projector import build_patch_offset
from .cameras import decompose_projection
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


def ref_src_info(scene: Scene, img_idx: ViewIndex, num: int = 8):
    """Blending inputs of a reference view: its c2w, and the c2ws, intrinsics
    and images [V, 3, H, W] of its ``num`` nearest source views (from
    ``scene["ref_src_pairs"]``). The images are a channel-first view of a
    channel-last copy, the layout ``ops.strip_sample`` reads."""
    src_idx = view_of(scene["ref_src_pairs"], img_idx)[:num]
    src_images = scene["images"][src_idx].permute(0, 3, 1, 2)
    return (view_of(scene["poses"], img_idx), scene["poses"][src_idx],
            scene["intrinsics"][src_idx], src_images)


def load_scene(data_dir: str, views, device="cpu", sources: int = 0) -> Scene:
    """The scene dict of an IDR-layout directory (``cameras.npz``,
    ``image/*.png``, ``mask/*.png``) on ``device``: every view's cameras and
    nearest neighbours, and the images and masks of ``views`` and of the
    first ``sources`` neighbours of each alone (the others are zeros), which
    is all a few steps read."""
    camera_dict = np.load(os.path.join(data_dir, "cameras.npz"))
    images_lis = sorted(glob(os.path.join(data_dir, "image/*.png")))
    masks_lis = sorted(glob(os.path.join(data_dir, "mask/*.png")))
    n = len(images_lis)
    if n == 0 or len(masks_lis) != n:
        raise FileNotFoundError(f"no complete IDR scene under {data_dir}")
    intrinsics_all, pose_all = [], []
    for i in range(n):
        world_mat = camera_dict[f"world_mat_{i}"].astype(np.float32)
        scale_mat = camera_dict[f"scale_mat_{i}"].astype(np.float32)
        intrinsics, pose = decompose_projection((world_mat @ scale_mat)[:3, :4])
        intrinsics_all.append(intrinsics)
        pose_all.append(pose)
    intrinsics_all, pose_all = np.stack(intrinsics_all), np.stack(pose_all)
    centers = pose_all[:, :3, 3]
    pairs = np.argsort(np.linalg.norm(centers[:, None] - centers[None], axis=-1), axis=1)[:, 1:10]
    wanted = set(int(v) for v in views)
    wanted |= {int(s) for v in list(wanted) for s in pairs[v][:sources]}
    h, w = read_png(images_lis[0]).shape[:2]
    images = torch.zeros((n, h, w, 3), dtype=torch.float32, device=device)
    masks = torch.zeros((n, h, w, 3), dtype=torch.float32, device=device)
    for i in sorted(wanted):
        # BGR, /256: the reference convention
        images[i] = torch.as_tensor(read_png(images_lis[i]) / 256.0, dtype=torch.float32)
        masks[i] = torch.as_tensor(read_png(masks_lis[i]) / 256.0, dtype=torch.float32)
    to_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {
        "images": images,
        "masks": masks,
        "intrinsics": to_dev(intrinsics_all),
        "intrinsics_inv": to_dev(np.linalg.inv(intrinsics_all)),
        "poses": to_dev(pose_all),
        "ref_src_pairs": torch.as_tensor(pairs, dtype=torch.long, device=device),
    }
