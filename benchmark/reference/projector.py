"""Multi-view pixel and patch warping (a frozen copy of the port's
``render/projector.py``).

Per-sample tangent-plane homographies H = K_src (R_rel + t_rel nᵀ/d) K_ref⁻¹
warp the pixels of a reference patch into the source views. The ``*_positions``
methods give absolute pixel positions, which both samplers share: the gather
path (``pixel_warp``, ``patch_warp``: ``ops.interp``, zeros padding) and the
strip path (``ops.strip_sample``, kernel K3). Patch colours keep the JAX
package's channel-packed layout [B, S, V, 3, Npx], patch axis last.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .interp import grid_sample_2d, grid_sample_2d_xy


def build_patch_offset(h_patch_size: int) -> np.ndarray:
    """(2h+1)² integer pixel offsets as (x, y) pairs, rows of equal y together."""
    off = np.arange(-h_patch_size, h_patch_size + 1)
    gy, gx = np.meshgrid(off, off, indexing="ij")
    return np.stack([gx, gy], axis=-1).reshape(-1, 2).astype(np.float32)


def cam2pixel_abs(pts, proj_rot, proj_tr) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points to absolute pixel coordinates in every view.

    pts [B, S, 3]; proj_rot [V, 3, 3]; proj_tr [V, 3, 1] -> (x, y) [V, B, S]."""
    pc = torch.einsum("vij,bsj->vbsi", proj_rot, pts) + proj_tr[:, None, None, :, 0]
    z = torch.clamp(pc[..., 2], min=1e-3)
    return pc[..., 0] / z, pc[..., 1] / z


def cam2pixel_grid(pts, proj_rot, proj_tr, size_wh) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points to normalised grids [V, B, S, 2] in [-1, 1]
    (``align_corners=True``; out-of-frame coordinates set to 2, so that zeros
    padding drops them) and the valid mask [V, B, S]."""
    W, H = size_wh
    x_abs, y_abs = cam2pixel_abs(pts, proj_rot, proj_tr)
    x_norm = 2.0 * x_abs / (W - 1) - 1.0
    y_norm = 2.0 * y_abs / (H - 1) - 1.0
    valid = (torch.abs(x_norm) < 1.0) & (torch.abs(y_norm) < 1.0)
    x_norm = torch.where(torch.abs(x_norm) > 1.0, torch.full_like(x_norm, 2.0), x_norm)
    y_norm = torch.where(torch.abs(y_norm) > 1.0, torch.full_like(y_norm, 2.0), y_norm)
    return torch.stack([x_norm, y_norm], dim=-1), valid


def camera_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of camera matrices (rigid poses, upper-triangular intrinsics:
    never singular). ``inv_ex`` leaves out ``inv``'s error check, which would
    make the host wait for the device in every step."""
    return torch.linalg.inv_ex(m).inverse


def _projection(intrinsics, w2cs):
    proj = torch.einsum("vij,vjk->vik", intrinsics[:, :3, :3], w2cs[:, :3, :])
    return proj[:, :3, :3], proj[:, :3, 3:]


class PatchProjector:
    def __init__(self, h_patch_size: int):
        self.h_patch_size = h_patch_size
        self.offsets = build_patch_offset(h_patch_size)  # [Npx, 2] numpy
        self.plane_dist_thresh = 0.001
        self._offsets_on = {}

    def offsets_on(self, dtype, device) -> torch.Tensor:
        """The patch offsets as a tensor, made once per dtype and device."""
        key = (dtype, torch.device(device))
        if key not in self._offsets_on:
            self._offsets_on[key] = torch.as_tensor(self.offsets, dtype=dtype, device=device)
        return self._offsets_on[key]

    def pixel_warp_positions(self, pts, intrinsics, w2cs, size_hw):
        """pts [B, S, 3] -> (gx, gy) [V, B, S] absolute pixels and valid
        [V, B, S], strictly inside the frame like ``cam2pixel_grid``."""
        H, W = size_hw
        gx, gy = cam2pixel_abs(pts, *_projection(intrinsics, w2cs))
        valid = (gx > 0.0) & (gx < W - 1.0) & (gy > 0.0) & (gy < H - 1.0)
        return gx, gy, valid

    def pixel_warp(self, pts, imgs, intrinsics, w2cs):
        """pts [B, S, 3]; imgs [V, 3, H, W]; intrinsics, w2cs [V, 4, 4] ->
        colours [B, S, V, 3], mask [B, S, V]."""
        V, _, H, W = imgs.shape
        grid, valid = cam2pixel_grid(pts, *_projection(intrinsics, w2cs), (W, H))
        colors = torch.stack([grid_sample_2d(imgs[v], grid[v]) for v in range(V)])  # [V,B,S,3]
        return colors.permute(1, 2, 0, 3), valid.permute(1, 2, 0)

    def patch_warp_positions(self, pts, uv, normals, size_hw, ref_intrinsic, src_intrinsics,
                             ref_c2w, src_c2ws, *, detach_normal: bool = False):
        """Absolute homography-warp positions.

        pts [B, S, 3]; uv [B, 2] in (-1, 1); normals [B, S, 3] in the world;
        size_hw = (H, W) of the source images. Returns gx, gy [V, B, S, Npx]
        in pixels and mask [V, B, S, Npx]: in front of the camera, and
        h_patch_size inside the frame."""
        sizeH, sizeW = size_hw
        if detach_normal:
            normals = normals.detach()
        B, S, _ = pts.shape
        V = src_intrinsics.shape[0]
        offsets = self.offsets_on(pts.dtype, pts.device)
        npx = offsets.shape[0]

        uv_px = torch.stack([(uv[:, 0] + 1.0) * 0.5 * (sizeW - 1),
                             (uv[:, 1] + 1.0) * 0.5 * (sizeH - 1)], dim=-1)

        inv_ref_intr = camera_inverse(ref_intrinsic[:3, :3])
        src_intrs = src_intrinsics[:, :3, :3]
        inv_ref_pose = camera_inverse(ref_c2w)
        inv_src_poses = camera_inverse(src_c2ws)

        ref_cam_loc = ref_c2w[:3, 3]
        pts_flat = pts.reshape(-1, 3)  # [N, 3], N = B*S
        normals_flat = normals.reshape(-1, 3)
        sampled_dists = torch.linalg.vector_norm(pts_flat - ref_cam_loc[None], dim=-1)  # [N]

        rel = torch.einsum("vij,jk->vik", inv_src_poses, ref_c2w)  # [V, 4, 4]
        R_rel, t_rel = rel[:, :3, :3], rel[:, :3, 3]
        R_ref, t_ref = inv_ref_pose[:3, :3], inv_ref_pose[:3, 3]

        # plane geometry in the reference camera frame, without gradient
        rot_normals = torch.einsum("ij,nj->ni", R_ref, normals_flat).detach()  # [N, 3]
        points_in_ref = torch.einsum("ij,nj->ni", R_ref, pts_flat) + t_ref[None]  # [N, 3]
        d1 = torch.sum(rot_normals * points_in_ref, dim=-1)  # [N]
        src_centers_in_ref = -torch.einsum("vji,vj->vi", R_rel, t_rel)  # [V, 3]
        d2 = torch.einsum("ni,vi->nv", rot_normals, src_centers_in_ref)  # [N, V]

        valid_hom = ((torch.abs(d1)[:, None] > self.plane_dist_thresh)
                     & (torch.abs(d1[:, None] - d2) > self.plane_dist_thresh)
                     & ((d2 / d1[:, None]) < 1.0))  # [N, V]

        sign = torch.where(d1 < 0, -torch.ones_like(d1), torch.ones_like(d1))  # sign(0) -> +1
        d = torch.clamp(torch.abs(d1), min=1e-8) * sign  # [N]

        # H p = K_src (R_rel + t_rel nᵀ/d) K_ref⁻¹ p without a [V, N, 3, 3]
        # stack: q = K_ref⁻¹ p is tiny, K(R q) and K t are small, and the plane
        # coefficient nᵀq/d is one scalar per (view, point, patch pixel)
        pixels = uv_px[:, None, :] + offsets[None, :, :]  # [B, Npx, 2]
        pix_h = torch.cat([pixels, torch.ones((B, npx, 1), dtype=pts.dtype, device=pts.device)],
                          dim=-1)
        q = torch.einsum("kl,bol->bko", inv_ref_intr, pix_h)  # [B, 3, Npx]

        KR = torch.einsum("vij,vjk->vik", src_intrs, R_rel)  # [V, 3, 3]
        KRq = torch.einsum("vik,bko->vbio", KR, q)  # [V, B, 3, Npx]
        Kt = torch.einsum("vij,vj->vi", src_intrs, t_rel)  # [V, 3]

        # nᵀq/d where the homography is valid, the fronto-parallel q_z/dist otherwise
        nq = torch.einsum("bsj,bjo->bso", rot_normals.reshape(B, S, 3), q)  # [B, S, Npx]
        coef_valid = nq / d.reshape(B, S)[..., None]
        coef_fp = q[:, None, 2, :] / sampled_dists.reshape(B, S)[..., None]
        coef = torch.where(valid_hom.T.reshape(V, B, S)[..., None], coef_valid[None],
                           coef_fp[None])  # [V, B, S, Npx]

        wx = KRq[:, :, None, 0, :] + Kt[:, None, None, None, 0] * coef
        wy = KRq[:, :, None, 1, :] + Kt[:, None, None, None, 1] * coef
        wz = KRq[:, :, None, 2, :] + Kt[:, None, None, None, 2] * coef
        wz_safe = torch.clamp(wz, min=1e-8)
        gx, gy = wx / wz_safe, wy / wz_safe

        h = self.h_patch_size
        mask = ((wz > 0) & (gx < (sizeW - h)) & (gy < (sizeH - h)) & (gx >= h) & (gy >= h))
        return gx, gy, mask

    def patch_warp(self, pts, uv, normals, src_imgs, ref_intrinsic, src_intrinsics,
                   ref_c2w, src_c2ws, *, detach_normal: bool = False):
        """Homography patch warp through the gather sampler. src_imgs
        [V, 3, H, W] -> colours [B, S, V, 3, Npx] and mask [B, S, V, Npx]."""
        V, _, sizeH, sizeW = src_imgs.shape
        gx, gy, mask = self.patch_warp_positions(
            pts, uv, normals, (sizeH, sizeW), ref_intrinsic, src_intrinsics, ref_c2w, src_c2ws,
            detach_normal=detach_normal)
        gx = torch.clamp(2.0 * gx / (sizeW - 1) - 1.0, -10.0, 10.0)
        gy = torch.clamp(2.0 * gy / (sizeH - 1) - 1.0, -10.0, 10.0)
        colors = torch.stack([grid_sample_2d_xy(src_imgs[v], gx[v], gy[v], channels_last=False)
                              for v in range(V)])  # [V, 3, B, S, Npx]
        return colors.permute(2, 3, 0, 1, 4), mask.permute(1, 2, 0, 3)
