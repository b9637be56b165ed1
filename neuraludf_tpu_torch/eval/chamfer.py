"""Offline mesh evaluation: Chamfer-L1 + precision/recall/F-score (a copy of
``neuraludf_tpu/eval/chamfer.py``, reading meshes with the port's
``mesh/ply.py``).

Re-implements the reference protocol (ref: evaluation/eval_dtu_python.py:40-369,
evaluation/eval_deepfashion_python.py) without open3d:

  * mesh → point cloud by per-triangle lattice sampling at the downsample
    density (same `sample_single_tri` lattice construction, vectorised),
  * greedy radius-based downsampling with a cKDTree,
  * optional DTU ObsMask / bounding-box / ground-plane filtering from the
    official .mat files,
  * bidirectional truncated mean distances: Chamfer = (d2s + s2d) / 2,
  * P/R/F-score at 1mm / 2mm,
  * error-colored point-cloud visualisations (PLY).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from ..mesh.ply import load_ply


def sample_mesh_to_pcd(verts: np.ndarray, faces: np.ndarray, density: float) -> np.ndarray:
    """Vertices + lattice samples on each triangle so that sample spacing is
    ~`density` (ref: eval_dtu_python.py:21-75, vectorised, no mp.Pool)."""
    tri = verts[faces]  # [F, 3, 3]
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    l1 = np.linalg.norm(v1, axis=-1)
    l2 = np.linalg.norm(v2, axis=-1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1)
    nz = area2 > 0
    tri, v1, v2, l1, l2, area2 = tri[nz], v1[nz], v2[nz], l1[nz], l2[nz], area2[nz]
    thr = density * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr).astype(np.int64)
    n2 = np.floor(l2 / thr).astype(np.int64)

    pts = [verts]
    # group triangles by (n1, n2) so each lattice is built once
    key = n1 * 100000 + n2
    for k in np.unique(key):
        sel = key == k
        kn1, kn2 = int(n1[sel][0]), int(n2[sel][0])
        c = np.mgrid[: kn1 + 1, : kn2 + 1].astype(np.float64) + 0.5
        c[0] /= max(kn1, 1e-7)
        c[1] /= max(kn2, 1e-7)
        c = c.transpose(1, 2, 0).reshape(-1, 2)
        bary = c[c.sum(axis=-1) < 1]  # [m, 2]
        if len(bary) == 0:
            continue
        q = (
            v1[sel][:, None, :] * bary[None, :, :1]
            + v2[sel][:, None, :] * bary[None, :, 1:]
            + tri[sel][:, None, 0, :]
        )
        pts.append(q.reshape(-1, 3))
    return np.concatenate(pts, axis=0)


def greedy_downsample(pts: np.ndarray, radius: float, seed: int = 0) -> np.ndarray:
    """Greedy radius thinning (ref: eval_dtu_python.py:84-98)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(pts))
    pts = pts[perm]
    tree = cKDTree(pts)
    mask = np.ones(len(pts), dtype=bool)
    neighbors = tree.query_ball_point(pts, r=radius, workers=-1)
    for cur, idxs in enumerate(neighbors):
        if mask[cur]:
            mask[idxs] = False
            mask[cur] = True
    return pts[mask]


@dataclass
class EvalResult:
    chamfer: float
    mean_d2s: float
    mean_s2d: float
    precision_1: float
    recall_1: float
    fscore_1: float
    precision_2: float
    recall_2: float
    fscore_2: float


def eval_mesh(
    mesh_path: str,
    gt_points: np.ndarray,
    *,
    downsample_density: float = 0.2,
    max_dist: float = 20.0,
    thresh1: float = 1.0,
    thresh2: float = 2.0,
    obs_mask: Optional[Tuple[np.ndarray, np.ndarray, float]] = None,  # (ObsMask, BB, Res)
    ground_plane: Optional[np.ndarray] = None,  # [4]
    patch_size: float = 60.0,
    vis_out_dir: Optional[str] = None,
    scan: int = 0,
) -> EvalResult:
    """DTU-protocol evaluation of a predicted mesh against GT points."""
    verts, faces = load_ply(mesh_path)
    data_pcd = sample_mesh_to_pcd(verts.astype(np.float64), faces, downsample_density)
    data_down = greedy_downsample(data_pcd, downsample_density)

    data_in = data_down
    data_in_obs = data_down
    if obs_mask is not None:
        ObsMask, BB, Res = obs_mask
        BB = BB.astype(np.float32)
        inbound = (
            (data_down >= BB[:1] - patch_size) & (data_down < BB[1:] + patch_size * 2)
        ).sum(axis=-1) == 3
        data_in = data_down[inbound]
        data_grid = np.around((data_in - BB[:1]) / Res).astype(np.int32)
        grid_inbound = (
            (data_grid >= 0) & (data_grid < np.expand_dims(ObsMask.shape, 0))
        ).sum(axis=-1) == 3
        g = data_grid[grid_inbound]
        in_obs = ObsMask[g[:, 0], g[:, 1], g[:, 2]].astype(bool)
        data_in_obs = data_in[grid_inbound][in_obs]

    stl = gt_points
    stl_above = stl
    if ground_plane is not None:
        stl_hom = np.concatenate([stl, np.ones_like(stl[:, :1])], -1)
        above = (ground_plane.reshape(1, 4) * stl_hom).sum(-1) > 0
        stl_above = stl[above]

    tree_stl = cKDTree(stl)
    dist_d2s, _ = tree_stl.query(data_in_obs, k=1, workers=-1)
    mean_d2s = dist_d2s[dist_d2s < max_dist].mean()
    precision_1 = float((dist_d2s < thresh1).sum()) / len(dist_d2s)
    precision_2 = float((dist_d2s < thresh2).sum()) / len(dist_d2s)

    tree_data = cKDTree(data_in)
    dist_s2d, _ = tree_data.query(stl_above, k=1, workers=-1)
    mean_s2d = dist_s2d[dist_s2d < max_dist].mean()
    recall_1 = float((dist_s2d < thresh1).sum()) / len(dist_s2d)
    recall_2 = float((dist_s2d < thresh2).sum()) / len(dist_s2d)

    if vis_out_dir is not None:
        os.makedirs(vis_out_dir, exist_ok=True)
        _write_error_pcd(
            os.path.join(vis_out_dir, f"vis_{scan:03}_d2gt.ply"),
            data_in_obs, dist_d2s, max_dist,
        )
        _write_error_pcd(
            os.path.join(vis_out_dir, f"vis_{scan:03}_gt2d.ply"),
            stl_above, dist_s2d, max_dist,
        )

    f1 = 2 * precision_1 * recall_1 / (precision_1 + recall_1 + 1e-6)
    f2 = 2 * precision_2 * recall_2 / (precision_2 + recall_2 + 1e-6)
    return EvalResult(
        chamfer=float((mean_d2s + mean_s2d) / 2),
        mean_d2s=float(mean_d2s), mean_s2d=float(mean_s2d),
        precision_1=precision_1, recall_1=recall_1, fscore_1=f1,
        precision_2=precision_2, recall_2=recall_2, fscore_2=f2,
    )


def _write_error_pcd(path: str, points: np.ndarray, dists: np.ndarray, max_dist: float,
                     vis_dist: float = 10.0):
    """Error-colored point cloud: white→red by distance, green = outlier
    (ref: eval_dtu_python.py:141-156)."""
    a = np.clip(dists, 0, vis_dist)[:, None] / vis_dist
    colors = np.array([[1.0, 0, 0]]) * a + np.array([[1.0, 1, 1]]) * (1 - a)
    colors[dists >= max_dist] = [0, 1, 0]
    _write_pcd_ply(path, points, colors)


def _write_pcd_ply(path: str, points: np.ndarray, colors: np.ndarray):
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(points)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(len(points), dtype=[("xyz", "<f4", (3,)), ("rgb", "u1", (3,))])
    rec["xyz"] = points
    rec["rgb"] = (colors * 255).clip(0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def load_dtu_obs_mask(dataset_dir: str, scan: int):
    """Load the official DTU ObsMask/BB/Res and ground plane .mat files."""
    from scipy.io import loadmat

    m = loadmat(f"{dataset_dir}/ObsMask/ObsMask{scan}_10.mat")
    plane = loadmat(f"{dataset_dir}/ObsMask/Plane{scan}.mat")["P"]
    return (m["ObsMask"], m["BB"], m["Res"]), plane
