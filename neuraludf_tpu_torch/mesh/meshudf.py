"""MeshUDF: gradient-aware open-mesh extraction from a trained UDF
(counterpart of ``neuraludf_tpu/mesh/meshudf.py``).

Pipeline:
  1. grid fill on the device: UDF + near-surface negated normalized gradients
  2. host pseudo-sign voting marching cubes (C++: csrc/udf_mc.cpp)
  3. drop faces whose re-queried vertex UDF exceeds voxel*dist_threshold
  4. cleanup loop (dedupe / degenerate / fill holes until stable)
  5. border Laplacian smoothing
  6. vertex refinement v' = v + eps*(f(v-eps n) - f(v+eps n))*n
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import UDFNetworkConfig
from ..nets import fields
from . import grid as grid_mod
from . import process
from .mc import marching_cubes_udf


def next_update_indices(verts: np.ndarray, resolution: int) -> np.ndarray:
    """Linear grid indices to re-query at the next incremental extraction:
    the voxel of every mesh vertex plus its 6 axis neighbours."""
    N = resolution
    voxel_size = 2.0 / (N - 1)
    ijk = np.clip(((verts + 1.0) / voxel_size).astype(np.int64), 0, N - 1)
    i, j, k = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    lin = lambda a, b, c: a * N * N + b * N + c
    return np.concatenate([
        lin(i, j, k),
        lin(np.minimum(i + 1, N - 1), j, k),
        lin(i, np.minimum(j + 1, N - 1), k),
        lin(i, j, np.minimum(k + 1, N - 1)),
        lin(np.maximum(i - 1, 0), j, k),
        lin(i, np.maximum(j - 1, 0), k),
        lin(i, j, np.maximum(k - 1, 0)),
    ])


def get_mesh_udf(
    params,
    cfg: UDFNetworkConfig,
    *,
    resolution: int = 128,
    eps: float = 0.005,
    dist_threshold_ratio: float = 1.0,
    smooth: bool = True,
    refine: bool = True,
    cache: Optional[dict] = None,
    signed: bool = False,
    algorithm: str = "tets",
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (verts [V,3] in normalized scene coords, faces [F,3]).

    Pass a dict as ``cache`` (kept between calls) for the incremental grid
    re-query between successive extractions of one field: after the first
    full fill, only voxels around the previous surface are evaluated again.

    ``signed=True`` extracts from a signed field (model_type 'neus'): the
    grid holds |sdf| with ∇|sdf| gradients, the unsigned pattern the
    pseudo-sign BFS expects.

    ``algorithm``: cube triangulation, 'tets' (marching tetrahedra) or
    'lewiner' (Lewiner tables).

    ``timings``, if given, receives the host-clock seconds of each stage:
    "grid", "mc", "filter", "cleanup", "smooth", "refine".
    """
    N = resolution
    voxel_size = 2.0 / (N - 1)
    t_last = time.perf_counter()

    def lap(stage):
        nonlocal t_last
        now = time.perf_counter()
        if timings is not None:
            timings[stage] = now - t_last
        t_last = now

    if cache is not None:
        udf, normals, new_cache = grid_mod.udf_and_normals_grid_incremental(
            params, cfg, N, cache if cache else None, signed=signed)
        if new_cache is not cache:  # a full fill made a new cache
            cache.clear()
            cache.update(new_cache)
    else:
        udf, normals = grid_mod.udf_and_normals_grid(params, cfg, N, signed)
    udf = np.maximum(udf, 0.0)
    lap("grid")

    verts, faces = marching_cubes_udf(udf, normals, voxel_size, algorithm=algorithm)
    lap("mc")
    if len(verts) == 0:
        return verts, faces
    verts = verts * voxel_size - 1.0  # grid-index units -> [-1, 1]³

    # 3: drop faces with any vertex far from the zero level set
    pred_df = grid_mod.query_udf_at(params, cfg, verts, signed)
    keep = np.max(pred_df[faces], axis=1) < voxel_size * dist_threshold_ratio
    verts, faces = process.remove_unreferenced(verts, faces[keep])
    lap("filter")

    # 4: cleanup until stable
    verts, faces = process.process_until_stable(verts, faces)
    lap("cleanup")

    # 5: border smoothing
    if smooth and len(faces):
        verts = process.smooth_borders(verts, faces)
    lap("smooth")

    # 6: normal-direction refinement (the value of the differentiable re-plug)
    if refine and len(faces):
        n = process.vertex_normals(verts, faces)
        s1 = grid_mod.query_udf_at(params, cfg, verts + eps * n, signed)
        s2 = grid_mod.query_udf_at(params, cfg, verts - eps * n, signed)
        verts = verts + eps * (s2 - s1)[:, None] * n
    lap("refine")

    if cache is not None and len(verts):
        cache["indices"] = next_update_indices(np.asarray(verts), N)

    return verts.astype(np.float32), faces.astype(np.int32)


def differentiable_vertices(
    params,
    cfg: UDFNetworkConfig,
    verts: np.ndarray,
    faces: np.ndarray,
    *,
    eps: float = 0.005,
    border_gradients: bool = False,
) -> torch.Tensor:
    """Differentiable mesh vertices for mesh-optimization workflows.

    The MeshUDF re-plug: v' = v - eps*f(v+eps*n)*n + eps*f(v-eps*n)*n,
    evaluated through the live field (``params`` is the distance field's
    parameter dict), so autograd carries d(v')/d(params). With
    ``border_gradients``, rim vertices also get the tangential term
    s_border = eps*(out_df - out_df.detach()): zero in value, but it routes
    gradient from the border UDF values into the vertex positions along the
    outward rim direction.

    Returns a tensor [V,3] on the parameters' device.
    """
    dev = grid_mod.device_of(params)
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    n = as_t(process.vertex_normals(verts, faces))
    v = as_t(verts)
    udf = lambda pts: fields.distance_value(params, pts, cfg)
    s1 = udf(v + eps * n)
    s2 = udf(v - eps * n)
    new_verts = v - eps * s1 * n + eps * s2 * n

    if border_gradients:
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        e = np.sort(e, axis=1)
        uniq, counts = np.unique(e, axis=0, return_counts=True)
        border = uniq[counts == 1]
        if len(border):
            # one border edge per border vertex
            d = {}
            for u_, v_ in border:
                d[int(u_)] = int(v_)
                d[int(v_)] = int(u_)
            uv = np.array(list(d.items()), np.int64)
            u_b, v_b = uv[:, 0], uv[:, 1]
            u_idx = torch.as_tensor(u_b, device=dev)
            out_vec = torch.linalg.cross(as_t(verts[v_b] - verts[u_b]), n[u_idx], dim=-1)
            out_vec = out_vec / (torch.linalg.vector_norm(out_vec, dim=1, keepdim=True) + 1e-6)
            vb = as_t(verts[u_b])
            s1b = udf(vb + 3 * eps * out_vec)
            s2b = udf(vb - 3 * eps * out_vec)
            # +1 toward the larger distance; the first side on a tie
            sign = torch.where(s1b >= s2b, 1.0, -1.0)
            out_vec = sign * out_vec
            keep = ((s1b + s2b).detach()[:, 0] > eps).cpu().numpy()  # real rims only
            if keep.any():
                k = torch.as_tensor(keep, device=dev)
                out_df = torch.maximum(s1b, s2b)[k]
                s_border = eps * (out_df - out_df.detach())
                new_verts = new_verts.index_add(0, u_idx[k], -s_border * out_vec[k])
    return new_verts
