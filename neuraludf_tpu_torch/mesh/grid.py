"""Chunked grid queries on the device for mesh extraction (counterpart of
``neuraludf_tpu/mesh/grid.py``).

The parallel part of MeshUDF: fill an N³ grid with distance values and,
where the field is near zero, normalized gradients. Every grid point is made
on the device from its linear index, chunk by chunk (``CHUNK`` points), in
the JAX package's f32 order: ``bmin + [i,j,k]/(R-1)·(bmax-bmin)`` for the
fill, ``ijk/(N-1)·2 − 1`` for the near band. The band is selected, decoded
and given its normals on the device; the grid and its normals then move to
the host once each, for the marching cubes.

The products run at the distance field's "distance" role, true f32
(``nets/mlp.py`` ``PRECISION_POLICY``). The port never enables TF32
(``torch.backends.cuda.matmul.allow_tf32`` keeps its default, False), so a
grid on the card differs from one on the CPU only by summation order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import UDFNetworkConfig
from ..nets import fields

CHUNK = 1 << 20  # points per evaluation


def _frozen(udf_params: dict) -> dict:
    """The distance field's parameters cut from any graph: grid queries
    differentiate with respect to the points only."""
    return {k: _frozen(v) if isinstance(v, dict) else v.detach() for k, v in udf_params.items()}


def device_of(udf_params: dict) -> torch.device:
    """The device of a (nested) parameter dict's first leaf."""
    leaf = udf_params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.device


def _value(p: dict, pts: torch.Tensor, cfg: UDFNetworkConfig, signed: bool) -> torch.Tensor:
    """Distance values [n]; |sdf| for a signed field (model_type 'neus')."""
    v = fields.distance_value(p, pts, cfg)[:, 0]
    return v.abs() if signed else v


def _normalized_gradient(p: dict, pts: torch.Tensor, cfg: UDFNetworkConfig,
                         signed: bool) -> torch.Tensor:
    """Normalized spatial gradient [n, 3], by one first-order backward (no
    double-backward graph is kept). For a signed field it is the gradient of
    |sdf|, sign(sdf)·∇sdf, so the pseudo-sign voting sees the same opposing
    gradients across the surface as for a genuine UDF."""
    with torch.enable_grad():
        x = pts.detach().requires_grad_(True)
        v = fields.distance_value(p, x, cfg)[:, 0]
        (g,) = torch.autograd.grad(v.sum(), x)
    if signed:
        g = g * torch.sign(v.detach())[:, None]
    return g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-5)


def _chunked(fn: Callable[[torch.Tensor], torch.Tensor], pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([fn(pts[i:i + CHUNK]) for i in range(0, pts.shape[0], CHUNK)])


def _ijk(lin: torch.Tensor, R: int) -> torch.Tensor:
    """Linear grid indices -> [n, 3] grid indices (i, j, k), axis 0 = x."""
    return torch.stack([(lin // (R * R)) % R, (lin // R) % R, lin % R], dim=-1)


def _decode(lin: torch.Tensor, R: int) -> torch.Tensor:
    return _ijk(lin, R).to(torch.float32)


def _band_points(lin: torch.Tensor, N: int) -> torch.Tensor:
    """Points of the [-1, 1]³ grid at linear indices ``lin``."""
    return _decode(lin, N) / (N - 1) * 2.0 - 1.0


def fill_on_device(udf_params: dict, cfg: UDFNetworkConfig, bound_min, bound_max,
                   resolution: int, signed: bool = False) -> torch.Tensor:
    """Distance values of the axis-aligned R³ grid, flat [R³] on the
    parameters' device; the points are made per chunk on the device."""
    p = _frozen(udf_params)
    dev = device_of(p)
    R = resolution
    bmin, bmax = (torch.tensor(np.asarray(b, np.float32), device=dev)
                  for b in (bound_min, bound_max))
    out = torch.empty(R ** 3, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for start in range(0, R ** 3, CHUNK):
            lin = torch.arange(start, min(start + CHUNK, R ** 3), device=dev)
            frac = _decode(lin, R) / (R - 1)
            out[start:start + lin.shape[0]] = _value(p, bmin + frac * (bmax - bmin), cfg, signed)
    return out


def band_normals_on_device(udf_params: dict, cfg: UDFNetworkConfig, udf: torch.Tensor,
                           resolution: int, signed: bool = False) -> torch.Tensor:
    """Negated normalized gradients [N³, 3] of the [-1, 1]³ grid where
    udf < 2·voxel, zero elsewhere, on udf's device."""
    N = resolution
    voxel_size = 2.0 / (N - 1)
    p = _frozen(udf_params)
    normals = torch.zeros((N ** 3, 3), dtype=torch.float32, device=udf.device)
    near = torch.nonzero(udf < 2 * voxel_size).squeeze(1)
    if near.numel():
        g = _chunked(lambda x: _normalized_gradient(p, x, cfg, signed), _band_points(near, N))
        normals[near] = -g
    return normals


def extract_fields(params, cfg: UDFNetworkConfig, bound_min, bound_max, resolution: int,
                   signed: bool = False) -> np.ndarray:
    """Distance values on an axis-aligned grid: [R, R, R] (axis0 = x).

    ``signed=True`` returns |value| (the neus MeshUDF route); the raw field
    dumps (``validate_fields``) keep signed=False and so give the signed
    values of an SDF."""
    R = resolution
    u = fill_on_device(params["udf"], cfg, bound_min, bound_max, R, signed)
    return u.cpu().numpy().reshape(R, R, R)


def extract_gradient_fields(params, cfg: UDFNetworkConfig, bound_min, bound_max,
                            resolution: int) -> np.ndarray:
    """Normalized gradients [R, R, R, 3] on the grid of ``np.linspace`` axes
    (the JAX package's ``grid_points``); only the three axes are uploaded."""
    R = resolution
    p = _frozen(params["udf"])
    dev = device_of(p)
    axes = torch.tensor(np.stack([
        np.linspace(bound_min[a], bound_max[a], R, dtype=np.float32) for a in range(3)]),
        device=dev)  # [3, R]
    out = torch.empty((R ** 3, 3), dtype=torch.float32, device=dev)
    for start in range(0, R ** 3, CHUNK):
        lin = torch.arange(start, min(start + CHUNK, R ** 3), device=dev)
        ijk = _ijk(lin, R)
        pts = torch.stack([axes[a][ijk[:, a]] for a in range(3)], dim=-1)
        out[start:start + lin.shape[0]] = _normalized_gradient(p, pts, cfg, False)
    return out.cpu().numpy().reshape(R, R, R, 3)


def udf_and_normals_grid(params, cfg: UDFNetworkConfig, resolution: int,
                         signed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """MeshUDF grid fill over [-1, 1]³.

    Returns (udf [N,N,N], normals [N,N,N,3]) where normals are the NEGATED
    normalized gradients (pointing toward the surface), evaluated only where
    udf < 2 * voxel_size; zero elsewhere.
    """
    N = resolution
    udf = fill_on_device(params["udf"], cfg, [-1, -1, -1], [1, 1, 1], N, signed)
    normals = band_normals_on_device(params["udf"], cfg, udf, N, signed)
    return udf.cpu().numpy().reshape(N, N, N), normals.cpu().numpy().reshape(N, N, N, 3)


def query_udf_at(params, cfg: UDFNetworkConfig, pts: np.ndarray,
                 signed: bool = False) -> np.ndarray:
    """Distance values [n] at host points [n, 3], uploaded once."""
    p = _frozen(params["udf"])
    x = torch.tensor(np.asarray(pts, np.float32), device=device_of(p))
    if x.shape[0] == 0:
        return np.zeros(0, np.float32)
    with torch.no_grad():
        return _chunked(lambda c: _value(p, c, cfg, signed), x).cpu().numpy()


def _full_cache(params, cfg: UDFNetworkConfig, N: int, signed: bool):
    udf3, nrm3 = udf_and_normals_grid(params, cfg, N, signed)
    cache = {"udf": udf3.reshape(-1).copy(), "normals": nrm3.reshape(-1, 3).copy(),
             "indices": None, "incr_count": 0}
    return udf3, nrm3, cache


def udf_and_normals_grid_incremental(
    params, cfg: UDFNetworkConfig, resolution: int, cache: Optional[Dict] = None,
    *, signed: bool = False,
    full_refill_every: int = 8, drift_refill_ratio: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Incremental MeshUDF grid fill.

    On the first call (or a cache mismatch) this is a full fill; on later
    calls only the cached ``indices`` (the voxels around the previous
    extraction's surface) are queried again, value and negated normalized
    gradient. Returns (udf [N³ grid], normals [N³ grid, 3], cache); pass the
    cache back in after ``meshudf.next_update_indices`` has refreshed its
    "indices" entry. The cache lives on the host; the indices go to the
    device once.

    Staleness guards: a full refill every ``full_refill_every`` incremental
    calls, and at once when the re-queried band's mean |Δudf| exceeds
    ``drift_refill_ratio``·voxel_size.
    """
    N = resolution
    if (
        cache is None
        or cache.get("indices") is None
        or cache.get("udf") is None
        or cache["udf"].size != N ** 3
        or (full_refill_every > 0 and cache.get("incr_count", 0) >= full_refill_every)
    ):
        return _full_cache(params, cfg, N, signed)

    idx = np.unique(np.asarray(cache["indices"], np.int64))
    idx = idx[(idx >= 0) & (idx < N ** 3)]
    p = _frozen(params["udf"])
    pts = _band_points(torch.as_tensor(idx, device=device_of(p)), N)
    with torch.no_grad():
        new_udf_dev = (_chunked(lambda c: _value(p, c, cfg, signed), pts) if idx.size
                       else pts.new_zeros(0))
    new_udf = new_udf_dev.cpu().numpy()
    voxel_size = 2.0 / (N - 1)
    drift = float(np.abs(new_udf - cache["udf"][idx]).mean()) if idx.size else 0.0
    if drift > drift_refill_ratio * voxel_size:
        # the field moved more than the band covers: stale cached values
        # outside the band would distort the mesh
        return _full_cache(params, cfg, N, signed)
    cache["incr_count"] = cache.get("incr_count", 0) + 1
    cache["udf"][idx] = new_udf
    if idx.size:
        # gradients only inside the 2-voxel band, zero elsewhere, as in the
        # full fill, so an unchanged field extracts again the same surface
        g = _chunked(lambda c: _normalized_gradient(p, c, cfg, signed), pts)
        band = (new_udf_dev < 2 * voxel_size)[:, None]
        cache["normals"][idx] = torch.where(band, -g, 0.0).cpu().numpy()
    return cache["udf"].reshape(N, N, N), cache["normals"].reshape(N, N, N, 3), cache
