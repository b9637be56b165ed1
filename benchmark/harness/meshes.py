"""The meshes of the runner's periodic actions, held to the plain reference.

At a multiple of ``val_mesh_freq`` the runner writes the classic mesh
(``validate_mesh``: marching cubes of its distance grid over the object's
box at a threshold t, ``meshes/<iter>_thresh<t>_res<R>.ply``) and the
MeshUDF mesh (``extract_udf_mesh``, ``udf_meshes/udf_res<R>_step<iter>.ply``),
both in world coordinates. ``session.Periodic`` keeps the parameters as
they were when the actions ran; the reference starts from that state of
the program (its distance network, the model's ``DISTANCE_NET``), whose
training up to there the first window's comparison checks (``check``).
Once the window has closed,
the model's plain distance function (``distance_value``, f32 with TF32 off)
is evaluated at every vertex, brought back to the object's frame by the
scene's own ``scale_mat_0``:

* ``mesh_gap``: the median over the classic mesh's vertices of
  |u_ref(v) - t|: each vertex lies where the program's grid crosses t,
  linearly interpolated between two grid points, so a sound program reads
  the interpolation's own error;
* ``udf_mesh_gap``: the median of u_ref over the MeshUDF mesh's vertices
  (the open surface, ideally at u = 0). There is no plain MeshUDF to put
  in the program's place as a control; its upper reading is a planted
  fault's, the mesh half a grid step off (``harness.faults``).

The control of ``mesh_gap`` (``control_gap``, read by ``calibrate.py
--meshes``): the reference's grid over the same box at the same
resolution, computed in the control's types, and its crossings of t along
the grid's edges, the points marching cubes puts vertices at, in the
program's place: the same median over them, under the same name.
"""

from __future__ import annotations

import contextlib
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

CHUNK = 1 << 20  # points a reference evaluation takes at once
CLASSIC = re.compile(r"_thresh([0-9.]+)_res(\d+)\.ply$")
BOX = 1.01  # the object's box, [-BOX, BOX]^3 in the object's frame (the runner's)
SAMPLE = 1 << 18  # crossings of the control's grid that are evaluated, drawn from the seed


def written(exp_dir: str, it: int) -> Dict[str, Path]:
    """The meshes the runner wrote at iteration ``it``: {"classic", "udf"}."""
    out = {}
    for key, pattern in (("classic", f"meshes/{it:0>8d}_thresh*_res*.ply"),
                         ("udf", f"udf_meshes/udf_res*_step{it}.ply")):
        found = sorted(Path(exp_dir).glob(pattern))
        if found:
            out[key] = found[0]
    return out


def read_ply(path: Path) -> Tuple[np.ndarray, int]:
    """The vertices [V, 3] (float32) and the face count of a binary
    little-endian PLY whose vertices have x, y, z alone."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").split("\n")
    if "format binary_little_endian 1.0" not in header:
        raise ValueError(f"{path}: not binary little-endian")
    n_v = n_f = 0
    for line in header:
        parts = line.split()
        if parts[:2] == ["element", "vertex"]:
            n_v = int(parts[2])
        elif parts[:2] == ["element", "face"]:
            n_f = int(parts[2])
    verts = np.frombuffer(data, "<f4", count=3 * n_v, offset=end).reshape(n_v, 3)
    return verts, n_f


def to_object(verts: np.ndarray, scene_dir: Path) -> np.ndarray:
    """World coordinates -> the object's frame, by the scene's scale_mat_0."""
    sm = np.load(Path(scene_dir) / "cameras.npz")["scale_mat_0"].astype(np.float64)
    return ((verts.astype(np.float64) - sm[:3, 3][None]) / sm[0, 0]).astype(np.float32)


def values(model, cfg, params, pts: np.ndarray, device) -> torch.Tensor:
    """u_ref at points [n, 3] of the object's frame, in chunks."""
    x = torch.as_tensor(pts, device=device)
    with torch.no_grad():
        return torch.cat([model.distance_value(cfg, params, x[i:i + CHUNK])
                          for i in range(0, x.shape[0], CHUNK)] or
                         [torch.zeros(0, device=device)])


def _median(t: torch.Tensor) -> float:
    return float(t.median()) if t.numel() else float("inf")


def gaps(model, cfg, event: Dict[str, Any], scene_dir: Path, device) -> Dict[str, float]:
    """``mesh_gap`` and ``udf_mesh_gap`` of the meshes of one periodic event
    (``session.Periodic``), with their vertex and face counts; a mesh that
    is missing, or has no vertex, reads inf."""
    out = {"mesh_gap": float("inf"), "udf_mesh_gap": float("inf")}
    meshes = event.get("meshes", {})
    params = event["state"][model.DISTANCE_NET] if "state" in event else None
    if "classic" in meshes:
        t, res = CLASSIC.search(meshes["classic"].name).groups()
        verts, n_f = read_ply(meshes["classic"])
        u = values(model, cfg, params, to_object(verts, scene_dir), device)
        out.update(mesh_gap=_median((u - float(t)).abs()), mesh_verts=len(verts),
                   mesh_faces=n_f, mesh_res=int(res))
    if "udf" in meshes:
        verts, n_f = read_ply(meshes["udf"])
        u = values(model, cfg, params, to_object(verts, scene_dir), device)
        out.update(udf_mesh_gap=_median(u.abs()), udf_mesh_verts=len(verts),
                   udf_mesh_faces=n_f)
    return out


def crossings(grid: torch.Tensor, t: float, lo: float, hi: float) -> torch.Tensor:
    """The points [n, 3] where a grid [R, R, R] of values over [lo, hi]^3
    (axis 0 = x) crosses t along its edges, linearly interpolated."""
    r = grid.shape[0]
    step = (hi - lo) / (r - 1)
    pts = []
    for axis in range(3):
        a = grid.narrow(axis, 0, r - 1)
        b = grid.narrow(axis, 1, r - 1)
        hit = ((a - t) * (b - t)) < 0
        idx = torch.nonzero(hit).to(torch.float32)
        frac = ((t - a[hit]) / (b[hit] - a[hit])).to(torch.float32)
        idx[:, axis] += frac
        pts.append(lo + idx * step)
    return torch.cat(pts)


def control_gap(model, cfg, params, t: float, res: int, device, rounding: Optional[tuple],
                seed: int) -> Dict[str, float]:
    """``mesh_gap`` of the crossings of t of the reference's own grid
    (``BOX``, ``res`` points an axis; the distance network's ``params``)
    computed under ``rounding`` (the control's types; None: f32, the
    reference's own interpolation floor), over at most SAMPLE crossings
    drawn from ``seed``."""
    ctx = model.rounded(*rounding) if rounding is not None else contextlib.nullcontext()
    axis = torch.linspace(-BOX, BOX, res, device=device)
    grid = torch.empty((res, res, res), device=device)
    with ctx, torch.no_grad():
        for i in range(res):  # one x-slab at a time
            yz = torch.stack(torch.meshgrid(axis, axis, indexing="ij"), -1).reshape(-1, 2)
            x = torch.cat([axis[i].expand(yz.shape[0], 1), yz], dim=1)
            grid[i] = model.distance_value(cfg, params, x).reshape(res, res)
    pts = crossings(grid, t, -BOX, BOX)
    del grid
    if pts.shape[0] > SAMPLE:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        pts = pts[torch.randperm(pts.shape[0], generator=gen, device=device)[:SAMPLE]]
    u = values(model, cfg, params, pts, device)
    return {"mesh_gap": _median((u - t).abs()), "mesh_points": int(pts.shape[0])}
