"""The cells' scenes: frozen copies of the port's sphere and garment ray
tracers (``data/synthetic.py``), and the cache that writes a scene once.

A scene is an IDR-layout directory (``cameras.npz``, ``image/*.png``,
``mask/*.png``) that both the port's ``Dataset`` and the plain reference
read. ``ensure_scene`` writes it on a cell's first run into a fixed
directory inside the checkout, named by its parameters, and later runs read
it from there.

* ``sphere``: closed surface, a sphere at the origin (radius 0.5 unless the
  spec gives another ``radius``), seen from a ring of cameras at alternating
  elevations.
* ``garment``: the DF3D stand-in, a draped open skirt with openings at both
  ends (a zero-thickness double-sided sheet) over a black background.
"""

from __future__ import annotations

import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np

from reference.png import write_png

CACHE = Path(__file__).resolve().parents[1] / ".cache" / "scenes"


def _radius(spec: Dict[str, Any]) -> float:
    r = float(spec.get("radius", SPHERE_RADIUS))
    if r != SPHERE_RADIUS and spec["kind"] != "sphere":
        raise ValueError(f"a radius is a sphere's; the scene is a {spec['kind']}")
    return r


def scene_dir(spec: Dict[str, Any], cache: Path = CACHE) -> Path:
    """The fixed directory of a scene: {kind, views, height, width, focal}
    and, for a sphere of another radius than 0.5, ``radius``."""
    name = (f"{spec['kind']}_{spec['views']}v_{spec['height']}x{spec['width']}"
            f"_f{spec['focal']:g}")
    r = _radius(spec)
    return Path(cache) / (name if r == SPHERE_RADIUS else f"{name}_r{r:g}")


def ensure_scene(spec: Dict[str, Any], cache: Path = CACHE) -> tuple:
    """The scene's directory, written first if it is not complete; returns
    (directory, seconds spent writing it)."""
    out = scene_dir(spec, cache)
    if (out / "cameras.npz").exists():
        return out, 0.0
    t0 = time.time()
    tmp = out.with_name(out.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    generate_scene(str(tmp), kind=spec["kind"], n_views=int(spec["views"]),
                   H=int(spec["height"]), W=int(spec["width"]), focal=float(spec["focal"]),
                   radius=_radius(spec))
    shutil.rmtree(out, ignore_errors=True)
    os.replace(tmp, out)
    return out, time.time() - t0


SPHERE_RADIUS = 0.5
GARMENT_Y_TOP = 0.35  # waist opening
GARMENT_Y_BOT = -0.45  # hem opening


def garment_radius(y: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Skirt radius field R(y, θ) of the ``garment`` benchmark shell: a
    linear waist→hem flare with seven drape folds whose amplitude grows
    toward the hem (phase-modulated so folds are not perfectly periodic —
    the DF3D garments' drape is irregular)."""
    s = (GARMENT_Y_TOP - y) / (GARMENT_Y_TOP - GARMENT_Y_BOT)  # 0 waist, 1 hem
    base = 0.16 + 0.26 * s
    amp = 0.005 + 0.045 * s
    return (base + amp * np.cos(7.0 * theta + 0.8 * np.sin(2.0 * theta + 1.3))).astype(
        np.float32
    )


def _garment_f(pts: np.ndarray) -> np.ndarray:
    """Implicit function of the (uncut, infinite-flute) garment surface:
    cylindrical-radial distance to the drape sheet. The y-slab cut is the
    `cut` predicate, exactly like the lobed cap cut."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r_cyl = np.sqrt(x * x + z * z)
    theta = np.arctan2(z, x)
    return (r_cyl - garment_radius(y, theta)).astype(np.float32)


def _garment_cut(p: np.ndarray) -> np.ndarray:
    return (p[:, 1] >= GARMENT_Y_BOT) & (p[:, 1] <= GARMENT_Y_TOP)


def _numeric_normal(f, pts: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Geometric (unoriented) normal via central differences of f."""
    n = np.empty_like(pts)
    for a in range(3):
        off = np.zeros((1, 3), np.float32)
        off[0, a] = eps
        n[:, a] = f(pts + off) - f(pts - off)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return n


def _trace_implicit(rays_o, rays_d, f, cut, bound: float,
                    n_steps: int = 192, max_crossings: int = 4):
    """Exact open-shell trace: walk the bounding-sphere span, bisect every
    sign change of f in order, keep the first crossing that survives the
    cut (a ray through an opening legitimately hits the INNER wall).
    Returns (hit, points, normals). All dense work is subset to the rays
    that intersect the bounding sphere (~20% of a full frame)."""
    N = rays_o.shape[0]
    b = np.sum(rays_o * rays_d, axis=-1)
    c = np.sum(rays_o * rays_o, axis=-1) - bound * bound
    disc = b * b - c
    span = np.flatnonzero(disc > 0.0)
    hit = np.zeros(N, bool)
    pts = np.full((N, 3), 2.0, np.float32)
    if len(span) == 0:
        return hit, pts, np.zeros((N, 3), np.float32)

    o, d = rays_o[span], rays_d[span]
    sq = np.sqrt(disc[span])
    t0 = np.maximum(-b[span] - sq, 0.0)
    t1 = np.maximum(-b[span] + sq, 0.0)
    ts = t0[:, None] + (t1 - t0)[:, None] * np.linspace(0.0, 1.0, n_steps, dtype=np.float32)[None]
    fs = f(o[:, None, :] + ts[..., None] * d[:, None, :])
    sign_change = fs[:, :-1] * fs[:, 1:] < 0.0
    order = np.cumsum(sign_change, axis=1)  # 1-based index of each crossing

    s_hit = np.zeros(len(span), bool)
    s_pts = np.full((len(span), 3), 2.0, np.float32)
    for k in range(1, max_crossings + 1):
        todo = np.flatnonzero(~s_hit & (order[:, -1] >= k))
        if len(todo) == 0:
            break
        idx = np.argmax(sign_change[todo] & (order[todo] == k), axis=1)
        lo = ts[todo, idx]
        hi = ts[todo, idx + 1]
        flo = fs[todo, idx]
        ot, dt = o[todo], d[todo]
        for _ in range(22):  # (t1-t0)/n_steps / 2^22 ~ 1e-9 — exact
            mid = 0.5 * (lo + hi)
            fm = f(ot + mid[:, None] * dt)
            same = (fm * flo) > 0.0
            lo = np.where(same, mid, lo)
            flo = np.where(same, fm, flo)
            hi = np.where(same, hi, mid)
        p = ot + (0.5 * (lo + hi))[:, None] * dt
        ok = cut(p)
        s_pts[todo[ok]] = p[ok]
        s_hit[todo[ok]] = True
    pts[span] = s_pts
    hit[span] = s_hit
    normals = np.zeros((N, 3), np.float32)
    if s_hit.any():
        normals[span[s_hit]] = _numeric_normal(f, s_pts[s_hit])
    return hit, pts, normals


def _trace_garment(rays_o, rays_d):
    # folds can graze a near-tangent ray repeatedly: 6 crossings, finer scan
    return _trace_implicit(
        rays_o, rays_d, _garment_f, _garment_cut, 0.75,
        n_steps=256, max_crossings=6,
    )


def look_at_pose(
    loc, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)
) -> np.ndarray:
    """Camera-to-world pose (OpenCV convention: +z forward) looking from
    `loc` toward `target`."""
    loc = np.asarray(loc, np.float32)
    z = np.asarray(target, np.float32) - loc
    z = z / np.linalg.norm(z)
    upv = np.asarray(up, np.float32)
    x = np.cross(upv, z)
    if np.linalg.norm(x) < 1e-6:  # looking straight along `up`
        x = np.cross(np.asarray([1.0, 0.0, 0.0], np.float32), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, y, z, loc
    return pose


def _camera_ring(n_views: int, dist: float = 2.2) -> np.ndarray:
    """Camera centers on a sphere of radius `dist`: a ring with strongly
    alternating elevations (up to ~±30°), plus every fourth view raised to
    ~65° elevation. The steep views look INTO an open mouth (capsule/lobed
    cuts face +y): without them, mouth-entering rays are so oblique that a
    phantom lid just below the rim occludes only a sliver of inner wall and
    survives training (measured: diaphragm at y=0.16 on the capsule with a
    ±33° ring)."""
    locs = []
    for i in range(n_views):
        ang = 2.0 * np.pi * i / n_views
        if i % 4 == 2:
            elev_angle = np.deg2rad(65.0)
            d = np.array(
                [np.cos(elev_angle) * np.sin(ang), np.sin(elev_angle),
                 -np.cos(elev_angle) * np.cos(ang)], np.float32)
        else:
            elev = 0.45 * np.sin(2.0 * ang + 0.7) + 0.12
            d = np.array([np.sin(ang), elev, -np.cos(ang)], np.float32)
        locs.append(d / np.linalg.norm(d) * dist)
    return np.stack(locs)


def _trace(rays_o, rays_d, r: float):
    """Closest valid hit with the sphere of radius r at the origin.
    Returns (hit mask, hit points, normals) — all [N, ...]."""
    b = np.sum(rays_o * rays_d, axis=-1)
    c = np.sum(rays_o * rays_o, axis=-1) - r * r
    disc = b * b - c
    ok = disc > 0.0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t1, t2 = -b - sq, -b + sq

    def valid(t):
        pts = rays_o + t[:, None] * rays_d
        v = ok & (t > 0.0)
        return v, pts

    v1, p1 = valid(t1)
    v2, p2 = valid(t2)
    hit = v1 | v2
    pts = np.where(v1[:, None], p1, p2)
    normals = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-8)
    # back faces (inside of the open shell) flip toward the viewer
    facing = np.sum(normals * rays_d, axis=-1, keepdims=True)
    normals = np.where(facing > 0, -normals, normals)
    return hit, pts, normals


def _camera_rig_garment(n_views: int = 49, dist: float = 2.2) -> np.ndarray:
    """DF3D-like rig: a full golden-angle spiral band (−35°…60°) around the
    garment — the DeepFashion3D renderings circle the mannequin and include
    below-hem views (the skirt has openings at BOTH ends)."""
    return _spiral_rig(n_views, dist, -35.0, 60.0)


def _spiral_rig(n_views: int, dist: float, elev_lo: float, elev_hi: float) -> np.ndarray:
    ga = np.pi * (3.0 - np.sqrt(5.0))
    i = np.arange(n_views, dtype=np.float32)
    elev = np.deg2rad(elev_lo + (elev_hi - elev_lo) * (i + 0.5) / n_views)
    az = ga * i
    d = np.stack(
        [np.cos(elev) * np.sin(az), np.sin(elev), -np.cos(elev) * np.cos(az)], axis=-1
    ).astype(np.float32)
    return d * dist


_LIGHT = np.array([0.48, 0.6, -0.64], np.float32)
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)
_LIGHT2 = np.array([-0.55, 0.25, 0.55], np.float32)
_LIGHT2 = _LIGHT2 / np.linalg.norm(_LIGHT2)


ENV_RADIUS = 4.0


def _env_background(rays_o, rays_d):
    """3D-CONSISTENT background: a textured environment sphere at r=4.

    A purely direction-dependent backdrop is degenerate for womask
    training — the background NeRF can then paint the object's outer
    annulus (rim pixels are grazing directions unique to one view) and the
    foreground geometry shrinks; measured on the old backdrop: the sphere
    reconstructed at r=0.417±0.044 instead of 0.5 (Chamfer 0.081). A
    world-anchored texture pins every background ray the way DTU's real
    table/backdrop geometry does."""
    b = np.sum(rays_o * rays_d, axis=-1)
    c = np.sum(rays_o * rays_o, axis=-1) - ENV_RADIUS * ENV_RADIUS
    t = -b + np.sqrt(np.maximum(b * b - c, 0.0))  # camera is inside: far root
    p = rays_o + t[..., None] * rays_d
    u = np.arctan2(p[..., 2], p[..., 0])
    v = np.arccos(np.clip(p[..., 1] / ENV_RADIUS, -1.0, 1.0))
    checker = (np.floor(u / np.pi * 8.0) + np.floor(v / np.pi * 8.0)) % 2.0
    base = np.stack(
        [
            0.30 + 0.16 * np.sin(2.0 * u) * np.sin(v),
            0.28 + 0.14 * np.sin(3.0 * v + 1.0),
            0.32 + 0.16 * np.cos(2.0 * u + 0.5) * np.sin(v),
        ],
        axis=-1,
    )
    return (base * (0.85 + 0.3 * checker[..., None])).astype(np.float32)


def _texture(pts):
    """High-frequency multi-scale albedo, [N, 3].

    Geometry anchoring on synthetic scenes is carried by texture PARALLAX:
    a reconstruction displaced from the true surface sees fine texture
    inconsistently across views and pays photometric loss (the mechanism
    that anchors real DTU scans). A coarse 4x4 checker is too forgiving —
    measured: the sphere trained to a lumpy r=0.42 blob at 30k with clean
    per-view renders. 12-band checker + positional modulation fixes the
    scale the parallax constraint acts on."""
    u = np.arctan2(pts[:, 2], pts[:, 0])
    rad = np.maximum(np.linalg.norm(pts, axis=-1), 1e-9)
    v = np.arccos(np.clip(pts[:, 1] / rad, -1.0, 1.0))
    checker = (np.floor(u / np.pi * 12.0) + np.floor(v / np.pi * 12.0)) % 2.0
    c0 = np.array([0.25, 0.35, 0.75], np.float32)  # BGR-ish warm
    c1 = np.array([0.70, 0.55, 0.25], np.float32)
    albedo = np.where(checker[:, None] > 0.5, c0[None], c1[None])
    # positional "grain" at a finer scale (multi-view consistent by
    # construction — pure function of the 3D point)
    grain = (
        np.sin(41.0 * pts[:, 0]) * np.sin(37.0 * pts[:, 1]) * np.sin(43.0 * pts[:, 2])
    )
    return albedo * (0.85 + 0.15 * grain[:, None])


def _shade(pts, normals, rays_o, rays_d, hit):
    """Fine checkerboard albedo, fixed-light Lambertian, and a headlight
    factor, [N, 3].

    The |n·view| factor darkens every silhouette rim in every view — a
    strong photometric anchor AGAINST silhouette shrinkage: a shrunken
    surface would show bright interior albedo where the target image is
    dark, and neither the view-dependent color net nor the background NeRF
    can cheaply fake the missing dark annulus."""
    n_geo = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-8)
    lambert = np.abs(n_geo @ _LIGHT)[:, None]
    head = np.abs(np.sum(normals * rays_d, axis=-1, keepdims=True))
    color = _texture(pts) * (0.35 + 0.65 * lambert) * (0.40 + 0.60 * head)
    return np.where(hit[:, None], color, _env_background(rays_o, rays_d))


def _shade_garment(pts, normals, rays_o, rays_d, hit):
    """Garment shading: the lobed texture/light stack over a BLACK
    background. The garment recipe trains with n_outside=0 and no mask loss
    (ref confs/udf_garment_blending.conf:44,122): there is no background
    model at all, so zero radiance outside the object is what makes the
    composite consistent (the DF3D renderings are black-backed too)."""
    u = np.arctan2(pts[:, 2], pts[:, 0])
    y = pts[:, 1]
    # fold-following stripe pattern + fine grain: strong parallax anchors
    stripes = 0.5 + 0.5 * np.sin(14.0 * u + 9.0 * y)
    albedo = _texture(pts) * (0.70 + 0.30 * stripes[:, None])
    l1 = np.abs(normals @ _LIGHT)[:, None]
    l2 = np.abs(normals @ _LIGHT2)[:, None]
    head = np.abs(np.sum(normals * rays_d, axis=-1, keepdims=True))
    color = albedo * (0.30 + 0.50 * l1 + 0.20 * l2) * (0.40 + 0.60 * head)
    return np.where(hit[:, None], color, np.zeros((1, 3), np.float32))


def generate_scene(
    out_dir: str,
    kind: str = "sphere",
    n_views: int = 16,
    H: int = 600,
    W: int = 800,
    focal: float = 900.0,
    radius: float = SPHERE_RADIUS,
) -> None:
    """Ray-trace and write an IDR-layout scene directory."""
    if kind not in ("sphere", "garment"):
        raise ValueError(f"scene kind must be sphere or garment, got {kind!r}")
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)

    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = focal
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0

    xs, ys = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    K_inv = np.linalg.inv(K[:3, :3])
    dirs_cam = pix @ K_inv.T
    dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)

    if kind == "garment":
        rig = _camera_rig_garment(n_views)
    else:
        rig = _camera_ring(n_views)
    cams = {}
    for i, loc in enumerate(rig):
        pose = look_at_pose(loc)
        rays_d = dirs_cam @ pose[:3, :3].T
        rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
        if kind == "garment":
            # chunked: the sign-change scan holds [chunk, n_steps] floats
            hs, ps, ns = [], [], []
            for s in range(0, len(rays_d), 200_000):
                h, p, n = _trace_garment(rays_o[s : s + 200_000], rays_d[s : s + 200_000])
                hs.append(h), ps.append(p), ns.append(n)
            hit = np.concatenate(hs)
            pts = np.concatenate(ps)
            normals = np.concatenate(ns)
            color = _shade_garment(pts, normals, rays_o, rays_d, hit)
        else:
            hit, pts, normals = _trace(rays_o, rays_d, radius)
            color = _shade(pts, normals, rays_o, rays_d, hit)

        img = (color.reshape(H, W, 3) * 255.0).clip(0, 255).astype(np.uint8)
        msk = (hit.reshape(H, W).astype(np.uint8) * 255)[..., None].repeat(3, axis=-1)
        write_png(os.path.join(out_dir, "image", f"{i:03d}.png"), img)
        write_png(os.path.join(out_dir, "mask", f"{i:03d}.png"), msk)

        cams[f"world_mat_{i}"] = (K @ np.linalg.inv(pose)).astype(np.float32)
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)

    np.savez(os.path.join(out_dir, "cameras.npz"), **cams)
