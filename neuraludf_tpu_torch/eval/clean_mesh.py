"""DTU mesh cleaning: mask-visibility and visual-hull filtering (counterpart
of ``neuraludf_tpu/eval/clean_mesh.py``).

Vertices are projected into every (dilated) view mask; vertices visible in
too few masks, or outside the visual hull in too many views, are dropped
along with their faces. Masks are read with the port's ``data/png.py`` and
dilated with ``scipy.ndimage`` by OpenCV's elliptic structuring element, so
the result is what ``cv.dilate`` gives.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from ..data.png import read_png
from ..mesh.ply import export_ply, load_ply


def _project_and_lookup(points, P, mask_image, border: int):
    H, W = mask_image.shape
    pts_image = (P[None, :3, :3] @ points[:, :, None])[:, :, 0] + P[None, :3, 3]
    pts_image = pts_image / pts_image[:, 2:]
    pix = np.round(pts_image).astype(np.int32) + 1  # +1 for the padding row/col
    in_mask = (
        (pix[:, 0] >= border) & (pix[:, 0] <= W - border)
        & (pix[:, 1] >= border) & (pix[:, 1] <= H - border)
    )
    padded = np.pad(mask_image, 1, constant_values=True)
    cur = padded[pix[:, 1].clip(0, H + 1), pix[:, 0].clip(0, W + 1)]
    return cur.astype(np.float32) * in_mask


def ellipse_element(kernel_size: int) -> np.ndarray:
    """OpenCV's ``getStructuringElement(MORPH_ELLIPSE, (k, k))``: the rows of
    a disc inscribed in the k x k square, half-widths rounded to nearest."""
    r = c = kernel_size // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    el = np.zeros((kernel_size, kernel_size), np.uint8)
    for i in range(kernel_size):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            el[i, max(c - dx, 0):min(c + dx + 1, kernel_size)] = 1
    return el


def dilate(image: np.ndarray, element: np.ndarray) -> np.ndarray:
    """``cv.dilate(image, element)`` for uint8 images: the maximum over the
    element centred on each pixel (anchor k // 2), pixels outside the image
    ignored."""
    fp = element.astype(bool)
    if image.ndim == 3:
        fp = fp[:, :, None]
    return ndimage.maximum_filter(image, footprint=fp, mode="constant", cval=0)


def _load_dilated_mask(path: str, kernel_size: int, inside: bool) -> np.ndarray:
    mask_image = dilate(read_png(path), ellipse_element(kernel_size))
    return mask_image[:, :, 0] > 128 if inside else mask_image[:, :, 0] < 128


def clean_points_by_mask(points, data_dir: str, imgs_idx: Optional[Sequence[int]] = None,
                         minimal_vis: int = 0, mask_dilated_size: int = 11):
    """Keep vertices seen inside > minimal_vis dilated masks
    (ref: clean_dtu_mesh.py:36-68)."""
    cameras = np.load(os.path.join(data_dir, "cameras.npz"))
    mask_lis = sorted(glob(os.path.join(data_dir, "mask/*.png")))
    if imgs_idx is None:
        imgs_idx = range(len(mask_lis))
    inside = np.zeros(len(points))
    for i in imgs_idx:
        P = cameras[f"world_mat_{i}"]
        m = _load_dilated_mask(mask_lis[i], mask_dilated_size, inside=True)
        inside += _project_and_lookup(points, P, m, border=0)
    return inside > minimal_vis


def clean_points_by_visualhull(points, data_dir: str, imgs_idx: Optional[Sequence[int]] = None,
                               max_outside: int = 5, mask_dilated_size: int = 11,
                               border: int = 50):
    """Drop vertices observed OUTSIDE the dilated mask in >= max_outside
    views (ref: clean_dtu_mesh.py:71-105)."""
    cameras = np.load(os.path.join(data_dir, "cameras.npz"))
    mask_lis = sorted(glob(os.path.join(data_dir, "mask/*.png")))
    if imgs_idx is None:
        imgs_idx = range(len(mask_lis))
    outside = np.zeros(len(points))
    for i in imgs_idx:
        P = cameras[f"world_mat_{i}"]
        m = _load_dilated_mask(mask_lis[i], mask_dilated_size, inside=False)
        outside += _project_and_lookup(points, P, m, border=border)
    return outside < max_outside


def _filter_mesh_by_vertex_mask(verts, faces, mask) -> Tuple[np.ndarray, np.ndarray]:
    index = -np.ones(len(verts), np.int64)
    index[mask] = np.arange(mask.sum())
    fm = mask[faces[:, 0]] & mask[faces[:, 1]] & mask[faces[:, 2]]
    new_faces = index[faces[fm]].astype(np.int32)
    return verts[mask], new_faces


def clean_mesh_faces_by_mask(mesh_file: str, new_mesh_file: str, data_dir: str,
                             imgs_idx=None, minimal_vis: int = 0, mask_dilated_size: int = 11):
    verts, faces = load_ply(mesh_file)
    mask = clean_points_by_mask(verts.astype(np.float64), data_dir, imgs_idx,
                                minimal_vis, mask_dilated_size)
    v, f = _filter_mesh_by_vertex_mask(verts, faces, mask)
    export_ply(new_mesh_file, v, f)
    return new_mesh_file


def clean_mesh_faces_by_visualhull(mesh_file: str, new_mesh_file: str, data_dir: str,
                                   imgs_idx=None, mask_dilated_size: int = 11,
                                   border: int = 50):
    verts, faces = load_ply(mesh_file)
    mask = clean_points_by_visualhull(verts.astype(np.float64), data_dir, imgs_idx,
                                      mask_dilated_size=mask_dilated_size, border=border)
    v, f = _filter_mesh_by_vertex_mask(verts, faces, mask)
    export_ply(new_mesh_file, v, f)
    return new_mesh_file


def connected_components(faces: np.ndarray, n_verts: int):
    """Union-find over face-connected vertices; returns per-face component ids."""
    parent = np.arange(n_verts)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for f in faces:
        a, b, c = find(f[0]), find(f[1]), find(f[2])
        parent[b] = a
        parent[c] = a
    roots = np.array([find(v) for v in faces[:, 0]])
    return roots


def clean_outliers(mesh_file: str, new_mesh_file: str, faces_num: int = 500,
                   keep_largest: bool = True):
    """Remove small disconnected components (ref: clean_dtu_mesh.py:158-191)."""
    verts, faces = load_ply(mesh_file)
    comp = connected_components(faces, len(verts))
    ids, counts = np.unique(comp, return_counts=True)
    if keep_largest:
        keep_ids = {ids[np.argmax(counts)]}
    else:
        keep_ids = set(ids[counts >= faces_num])
    fm = np.array([c in keep_ids for c in comp])
    faces = faces[fm]
    used = np.unique(faces)
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    export_ply(new_mesh_file, verts[used], remap[faces].astype(np.int32))
    return new_mesh_file
