"""Camera matrix decomposition (a frozen copy of the port's
``data/cameras.py``).

IDR-convention scenes store, per view, a 3x4 projection ``P = K @ [R|t]``.
This recovers K (normalised so K[2,2] = 1) and the camera-to-world pose with
a numpy RQ decomposition: the machine with the card has no OpenCV, so the
port keeps only the branch of the JAX package that needs none.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rq_decompose(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """RQ decomposition of a 3x3 matrix: M = R @ Q with R upper-triangular
    (positive diagonal) and Q orthonormal, from numpy's QR by the flip trick."""
    P = np.fliplr(np.eye(3))
    q, r = np.linalg.qr((P @ M).T)
    R = P @ r.T @ P
    Q = P @ q.T
    signs = np.sign(np.diag(R))
    signs[signs == 0] = 1.0
    R = R * signs[None, :]
    Q = Q * signs[:, None]
    return R, Q


def decompose_projection(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a 3x4 projection into (intrinsics 4x4, c2w pose 4x4)."""
    P = np.asarray(P, np.float64)[:3, :4]
    K, R = _rq_decompose(P[:3, :3])
    center = -np.linalg.inv(P[:3, :3]) @ P[:3, 3]  # P @ [c, 1]^T = 0
    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K.astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T.astype(np.float32)  # R is the world-to-camera rotation
    pose[:3, 3] = center.astype(np.float32)
    return intrinsics, pose
