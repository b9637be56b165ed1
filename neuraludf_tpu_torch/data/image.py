"""Bilinear image resize, the counterpart of OpenCV's
``cv.resize(..., interpolation=INTER_LINEAR)`` that the JAX package's
dataset calls (the card has no OpenCV).

Half-pixel centres, no antialiasing: a destination pixel ``d`` samples the
source at ``(d + 0.5) * scale - 0.5``, clamped to the image, with
``scale = source / destination`` when the size is given and ``1 / fx`` when
the factor is, as in OpenCV. OpenCV resizes ``uint8`` with 11-bit
fixed-point weights; this resize computes in float64 and rounds to the
nearest integer, so a ``uint8`` result may differ from OpenCV's by one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _taps(n_out: int, n_in: int, scale: float):
    """Source indices (lower, upper) and the upper weight of each output."""
    s = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(s)
    frac = s - lo
    lo = lo.astype(np.int64)
    frac[lo < 0] = 0.0
    lo[lo < 0] = 0
    last = lo >= n_in - 1
    frac[last] = 0.0
    lo[last] = n_in - 1
    return lo, np.minimum(lo + 1, n_in - 1), frac


def resize(img: np.ndarray, dsize: Optional[Tuple[int, int]] = None,
           fx: Optional[float] = None, fy: Optional[float] = None) -> np.ndarray:
    """img [H, W] or [H, W, C], uint8 or float. ``dsize`` is (width, height)
    as in OpenCV; without it the size is ``round(W * fx), round(H * fy)``
    (``fy`` defaults to ``fx``). Returns an array of img's dtype."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if dsize is None:
        if fx is None:
            raise ValueError("resize needs dsize or fx")
        fy = fx if fy is None else fy
        dsize = (int(round(w * fx)), int(round(h * fy)))
        sx, sy = 1.0 / fx, 1.0 / fy
    else:
        sx, sy = w / dsize[0], h / dsize[1]
    out_w, out_h = dsize
    if out_w <= 0 or out_h <= 0:
        raise ValueError(f"resize to an empty image: {dsize}")
    x0, x1, ax = _taps(out_w, w, sx)
    y0, y1, ay = _taps(out_h, h, sy)
    src = img.astype(np.float64)
    shape = (-1, 1) + (1,) * (img.ndim - 2)
    ax = ax[None].reshape((1, -1) + (1,) * (img.ndim - 2))
    ay = ay.reshape(shape)
    top = src[y0][:, x0] * (1.0 - ax) + src[y0][:, x1] * ax
    bottom = src[y1][:, x0] * (1.0 - ax) + src[y1][:, x1] * ax
    out = top * (1.0 - ay) + bottom * ay
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out.astype(img.dtype)
