"""Line plots rasterised with numpy, written as PNG (the card has no
matplotlib): the ray-statistics figure of ``Runner.visualize_one_ray``."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..data.png import write_png

LINE_BGR = (180, 119, 31)  # matplotlib's first colour, #1f77b4
MARGIN = 30


def _segment(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.rint(np.linspace(p0[0], p1[0], n)).astype(int)
    ys = np.rint(np.linspace(p0[1], p1[1], n)).astype(int)
    img[ys, xs] = color


def _panel(img, x: np.ndarray, y: np.ndarray):
    """One curve in the panel ``img`` (a view): a frame, the polyline and a
    3x3 marker at each finite point, both axes scaled to the data."""
    h, w, _ = img.shape
    img[MARGIN - 1, MARGIN - 1:w - MARGIN + 1] = 0
    img[h - MARGIN, MARGIN - 1:w - MARGIN + 1] = 0
    img[MARGIN - 1:h - MARGIN + 1, MARGIN - 1] = 0
    img[MARGIN - 1:h - MARGIN + 1, w - MARGIN] = 0
    ok = np.isfinite(x) & np.isfinite(y)
    if not ok.any():
        return
    x, y = x.astype(np.float64), y.astype(np.float64)
    scale = lambda v, lo, hi, n: (v - lo) / (hi - lo) * (n - 1) if hi > lo else np.full_like(
        v, (n - 1) / 2)
    px = MARGIN + scale(x, x[ok].min(), x[ok].max(), w - 2 * MARGIN)
    py = h - MARGIN - 1 - scale(y, y[ok].min(), y[ok].max(), h - 2 * MARGIN)
    pts = [(px[i], py[i]) if ok[i] else None for i in range(len(x))]
    for p0, p1 in zip(pts[:-1], pts[1:]):
        if p0 is not None and p1 is not None:
            _segment(img, p0, p1, LINE_BGR)
    for p in pts:
        if p is not None:
            cx, cy = int(round(p[0])), int(round(p[1]))
            img[cy - 1:cy + 2, cx - 1:cx + 2] = LINE_BGR


def plot_curves(path: str, x: np.ndarray, curves: Dict[str, np.ndarray],
                panel_size=(1000, 420)) -> None:
    """Each curve of ``curves`` drawn against ``x[:len(y)]`` in a panel of
    its own, the panels stacked top to bottom in the dict's order, white
    background; written to ``path`` as PNG. Panels carry no text."""
    w, h = panel_size
    img = np.full((h * len(curves), w, 3), 255, np.uint8)
    for i, y in enumerate(curves.values()):
        y = np.asarray(y).reshape(-1)
        _panel(img[i * h:(i + 1) * h], np.asarray(x).reshape(-1)[:len(y)], y)
    write_png(path, img)
