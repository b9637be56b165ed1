"""The validation image of the runner's periodic actions, held to the plain
reference.

At a multiple of ``val_freq`` the runner renders one view at its
``validate_resolution_level`` and writes the colour, the pixel-blended
colour (where it blends) and the ground truth stacked into
``validations_fine/<iter>_<view>.png``, each as ``(c * 256).clip(0, 255)``
cut to uint8. ``session.Periodic`` hands the runner's renderer the
benchmark's draws (the model's ``render_draws``) and keeps the whole
parameter tree as it was when the render ran. Once the window has closed,
the model's plain reference renders the same view from that state with
the same rays, chunks and draws (``reference_image``, f32 with TF32 off),
and its image, cut to uint8 the same way, is compared with the file's:

* ``image_gap``: the mean absolute difference in 8-bit levels over every
  channel of every pixel of the colour and the blended colour; a file
  that is missing or of another shape reads inf.

The control renders in the program's place in the control's types, and its
image goes through the same comparison (``calibrate.py --meshes``).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from reference.png import read_png

FILE = re.compile(r"^(\d{8})_(\d+)\.png$")


def written(exp_dir: str, it: int) -> Optional[Tuple[Path, int]]:
    """The validation image the runner wrote at iteration ``it`` and its
    view, or None."""
    for path in sorted(Path(exp_dir).glob(f"validations_fine/{it:0>8d}_*.png")):
        found = FILE.match(path.name)
        if found:
            return path, int(found.group(2))
    return None


def levels(colour: torch.Tensor) -> np.ndarray:
    """A colour image [H, W, 3] as the runner writes it: uint8 of
    ``(c * 256).clip(0, 255)``."""
    return (colour.detach().float().cpu().numpy() * 256).clip(0, 255).astype(np.uint8)


def gap(stacked: np.ndarray, colour: torch.Tensor,
        pixel: Optional[torch.Tensor]) -> Dict[str, float]:
    """``image_gap`` of an image stacked as the runner writes it (uint8
    [k H, W, 3]: the colour, the blended colour where there is one, then
    anything) against the reference's colour and blended colour."""
    parts = [colour] + ([pixel] if pixel is not None else [])
    want = np.concatenate([levels(p) for p in parts]).astype(np.int16)
    if stacked.ndim != 3 or stacked.shape[0] < want.shape[0] or stacked.shape[1:] != want.shape[1:]:
        return {"image_gap": float("inf")}
    diff = np.abs(stacked[:want.shape[0]].astype(np.int16) - want)
    return {"image_gap": float(diff.mean()), "image_pixels": int(want.shape[0] * want.shape[1])}


def reference(model, cfg, event, scene_dir: Path,
              device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The reference's render of an event's validation view (its view, the
    configuration's level, the event's calls and state)."""
    _, view = event["image"]
    return model.reference_image(cfg, event["state"], scene_dir, view,
                                 cfg.train.validate_resolution_level, event["renders"], device)


def gaps(model, cfg, event, scene_dir: Path, device) -> Dict[str, float]:
    """``image_gap`` of an event's validation image, inf where the runner
    wrote none or rendered nothing."""
    if not event.get("image") or not event.get("renders"):
        return {"image_gap": float("inf")}
    colour, pixel = reference(model, cfg, event, scene_dir, device)
    return gap(read_png(str(event["image"][0])), colour, pixel)
