"""Steps shared by the two quality protocols on the PyTorch port,
``scripts/torch_benchmark_lobed.py`` and ``scripts/torch_benchmark_garment.py``:
a training stage and the validation renders kept as evidence."""

from __future__ import annotations

import time
import traceback


def train_stage(runner):
    """Trains ``runner`` to its end_iter and saves a checkpoint: (the
    checkpoint, the training seconds, ended by a device synchronize)."""
    import torch

    t0 = time.time()
    runner.train()
    if runner.device.type == "cuda":
        torch.cuda.synchronize(runner.device)
    seconds = time.time() - t0
    return runner.save_checkpoint(), seconds


def render_evidence(runner, views=(0, 24), vis_ray: bool = False) -> float:
    """Validation renders (colour, normal, depth) of two views at level 2;
    with ``vis_ray``, then the ray statistics of three pixels down the
    centre column of view 0 (the garment launcher's ``--vis_ray``). A
    failure is reported and the protocol goes on. Returns the seconds."""
    t0 = time.time()
    for idx in views:
        try:
            runner.validate(idx=idx, resolution_level=2)
        except Exception:  # renders are evidence only
            print(f"validate failed for view {idx}:\n{traceback.format_exc()}")
    if vis_ray:
        try:
            H, W = runner.dataset.H, runner.dataset.W
            for dy in (-H // 4, 0, H // 4):
                runner.visualize_one_ray(0, W // 2, H // 2 + dy)
        except Exception:
            print(f"vis_ray failed:\n{traceback.format_exc()}")
    return time.time() - t0
