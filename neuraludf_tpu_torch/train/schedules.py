"""Host-side training schedules (pure functions of iter_step).

Computed on the host for each step and handed to the step body as one f32
row of ``SCHEDULE_KEYS`` (``schedule_rows`` stacks a window's rows), so
that a captured step graph reads every schedule value from device memory
and none is baked in at capture.
(ref: exp_runner_blending.py:167-251)
"""

from __future__ import annotations

from dataclasses import astuple, dataclass, fields
from typing import Dict, Sequence

import numpy as np
import torch

from ..config import TrainConfig


def lr_factor(step: int, cfg: TrainConfig) -> float:
    """Cosine with warmup (ref: exp_runner_blending.py:167-176)."""
    if step < cfg.warm_up_end:
        return step / cfg.warm_up_end
    alpha = cfg.learning_rate_alpha
    progress = (step - cfg.warm_up_end) / (cfg.end_iter - cfg.warm_up_end)
    return float((np.cos(np.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha)


def lr_factor_geo(step: int, cfg: TrainConfig) -> float:
    """Geometry LR: frozen, then 2x-warmup, flat, cosine from 50%
    (ref: exp_runner_blending.py:178-191)."""
    if step < cfg.fix_geo_end:  # let the background NeRF learn first
        return 0.0
    if step < cfg.warm_up_end * 2:
        return step / (cfg.warm_up_end * 2)
    if step < cfg.end_iter * 0.5:
        return 1.0
    alpha = cfg.learning_rate_alpha
    progress = (step - cfg.end_iter * 0.5) / (cfg.end_iter - cfg.end_iter * 0.5)
    return float((np.cos(np.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha)


def cos_anneal_ratio(step: int, cfg: TrainConfig) -> float:
    if cfg.anneal_end == 0.0:
        return 1.0
    return float(min(1.0, step / cfg.anneal_end))


def flip_saturation(step: int, cfg: TrainConfig, *, is_finetune: bool, maximum: float = 0.9) -> float:
    """(ref: exp_runner_blending.py:216-228)"""
    if is_finetune:
        return 1.0
    if step < 10000:
        return 0.0
    if step < cfg.end_iter * 0.5:
        return maximum
    return 1.0


def color_weight_factor(step: int, *, is_finetune: bool) -> float:
    """Pixel/patch color ramp 10k → 20k (ref: exp_runner_blending.py:230-239)."""
    if is_finetune:
        return 1.0
    if step < 10000:
        return 0.0
    if step < 20000:
        return float(np.clip((step - 10000) / 10000, 0, 1))
    return 1.0


def regularization_weights(step: int, cfg: TrainConfig) -> tuple:
    """(igr_ns_weight, sparse_weight) schedule
    (ref: exp_runner_blending.py:199-211)."""
    end1 = cfg.end_iter // 5
    end2 = cfg.end_iter // 2
    igr_ns = 0.0
    sparse = 0.0
    if step >= end1:
        igr_ns = cfg.igr_ns_weight * float(np.clip((step - end1) / end1, 0.0, 1.0))
    if step >= end2:
        sparse = cfg.sparse_weight
    return igr_ns, sparse


@dataclass
class StepSchedules:
    """Everything the step body reads from its schedule row."""
    lr_main: float
    lr_geo: float
    cos_anneal_ratio: float
    flip_saturation: float
    color_base_weight: float
    color_weight: float
    color_pixel_weight: float
    color_patch_weight: float
    igr_weight: float
    igr_ns_weight: float
    sparse_weight: float
    mask_weight: float
    beta_trainable: float
    variance_trainable: float


def compute_step_schedules(
    step: int,
    cfg: TrainConfig,
    color_base_weight: float,
    color_weight: float,
    color_pixel_weight: float,
    color_patch_weight: float,
    *,
    is_finetune: bool,
    reg_weights_schedule: bool,
    same_lr: bool,
    beta_trainable: bool,
    variance_trainable: bool,
) -> StepSchedules:
    f = lr_factor(step, cfg)
    lr_main = cfg.learning_rate * f
    lr_geo = cfg.learning_rate * f if same_lr else cfg.learning_rate_geo * lr_factor_geo(step, cfg)

    cf = color_weight_factor(step, is_finetune=is_finetune)
    # base weight only ramps when it is smaller than the main color weight
    # (ref: exp_runner_blending.py:241-244)
    cbw = color_base_weight * cf if color_base_weight < color_weight else color_base_weight

    if reg_weights_schedule:
        igr_ns, sparse = regularization_weights(step, cfg)
    else:
        igr_ns, sparse = cfg.igr_ns_weight, cfg.sparse_weight

    return StepSchedules(
        lr_main=lr_main,
        lr_geo=lr_geo,
        cos_anneal_ratio=cos_anneal_ratio(step, cfg),
        flip_saturation=flip_saturation(step, cfg, is_finetune=is_finetune),
        color_base_weight=cbw,
        color_weight=color_weight,
        color_pixel_weight=color_pixel_weight * cf,
        color_patch_weight=color_patch_weight * cf,
        igr_weight=cfg.igr_weight,
        igr_ns_weight=igr_ns,
        sparse_weight=sparse,
        mask_weight=cfg.mask_weight,
        beta_trainable=1.0 if beta_trainable else 0.0,
        variance_trainable=1.0 if variance_trainable else 0.0,
    )


SCHEDULE_KEYS = [f.name for f in fields(StepSchedules)]


def schedule_rows(scheds: Sequence[StepSchedules]) -> np.ndarray:
    """[k, len(SCHEDULE_KEYS)] f32: one row a step, the counterpart of the
    stacked schedule arrays of the JAX window."""
    return np.asarray([astuple(s) for s in scheds], np.float32).reshape(
        len(scheds), len(SCHEDULE_KEYS))


def unpack_row(row: torch.Tensor) -> Dict[str, torch.Tensor]:
    """name -> 0-dim view of ``row`` [len(SCHEDULE_KEYS)]: the values stay in
    device memory, so a graph captured over them reads each replay's row."""
    return {name: row[i] for i, name in enumerate(SCHEDULE_KEYS)}


def is_blending(s: StepSchedules) -> bool:
    """Whether a step with these schedules runs the blending branches."""
    return s.color_pixel_weight > 0 or s.color_patch_weight > 0
