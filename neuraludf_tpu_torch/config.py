"""Typed configuration tree.

Mirrors the reference HOCON schema (ref: confs/udf_dtu_blending.conf:1-119,
confs/udf_garment_blending.conf) so the original .conf files load directly,
while giving the rest of the framework a typed, static view. A copy of
``neuraludf_tpu/config.py`` so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import hocon


@dataclass(frozen=True)
class GeneralConfig:
    base_exp_dir: str = "./exp"
    expname: str = "udf"
    model_type: str = "udf"  # 'udf' | 'neus'
    recording: Tuple[str, ...] = ()


@dataclass(frozen=True)
class DatasetConfig:
    data_dir: str = ""
    render_cameras_name: str = "cameras.npz"
    object_cameras_name: str = "cameras.npz"
    dataset_name: str = "dtu"  # 'dtu' | 'deepfashion3d' | 'bmvs'
    downsample_factor: float = 1.0
    camera_outside_sphere: bool = True
    scale_mat_scale: float = 1.1


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-4
    learning_rate_geo: float = 1e-4
    learning_rate_alpha: float = 0.05
    end_iter: int = 300_000
    batch_size: int = 512
    validate_resolution_level: int = 4
    warm_up_end: float = 5000.0
    anneal_end: float = 25000.0
    use_white_bkgd: bool = False
    warmup_sample: bool = False
    same_lr: bool = False
    fix_geo_end: float = 500.0
    save_freq: int = 10_000
    val_freq: int = 2500
    val_mesh_freq: int = 2500
    report_freq: int = 100
    igr_weight: float = 0.1
    igr_ns_weight: float = 0.0
    mask_weight: float = 0.0
    sparse_weight: float = 0.0
    # blending iterations in graph-replayed windows (else one at a time)
    blend_scan_window: bool = True
    stall_warn_s: float = 600.0  # StallWatchdog warning period; 0 turns it off
    incremental_mesh: bool = False
    freeze_variance: bool = False  # keep variance untrainable all run
    scan_unroll: int = 1  # step bodies a captured window graph holds
    flat_adam: bool = False  # one Adam update over the concatenated parameters

@dataclass(frozen=True)
class ColorLossConfig:
    color_base_weight: float = 0.01
    color_weight: float = 1.0
    color_pixel_weight: float = 0.0
    color_patch_weight: float = 0.0
    pixel_loss_type: str = "l1"
    patch_loss_type: str = "ssim"
    h_patch_size: int = 3


@dataclass(frozen=True)
class NeRFConfig:
    D: int = 8
    W: int = 256
    d_in: int = 4
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    output_ch: int = 4
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True


@dataclass(frozen=True)
class UDFNetworkConfig:
    d_out: int = 257
    d_in: int = 3
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: Tuple[int, ...] = (4,)
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    udf_type: str = "abs"  # 'abs' | 'square' | 'sdf'
    inside_outside: bool = False  # only for the NeuS/SDF variant
    udf_shift: float = 0.0  # accepted for conf parity; unused (like reference)
    predict_grad: bool = False  # accepted for conf parity; unused
    # fused render-core kernels (ops/fused_distance.py, csrc/fused_distance.cu)
    fused_core: str = "auto"  # 'auto' (kernel on CUDA, plain on CPU) | 'on' | 'off'
    # 'default': one bf16 pass a product, and sigma(100 a) and q kept in bf16
    # between the kernels' sweeps; 'high': bf16x3 (the TPU's _dot3), operands
    # split into bf16 hi and lo, cotangents in bf16, every stored value f32;
    # 'highest': f32 throughout
    fused_precision: str = "default"


@dataclass(frozen=True)
class VarianceConfig:
    init_val: float = 0.3
    requires_grad: bool = True


@dataclass(frozen=True)
class RenderingNetworkConfig:
    d_feature: int = 256
    mode: str = "no_normal"  # 'idr' | 'no_view_dir' | 'no_normal'
    d_in: int = 6
    d_out: int = 3
    d_hidden: int = 128
    n_layers: int = 4
    weight_norm: bool = True
    multires_view: int = 4
    squeeze_out: bool = True
    blending_cand_views: int = 10


@dataclass(frozen=True)
class BetaNetworkConfig:
    init_var_beta: float = 0.5
    init_var_gamma: float = 0.3
    init_var_zeta: float = 0.3
    beta_min: float = 0.00005
    requires_grad_beta: bool = True
    requires_grad_gamma: bool = False
    requires_grad_zeta: bool = False


@dataclass(frozen=True)
class RendererConfig:
    n_samples: int = 64
    n_importance: int = 50
    n_outside: int = 32
    up_sample_steps: int = 5
    perturb: float = 1.0
    sdf2alpha_type: str = "numerical"  # 'numerical' | 'theorical'
    upsampling_type: str = "classical"  # 'classical' | 'mix'
    sparse_scale_factor: float = 25000.0
    # 0.0 = reference sparse term; > 0 excludes samples within this distance
    # of the rendered depth on surface rays (see the JAX RendererConfig)
    sparse_depth_gate: float = 0.0
    h_patch_size: int = 3
    use_norm_grad_for_cosine: bool = False
    # blending-finetune switches: 'gather' warps every sample with
    # ops.interp; 'strip' warps the blend_top_k highest-weight samples of a
    # ray through ops.strip_sample (kernel K3 for CUDA tensors, its plain
    # version for CPU tensors); 'auto' = 'strip' for CUDA tensors, 'gather'
    # on the CPU
    warp_sampler: str = "auto"  # 'auto' | 'gather' | 'strip'
    blend_top_k: int = 32
    blend_chunk: int = 8  # k is cut to a multiple of it, as in the JAX package
    strip_height: int = 64  # kept so that the .conf files load; unread (no strips here)
    remat: str = "none"

@dataclass(frozen=True)
class ModelConfig:
    nerf: NeRFConfig = field(default_factory=NeRFConfig)
    udf_network: UDFNetworkConfig = field(default_factory=UDFNetworkConfig)
    variance_network: VarianceConfig = field(default_factory=VarianceConfig)
    rendering_network: RenderingNetworkConfig = field(default_factory=RenderingNetworkConfig)
    beta_network: BetaNetworkConfig = field(default_factory=BetaNetworkConfig)
    udf_renderer: RendererConfig = field(default_factory=RendererConfig)


@dataclass(frozen=True)
class Config:
    general: GeneralConfig = field(default_factory=GeneralConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    color_loss: ColorLossConfig = field(default_factory=ColorLossConfig)
    model: ModelConfig = field(default_factory=ModelConfig)


_FIELD_ALIASES = {
    # HOCON key -> dataclass field (only where they differ)
}


def _build(dc_type, data: Dict[str, Any]):
    kwargs = {}
    names = {f.name: f for f in dataclasses.fields(dc_type)}
    for key, val in data.items():
        key = _FIELD_ALIASES.get(key, key)
        if key not in names:
            continue  # tolerate unknown keys, like pyhocon/get_* defaults
        f = names[key]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            val = _build(f.type, val)
        elif isinstance(val, list):
            val = tuple(val)
        kwargs[key] = val
    return dc_type(**kwargs)


def from_dict(raw: Dict[str, Any]) -> Config:
    model_raw = raw.get("model", {})
    model = ModelConfig(
        nerf=_build(NeRFConfig, model_raw.get("nerf", {})),
        udf_network=_build(UDFNetworkConfig, model_raw.get("udf_network", {})),
        variance_network=_build(VarianceConfig, model_raw.get("variance_network", {})),
        rendering_network=_build(
            RenderingNetworkConfig, model_raw.get("rendering_network", {})
        ),
        beta_network=_build(BetaNetworkConfig, model_raw.get("beta_network", {})),
        udf_renderer=_build(RendererConfig, model_raw.get("udf_renderer", {})),
    )
    return Config(
        general=_build(GeneralConfig, raw.get("general", {})),
        dataset=_build(DatasetConfig, raw.get("dataset", {})),
        train=_build(TrainConfig, raw.get("train", {})),
        color_loss=_build(ColorLossConfig, raw.get("color_loss", {})),
        model=model,
    )


def load(path: str, case: Optional[str] = None, **overrides) -> Config:
    """Load a .conf file (reference HOCON schema) into a typed Config.

    ``overrides`` are dotted paths, e.g. ``load(p, train__learning_rate=1e-4)``
    mirroring the reference CLI overrides (ref: exp_runner_blending.py:48-53).
    """
    cfg = from_dict(hocon.parse_file(path, case=case))
    for dotted, val in overrides.items():
        parts = dotted.split("__")
        cfg = _replace_path(cfg, parts, val)
    return cfg


def _replace_path(obj, parts: List[str], val):
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: val})
    sub = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _replace_path(sub, parts[1:], val)})
