"""Neural fields as parameter dictionaries and plain functions on tensors
(counterpart of ``neuraludf_tpu/nets/fields.py``).

* distance field (UDF / SDF heads), with its spatial gradient by
  ``autograd.grad(create_graph=True)`` so the eikonal loss can
  differentiate through it, or by the fused kernels of ops/fused_distance;
* the two-stage residual colour net, the NeRF++ background model and the
  variance / beta / gamma / zeta scalars.

Parameter dictionaries mirror the JAX pytrees key for key (``convert.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..config import (
    BetaNetworkConfig,
    NeRFConfig,
    RenderingNetworkConfig,
    UDFNetworkConfig,
    VarianceConfig,
)
from ..numerics import clip
from .embedder import embed_dim, positional_encoding
from .mlp import geometric_linear, linear, softplus100, to_weight_norm, torch_default_linear

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Distance field (UDF / SDF)
# ---------------------------------------------------------------------------

def distance_dims(cfg: UDFNetworkConfig) -> Tuple[list, int]:
    d0 = embed_dim(cfg.multires, cfg.d_in) if cfg.multires > 0 else cfg.d_in
    return [d0] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out], d0


def init_distance_field(gen: torch.Generator, cfg: UDFNetworkConfig) -> Params:
    dims, d0 = distance_dims(cfg)
    num_layers = len(dims)
    params: Params = {}
    for l in range(num_layers - 1):
        out_dim = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]
        if cfg.geometric_init:
            p = geometric_linear(
                gen, dims[l], out_dim, l, num_layers, d0, cfg.skip_in, cfg.multires, cfg.bias,
                inside_outside=(cfg.udf_type == "sdf" and cfg.inside_outside),
            )
        else:
            p = torch_default_linear(gen, dims[l], out_dim)
        if cfg.weight_norm:
            p = to_weight_norm(p)
        params[f"lin{l}"] = p
    return params


def distance_head(raw: torch.Tensor, cfg: UDFNetworkConfig) -> torch.Tensor:
    if cfg.udf_type == "abs":
        raw = torch.abs(raw)
    elif cfg.udf_type == "square":
        raw = raw ** 2
    return raw / cfg.scale


def distance_field_apply(
    params: Params, x: torch.Tensor, cfg: UDFNetworkConfig, *, role: str = "distance"
) -> torch.Tensor:
    """x: [N, 3] -> [N, d_out] = [distance(1), feature(d_out-1)].

    role "distance" is the differentiated path (true f32); "sampling" is the
    no-grad up-sampling evaluation, which may run reduced precision."""
    inputs = x * cfg.scale
    if cfg.multires > 0:
        inputs = positional_encoding(inputs, cfg.multires)
    n_lin = cfg.n_layers + 1
    h = inputs
    for l in range(n_lin):
        if l in cfg.skip_in:
            h = torch.cat([h, inputs], dim=-1) / (2.0 ** 0.5)
        h = linear(params[f"lin{l}"], h, role)
        if l < n_lin - 1:
            h = softplus100(h)
    return torch.cat([distance_head(h[:, :1], cfg), h[:, 1:]], dim=-1)


def distance_value(
    params: Params, x: torch.Tensor, cfg: UDFNetworkConfig, *, role: str = "distance"
) -> torch.Tensor:
    return distance_field_apply(params, x, cfg, role=role)[:, :1]


def _grad_input(x: torch.Tensor) -> torch.Tensor:
    # differentiate w.r.t. x itself when it is part of a graph, so the
    # gradient stays a function of x for a caller's VJP
    return x if x.requires_grad else x.detach().requires_grad_(True)


def distance_gradient(params: Params, x: torch.Tensor, cfg: UDFNetworkConfig) -> torch.Tensor:
    """Spatial gradient d(udf)/dx: [N, 3], differentiable again (the
    eikonal term's second order). udf is pointwise, so the gradient of the
    batch sum is the per-point gradient."""
    with torch.enable_grad():
        xg = _grad_input(x)
        u = distance_value(params, xg, cfg)
        (g,) = torch.autograd.grad(u.sum(), xg, create_graph=True)
    return g


def distance_value_and_gradient_plain(
    params: Params, x: torch.Tensor, cfg: UDFNetworkConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(value, feature, gradient) by autograd: the plain path. The gradient
    is differentiable again when grad mode is on; under ``no_grad`` (the
    validation renders) no graph outlives the call."""
    differentiable = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = _grad_input(x)
        out = distance_field_apply(params, xg, cfg)
        (g,) = torch.autograd.grad(out[:, :1].sum(), xg, create_graph=differentiable)
    if not differentiable:
        out = out.detach()
    return out[:, :1], out[:, 1:], g


def distance_value_and_gradient(
    params: Params, x: torch.Tensor, cfg: UDFNetworkConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(value [N,1], feature [N,F], spatial gradient [N,3]) — the
    render-core hot call. cfg.fused_core picks the fused kernels
    (ops/fused_distance) or the plain autograd path."""
    from ..ops import fused_distance as fd

    if fd.fused_enabled(cfg, x.device):
        return fd.distance_value_feat_grad_fused(params, x, cfg)
    return distance_value_and_gradient_plain(params, x, cfg)


# ---------------------------------------------------------------------------
# Residual rendering network (two-stage colour + blending logits)
# ---------------------------------------------------------------------------

def _residual_dims(cfg: RenderingNetworkConfig) -> Tuple[list, list]:
    dims_base = [cfg.d_in - 3 + cfg.d_feature] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out]
    dims = [cfg.d_hidden + cfg.d_out + 3] + [cfg.d_hidden] * cfg.n_layers + [
        cfg.d_out + cfg.blending_cand_views
    ]
    if cfg.multires_view > 0 and cfg.mode != "no_view_dir":
        dims[0] += embed_dim(cfg.multires_view, 3) - 3
    return dims_base, dims


def init_residual_color(gen: torch.Generator, cfg: RenderingNetworkConfig) -> Params:
    dims_base, dims = _residual_dims(cfg)
    n = len(dims)
    params: Params = {"base": {}, "main": {}}
    for key, ds in (("main", dims), ("base", dims_base)):
        for l in range(n - 1):
            p = torch_default_linear(gen, ds[l], ds[l + 1])
            params[key][f"lin{l}"] = to_weight_norm(p) if cfg.weight_norm else p
    return params


def residual_color_apply(
    params: Params,
    points: torch.Tensor,
    normals: torch.Tensor,
    view_dirs: torch.Tensor,
    feature_vectors: torch.Tensor,
    cfg: RenderingNetworkConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (color_base [N,3], color [N,3], blending_logits [N,V])."""
    if cfg.multires_view > 0 and cfg.mode != "no_view_dir":
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)
    if cfg.mode == "no_normal":
        base_in = torch.cat([points, feature_vectors], dim=-1)
    else:
        normals = normals.detach()
        base_in = torch.cat([points, normals, -normals, feature_vectors], dim=-1)

    n = cfg.n_layers + 2
    h = base_in
    x_hidden = None
    for l in range(n - 1):
        h = linear(params["base"][f"lin{l}"], h, "color")
        if l < n - 2:
            h = torch.relu(h)
        if l == n - 3:
            x_hidden = h
    color_base = torch.sigmoid(h[:, : cfg.d_out])

    h = torch.cat([view_dirs, color_base, x_hidden], dim=-1)
    for l in range(n - 1):
        h = linear(params["main"][f"lin{l}"], h, "color")
        if l < n - 2:
            h = torch.relu(h)
    return color_base, torch.sigmoid(h[:, : cfg.d_out]), h[:, cfg.d_out:]


# ---------------------------------------------------------------------------
# Background NeRF (inverse-sphere NeRF++ model)
# ---------------------------------------------------------------------------

def init_background_nerf(gen: torch.Generator, cfg: NeRFConfig) -> Params:
    input_ch = embed_dim(cfg.multires, cfg.d_in) if cfg.multires > 0 else 3
    input_ch_view = embed_dim(cfg.multires_view, cfg.d_in_view) if cfg.multires_view > 0 else 3
    params: Params = {"pts": {}, "views": {}}
    for i in range(cfg.D):
        d_in = input_ch if i == 0 else (cfg.W + input_ch if (i - 1) in cfg.skips else cfg.W)
        params["pts"][f"lin{i}"] = torch_default_linear(gen, d_in, cfg.W)
    params["views"]["lin0"] = torch_default_linear(gen, input_ch_view + cfg.W, cfg.W // 2)
    params["feature"] = torch_default_linear(gen, cfg.W, cfg.W)
    params["alpha"] = torch_default_linear(gen, cfg.W, 1)
    params["rgb"] = torch_default_linear(gen, cfg.W // 2, 3)
    return params


def background_nerf_apply(
    params: Params, pts: torch.Tensor, views: Optional[torch.Tensor], cfg: NeRFConfig
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """pts: [N, d_in] (x/r, 1/r), views: [N, 3] -> (raw density [N,1], rgb [N,3])."""
    h_in = positional_encoding(pts, cfg.multires) if cfg.multires > 0 else pts
    h = h_in
    for i in range(cfg.D):
        h = torch.relu(linear(params["pts"][f"lin{i}"], h, "nerf"))
        if i in cfg.skips:
            h = torch.cat([h_in, h], dim=-1)
    alpha = linear(params["alpha"], h, "nerf")
    if views is None:
        return alpha, None
    v_in = positional_encoding(views, cfg.multires_view) if cfg.multires_view > 0 else views
    h = torch.cat([linear(params["feature"], h, "nerf"), v_in], dim=-1)
    h = torch.relu(linear(params["views"]["lin0"], h, "nerf"))
    return alpha, linear(params["rgb"], h, "nerf")


# ---------------------------------------------------------------------------
# Scalar nets
# ---------------------------------------------------------------------------

def init_variance(cfg: VarianceConfig) -> Params:
    return {"variance": torch.tensor([cfg.init_val], dtype=torch.float32)}


def variance_inv_s(params: Params) -> torch.Tensor:
    """exp(10 * variance), the inv_s sharpness scalar."""
    return torch.exp(params["variance"] * 10.0)


def init_beta(cfg: BetaNetworkConfig) -> Params:
    mk = lambda v: torch.tensor([v], dtype=torch.float32)
    return {"beta": mk(cfg.init_var_beta), "gamma": mk(cfg.init_var_gamma),
            "zeta": mk(cfg.init_var_zeta)}


def beta_value(params: Params, beta_min: float = 0.00005) -> torch.Tensor:
    return clip(torch.exp(params["beta"] * 10.0), 0.0, 1.0 / beta_min)


def gamma_value(params: Params) -> torch.Tensor:
    return torch.exp(params["gamma"] * 10.0)


def zeta_value(params: Params) -> torch.Tensor:
    return torch.abs(params["zeta"])


# ---------------------------------------------------------------------------
# Per-view colour blending
# ---------------------------------------------------------------------------

def color_blend(
    blending_logits: torch.Tensor,
    img_index: Optional[torch.Tensor] = None,
    pts_pixel_color: Optional[torch.Tensor] = None,
    pts_pixel_mask: Optional[torch.Tensor] = None,
    pts_patch_color: Optional[torch.Tensor] = None,
    pts_patch_mask: Optional[torch.Tensor] = None,
):
    """Fuse the per-view warped colours with the learned blending weights.

    blending_logits [B, S, n_cand]; pixel colour/mask [B, S, V, 3]/[B, S, V];
    patch colour/mask [B, S, V, 3, Npx]/[B, S, V, Npx] (channel-packed, patch
    axis last). ``img_index`` [V] picks each view's logit; without it the
    first V are taken. Returns (pixel colour [B, S, 3], pixel mask [B, S, 1],
    patch colour [B, S, 3, Npx], patch mask [B, S, 1]); a pair is None where
    its input is."""
    nviews = (pts_pixel_color.shape[-2] if pts_pixel_color is not None
              else pts_patch_color.shape[-3])
    if img_index is not None:
        logits = torch.index_select(blending_logits, -1, img_index.long())
    else:
        logits = blending_logits[..., :nviews]
    soft = torch.softmax(logits, dim=-1)

    final_pixel_color = final_pixel_mask = None
    if pts_pixel_color is not None:
        w_pix = soft * pts_pixel_mask
        w_pix = w_pix / (torch.sum(w_pix, dim=-1, keepdim=True) + 1e-8)
        final_pixel_color = torch.sum(pts_pixel_color * w_pix[..., None], dim=-2)
        final_pixel_mask = torch.sum(pts_pixel_mask, dim=-1, keepdim=True) > 0

    final_patch_color = final_patch_mask = None
    if pts_patch_color is not None:
        npx = pts_patch_color.shape[-1]
        patch_mask = torch.sum(pts_patch_mask, dim=-1) > (npx - 1)  # [B, S, V]
        w_patch = soft * patch_mask
        w_patch = w_patch / (torch.sum(w_patch, dim=-1, keepdim=True) + 1e-8)
        final_patch_color = torch.einsum("bsvcp,bsv->bscp", pts_patch_color, w_patch)
        final_patch_mask = torch.sum(patch_mask, dim=-1, keepdim=True) > 0  # [B, S, 1]

    return final_pixel_color, final_pixel_mask, final_patch_color, final_patch_mask
