"""NeuralUDF (Long et al., CVPR 2023; github.com/xxlong0/NeuralUDF) as the
benchmark runs it: an unsigned distance MLP (K1 and K2 in the port), the
two-stage colour net, the NeRF++ background, the beta/gamma/zeta scalars
and the UDF up-sampling; its plain reference is ``benchmark/reference/``.
The interface is ``models/__init__.py``'s.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from reference import config as ref_config
from reference.dataset import load_scene as _load_scene
from reference.dataset import near_far_from_sphere, pixels_to_rays, ref_src_info
from reference.embedder import embed_dim
from reference.fields import _residual_dims, distance_dims, distance_value as _distance_value
from reference.mlp import rounded
from reference.optim import init_adam_state as init_adam
from reference.projector import camera_inverse
from reference.renderer import RenderOptions, UDFRenderer
from reference.schedules import compute_step_schedules, schedule_rows as _schedule_rows
from reference.step import build_step_body

from harness import counts, weights

NAME = "neuraludf"
DISTANCE_NET = "udf"  # the parameters' subtree of the distance MLP: its layers are what K2 writes
TERMS = {"eikonal_gap": "gradient_error", "udf_gap": "udf_mean", "color_gap": "color_loss"}

# ----------------------------------------------------------------------------
# the plain reference
# ----------------------------------------------------------------------------


def load_config(path, **overrides):
    return ref_config.load(str(path), **overrides)


def step_body(cfg, blending: bool):
    return build_step_body(cfg, UDFRenderer(cfg.model), blending=blending)


def distance_value(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """The distance network's value u [n] at points x [n, 3] of the object's
    frame, from its parameters (the ``DISTANCE_NET`` subtree)."""
    return _distance_value(params, x, cfg.model.udf_network)[:, 0]


def load_scene(scene_dir, views, device, sources: int = 0):
    return _load_scene(str(scene_dir), views, device, sources=sources)


def schedule_rows(cfg, start_iter: int, n: int, *, finetune: bool, reg_weights_schedule: bool,
                  flags: Dict[str, bool]):
    """The reference's schedule rows of iterations start_iter .. start_iter + n - 1."""
    c = cfg.color_loss
    return _schedule_rows([compute_step_schedules(
        start_iter + j, cfg.train, c.color_base_weight, c.color_weight, c.color_pixel_weight,
        c.color_patch_weight, is_finetune=finetune, reg_weights_schedule=reg_weights_schedule,
        same_lr=cfg.train.same_lr, **flags) for j in range(n)])


# ----------------------------------------------------------------------------
# the validation render (the runner's periodic ``validate``)
# ----------------------------------------------------------------------------


@contextlib.contextmanager
def render_draws(runner, gen: torch.Generator):
    """Inside, every call of the runner's renderer takes its random draws
    from ``gen``, the benchmark's, in the shapes the renderer draws them
    itself (the z perturbation t_rand [B, 1], the outside jitter t_r
    [n_outside]); yields the list of the calls, each {"rays": B, "noise",
    "cos_anneal_ratio", "flip_saturation", "perturb", "pixel_blending",
    "white"}, which ``reference_image`` renders again."""
    renderer, calls = runner.renderer, []
    original = renderer.render
    n_outside = runner.cfg.model.udf_renderer.n_outside

    def render(params, rays_o, rays_d, near, far, **kw):
        b, dev = rays_o.shape[0], rays_o.device
        noise = {"t_rand": torch.rand((b, 1), generator=gen, device=gen.device).to(dev) - 0.5}
        if n_outside > 0:
            noise["t_r"] = torch.rand((n_outside,), generator=gen, device=gen.device).to(dev)
        opts = kw["opts"]
        calls.append({"rays": b, "noise": noise, "cos_anneal_ratio": float(kw["cos_anneal_ratio"]),
                      "flip_saturation": float(kw["flip_saturation"]), "perturb": opts.perturb,
                      "pixel_blending": opts.pixel_blending,
                      "white": kw.get("background_rgb") is not None})
        return original(params, rays_o, rays_d, near, far, noise=noise, **kw)

    renderer.render = render
    try:
        yield calls
    finally:
        del renderer.render  # the class's method again


def reference_image(cfg, params, scene_dir, view: int, level: int, calls, device
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The validation image of ``view`` at resolution ``level`` as the plain
    reference renders it from ``params`` (the whole tree): the colour and,
    where the calls blended, the pixel-blended colour, each [H', W', 3],
    from the rays through the level's pixel grid, in the chunks and with
    the draws of ``calls`` (``render_draws``; a last chunk padded with zero
    origins and unit directions, as the runner pads it)."""
    scene_t = _load_scene(str(scene_dir), [view], device, sources=8)
    _, h, w, _ = scene_t["images"].shape
    px, py = torch.meshgrid(torch.linspace(0, w - 1, w // level, device=device),
                            torch.linspace(0, h - 1, h // level, device=device), indexing="xy")
    rays_o, rays_d = pixels_to_rays(px, py, scene_t["intrinsics_inv"][view],
                                    scene_t["poses"][view])
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    n, renderer = rays_o.shape[0], UDFRenderer(cfg.model)
    ref_c2w, src_c2ws, src_intr, src_images = ref_src_info(scene_t, view)
    blending = {"color_maps": src_images, "w2cs": camera_inverse(src_c2ws),
                "intrinsics": src_intr, "query_c2w": ref_c2w, "rays_uv": None,
                "img_index": None}
    colour, pixel, at = [], [], 0
    for call in calls:
        if at >= n:
            break
        b = call["rays"]
        ro, rd = rays_o[at:at + b], rays_d[at:at + b]
        real = ro.shape[0]
        ro = torch.cat([ro, torch.zeros((b - real, 3), device=device)])
        rd = torch.cat([rd, torch.ones((b - real, 3), device=device)])
        near, far = near_far_from_sphere(ro, rd)
        noise = {k: v.to(device) for k, v in call["noise"].items()}
        with torch.no_grad():
            ret = renderer.render(
                params, ro, rd, near, far, noise=noise,
                cos_anneal_ratio=call["cos_anneal_ratio"],
                flip_saturation=call["flip_saturation"],
                background_rgb=torch.ones((1, 3), device=device) if call["white"] else None,
                blending=blending if call["pixel_blending"] else None,
                opts=RenderOptions(perturb=call["perturb"],
                                   pixel_blending=call["pixel_blending"]))
        colour.append(ret["color"][:real])
        if call["pixel_blending"]:
            pixel.append(ret["color_pixel"][:real])
        at += b
    if at < n:
        raise ValueError(f"the calls cover {at} of the image's {n} rays")
    shape = px.shape + (3,)
    return (torch.cat(colour).reshape(shape),
            torch.cat(pixel).reshape(shape) if pixel else None)


# ----------------------------------------------------------------------------
# the inputs made from the seed
# ----------------------------------------------------------------------------


def layers(cfg) -> List[Tuple[tuple, str, int, int, dict]]:
    """(path, kind, d_in, d_out, extra) of every linear layer, in a fixed
    order (``harness.weights.init_layers``): the distance MLP (geometric
    init), the colour net's main and base stages and the NeRF++ layers
    (PyTorch's default)."""
    out = []
    u = cfg.model.udf_network
    dims, d0 = distance_dims(u)
    n = len(dims)
    for l in range(n - 1):
        d_out = dims[l + 1] - dims[0] if (l + 1) in u.skip_in else dims[l + 1]
        kind = "geometric" if u.geometric_init else "default"
        out.append((("udf", f"lin{l}"), kind, dims[l], d_out,
                    {"layer": l, "num_layers": n, "d0": d0, "wn": u.weight_norm,
                     "bias": u.bias, "multires": u.multires, "skip_in": u.skip_in,
                     "inside_outside": u.udf_type == "sdf" and u.inside_outside}))
    r = cfg.model.rendering_network
    dims_base, dims_main = _residual_dims(r)
    for key, ds in (("main", dims_main), ("base", dims_base)):
        for l in range(len(ds) - 1):
            out.append((("color", key, f"lin{l}"), "default", ds[l], ds[l + 1],
                        {"wn": r.weight_norm}))
    nf = cfg.model.nerf
    input_ch = embed_dim(nf.multires, nf.d_in) if nf.multires > 0 else 3
    input_ch_view = embed_dim(nf.multires_view, nf.d_in_view) if nf.multires_view > 0 else 3
    for i in range(nf.D):
        d_in = input_ch if i == 0 else (nf.W + input_ch if (i - 1) in nf.skips else nf.W)
        out.append((("nerf", "pts", f"lin{i}"), "default", d_in, nf.W, {}))
    out.append((("nerf", "views", "lin0"), "default", input_ch_view + nf.W, nf.W // 2, {}))
    out.append((("nerf", "feature"), "default", nf.W, nf.W, {}))
    out.append((("nerf", "alpha"), "default", nf.W, 1, {}))
    out.append((("nerf", "rgb"), "default", nf.W // 2, 3, {}))
    return out


def init_weights(cfg, seed: int, device) -> Dict[str, Any]:
    """Every parameter of the step, as plain tensors on ``device``: the
    layers of ``layers`` and the configured scalars."""
    params = weights.init_layers(layers(cfg), seed, device)
    params["variance"] = {"variance": weights.scalar(cfg.model.variance_network.init_val, device)}
    bc = cfg.model.beta_network
    params["beta"] = {"beta": weights.scalar(bc.init_var_beta, device),
                      "gamma": weights.scalar(bc.init_var_gamma, device),
                      "zeta": weights.scalar(bc.init_var_zeta, device)}
    return params


def initial_trainability(cfg) -> Dict[str, bool]:
    """Beta's and the variance's trainability at a run's start, as the
    configuration sets them."""
    return {"beta_trainable": bool(cfg.model.beta_network.requires_grad_beta),
            "variance_trainable": bool(cfg.model.variance_network.requires_grad
                                       and not cfg.train.freeze_variance)}


def make_draws(cfg, n_views_hw, k: int, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """k iterations' draws, in the shapes and types the port's window draws
    them: pixels px, py [B] int64, the z jitter t_rand [B, 1] and the
    outside jitter t_r [n_outside]."""
    _, h, w = n_views_hw
    b, r = cfg.train.batch_size, cfg.model.udf_renderer
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    px = torch.randint(0, w, (k, b), generator=gen, device=device)
    py = torch.randint(0, h, (k, b), generator=gen, device=device)
    out = [{"px": px[j], "py": py[j]} for j in range(k)]
    if r.perturb > 0:
        t_rand = torch.rand((k, b, 1), generator=gen, device=device) - 0.5
        t_r = (torch.rand((k, r.n_outside), generator=gen, device=device)
               if r.n_outside > 0 else None)
        for j in range(k):
            out[j]["t_rand"] = t_rand[j]
            if t_r is not None:
                out[j]["t_r"] = t_r[j]
    return out


# ----------------------------------------------------------------------------
# the counts the readers read (``harness.counts``'s conventions)
# ----------------------------------------------------------------------------


def distance_cfg(cfg):
    """The distance MLP's configuration: K1's and K2's."""
    return cfg.model.udf_network


def samples_per_ray(r) -> Dict[str, int]:
    """Samples a ray, from ``model.udf_renderer`` {n_samples, n_importance,
    up_sample_steps, upsampling_type, n_outside}: ``fg``, the foreground
    samples the distance op sees; ``valued``, the no-grad value
    evaluations of the up-sampling (the uniform samples, then each round's
    new ones but the last round's); ``nerf``, the background NeRF's samples
    (all foreground ones and the outside ones), 0 without a background."""
    if r.n_importance <= 0:
        fg, valued = r.n_samples, 0
    elif r.upsampling_type == "classical":
        per = r.n_importance // r.up_sample_steps
        fg = r.n_samples + per * r.up_sample_steps
        valued = r.n_samples + per * (r.up_sample_steps - 1)
    elif r.upsampling_type == "mix":
        per = r.n_importance // (r.up_sample_steps + 1)
        fg = r.n_samples + per * (r.up_sample_steps + 1)
        valued = r.n_samples + per * r.up_sample_steps
    else:
        raise ValueError(r.upsampling_type)
    return {"fg": fg, "valued": valued, "nerf": fg + r.n_outside if r.n_outside > 0 else 0}


def color_widths(rc) -> List[Tuple[int, int]]:
    """(d_in, d_out) of the two-stage colour net, from
    ``model.rendering_network`` {d_in, d_feature, d_hidden, n_layers,
    d_out, blending_cand_views, multires_view, mode}: the base stage reads
    the point and the feature, the main stage the view direction's
    embedding, the base colour and the base's last hidden layer, and adds
    the blending logits to its output."""
    base = [rc.d_in - 3 + rc.d_feature] + [rc.d_hidden] * rc.n_layers + [rc.d_out]
    main = [rc.d_hidden + rc.d_out + 3] + [rc.d_hidden] * rc.n_layers + [
        rc.d_out + rc.blending_cand_views]
    if rc.multires_view > 0 and rc.mode != "no_view_dir":
        main[0] += counts.pe_dim(rc.multires_view, 3) - 3
    return ([(base[i], base[i + 1]) for i in range(len(base) - 1)]
            + [(main[i], main[i + 1]) for i in range(len(main) - 1)])


def step_flops(cfg) -> Dict[str, float]:
    """Model operations of one training step, by part, and their ``total``:

    * ``upsampling``: the no-grad value passes of the up-sampling, the udf
      column only (``one_col``), batch x ``valued`` points;
    * ``K1``, ``K2``: the fused distance op and its backward at batch x
      ``fg`` rows (``counts.fd_macs``);
    * ``nerf``: the background NeRF forward and backward at batch x
      ``nerf`` points; the backward is the weight cotangents of every
      layer and the input cotangents of every layer but the first (the
      embedding of fixed points needs none): 3x the forward less the first
      layer's input cotangent;
    * ``color``: the colour net forward and backward at batch x ``fg``
      points, 3x the forward (its inputs carry the distance field's
      feature, so every input cotangent is needed).

    Reads ``train.batch_size`` and the keys of the functions above."""
    batch = cfg.train.batch_size
    u, r = cfg.model.udf_network, cfg.model.udf_renderer
    s = samples_per_ray(r)
    fg_rows = batch * s["fg"]
    fd = counts.fd_macs(u)
    out = {
        "upsampling": 2.0 * batch * s["valued"] * counts.udf_passes(u)["one_col"],
        "K1": 2.0 * fg_rows * fd["K1"],
        "K2": 2.0 * fg_rows * fd["K2"],
        "nerf": 0.0,
        "color": 2.0 * fg_rows * 3 * sum(k * m for k, m in color_widths(
            cfg.model.rendering_network)),
    }
    if s["nerf"]:
        widths = counts.nerf_widths(cfg.model.nerf)
        fwd = sum(k * m for k, m in widths)
        first_in = widths[0][0] * widths[0][1]
        out["nerf"] = 2.0 * batch * s["nerf"] * (3 * fwd - first_in)
    out["total"] = sum(out.values())
    return out


def fd_rows(cfg) -> int:
    """Rows the distance op sees a step: batch x foreground samples."""
    return cfg.train.batch_size * samples_per_ray(cfg.model.udf_renderer)["fg"]


# ----------------------------------------------------------------------------
# the faults' sites and the witness
# ----------------------------------------------------------------------------

# what ``harness.faults`` replaces: (the port's module, the attribute's path in it)
FAULT_SITES = {
    "rays": ("neuraludf_tpu_torch.train.step", "sample_random_rays"),
    "adam": [("neuraludf_tpu_torch.train.step", "adam_step"),
             ("neuraludf_tpu_torch.train.step", "flat_adam_step")],
    "distance": ("neuraludf_tpu_torch.nets.fields", "distance_value_and_gradient"),
    "scan_unit": ("neuraludf_tpu_torch.parallel.multi_scan", "MultiScanWindow._unit"),
    "classic_mesh": ("neuraludf_tpu_torch.mesh.mc", "marching_cubes_classic"),
    "udf_mesh": ("neuraludf_tpu_torch.train.runner", "get_mesh_udf"),
    "image_rows": ("neuraludf_tpu_torch.train.runner", "Runner.image_rows"),
}

# the witness's configuration: the fused distance op's tier at f32
F32_OVERRIDES = {"model__udf_network__fused_precision": "highest"}


def port_in_f32() -> None:
    """The witness: the port with every product in f32 (its networks'
    precision policy at ``highest``; the fused op's tier is set by
    ``F32_OVERRIDES`` through the configuration)."""
    from neuraludf_tpu_torch.nets import mlp

    for role in mlp.PRECISION_POLICY:
        mlp.PRECISION_POLICY[role] = "highest"
