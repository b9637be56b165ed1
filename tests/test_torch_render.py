"""The port's sampling and renderer against ``neuraludf_tpu.render`` on the
CPU: ``sample_pdf`` brackets (edges included), the classical up-sampling,
a full stage-1 ``render`` on a tiny sphere setup with the random draws
taken from JAX's key exactly as ``UDFRenderer.render`` takes them, and the
blended render of the finetune under both warp samplers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.render import alpha as jalpha
from neuraludf_tpu.render import sampling as js
from neuraludf_tpu.render.renderer import RenderOptions as JRenderOptions
from neuraludf_tpu.render.renderer import UDFRenderer as JRenderer
from neuraludf_tpu.train.runner import init_params as jax_init_params
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.render import alpha as talpha
from neuraludf_tpu_torch.render import sampling as ts
from neuraludf_tpu_torch.train import optim as toptim
from neuraludf_tpu_torch.render.renderer import RenderOptions as TRenderOptions
from neuraludf_tpu_torch.render.renderer import UDFRenderer as TRenderer


def dense_mask_brackets(cdf, u):
    """The JAX package's bracket rule, in numpy: inds = #(cdf <= u), below =
    inds-1 (0 when inds == 0), above = inds (n-1 when inds == n)."""
    inds = (cdf[:, None, :] <= u[:, :, None]).sum(-1)
    n = cdf.shape[-1]
    return np.where(inds == 0, 0, inds - 1), np.where(inds == n, n - 1, inds)


def test_sample_pdf_brackets_and_edges():
    rng = np.random.RandomState(0)
    bins = np.sort(rng.uniform(0, 4, (5, 9)).astype(np.float32), -1)
    weights = rng.rand(5, 8).astype(np.float32)
    weights[1] = 0.0  # a flat pdf (only the 1e-5 floor)
    weights[2, 3:] = 0.0  # a plateau at the top of the cdf
    # u below 0 (inds == 0), at the cdf values, inside, at 1 and above (inds == n)
    w = weights + 1e-5
    cdf = np.concatenate([np.zeros((5, 1), np.float32),
                          np.cumsum(w / w.sum(-1, keepdims=True), -1)], -1).astype(np.float32)
    u = np.concatenate([np.full((5, 1), -0.1, np.float32), cdf[:, 2:3], cdf[:, 5:6],
                        rng.rand(5, 4).astype(np.float32), np.ones((5, 1), np.float32),
                        np.full((5, 1), 1.5, np.float32)], -1)
    out = ts.sample_pdf(torch.tensor(bins), torch.tensor(weights), u.shape[1], det=False,
                        u=torch.tensor(u)).numpy()
    below, above = dense_mask_brackets(cdf, u)
    cb, ca = np.take_along_axis(cdf, below, -1), np.take_along_axis(cdf, above, -1)
    bb, ba = np.take_along_axis(bins, below, -1), np.take_along_axis(bins, above, -1)
    denom = np.where(ca - cb < 1e-5, 1.0, ca - cb)
    ref = bb + (u - cb) / denom * (ba - bb)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert (below == 0).any() and (above == cdf.shape[-1] - 1).any()

    # and JAX's own function, deterministic and with its random u
    det_j = js.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 7, det=True)
    det_t = ts.sample_pdf(torch.tensor(bins), torch.tensor(weights), 7, det=True)
    np.testing.assert_allclose(det_t.numpy(), np.asarray(det_j), rtol=1e-5, atol=1e-6)
    key = jax.random.PRNGKey(3)
    rnd_j = js.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 6, det=False, key=key)
    u_j = np.asarray(jax.random.uniform(key, (5, 6)))
    rnd_t = ts.sample_pdf(torch.tensor(bins), torch.tensor(weights), 6, det=False,
                          u=torch.tensor(u_j))
    np.testing.assert_allclose(rnd_t.numpy(), np.asarray(rnd_j), rtol=1e-5, atol=1e-6)


def test_alpha_transforms():
    rng = np.random.RandomState(1)
    sdf, cos = rng.randn(4, 7).astype(np.float32) * 0.1, -np.abs(rng.randn(4, 7)).astype(np.float32)
    dists = np.abs(rng.randn(4, 7)).astype(np.float32) * 0.05
    for kind in ("numerical", "theorical"):
        for ratio in (None, 0.3):
            a = talpha.sdf2alpha(*map(torch.tensor, (sdf, cos, dists)), 40.0, ratio, kind)
            b = jalpha.sdf2alpha(*map(jnp.asarray, (sdf, cos, dists)), 40.0, ratio, kind)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    al = rng.rand(4, 7).astype(np.float32)
    np.testing.assert_allclose(talpha.transmittance_weights(torch.tensor(al)).numpy(),
                               np.asarray(jalpha.transmittance_weights(jnp.asarray(al))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        talpha.visibility_prob(torch.tensor(al), torch.tensor(al * 0.5)).numpy(),
        np.asarray(jalpha.visibility_prob(jnp.asarray(al), jnp.asarray(al * 0.5))), rtol=1e-6)
    np.testing.assert_allclose(talpha.udf2logistic(torch.tensor(sdf), 30.0, 2.0, 0.7, 0.4).numpy(),
                               np.asarray(jalpha.udf2logistic(jnp.asarray(sdf), 30.0, 2.0, 0.7,
                                                              0.4)), rtol=1e-5)


def hit_rays(batch, seed):
    """Rays from a ring at distance 2.2 aimed at points within 0.2 of the
    origin: all of them cross a radius-0.5 sphere."""
    rng = np.random.RandomState(seed)
    ang = rng.uniform(0, 2 * np.pi, batch)
    o = np.stack([2.2 * np.sin(ang), rng.uniform(-0.3, 0.3, batch), -2.2 * np.cos(ang)], -1)
    target = rng.uniform(-0.2, 0.2, (batch, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def sphere_udf(lib):
    norm = (lambda p: jnp.linalg.norm(p, axis=-1)) if lib == "jax" else \
        (lambda p: torch.linalg.vector_norm(p, dim=-1))
    return lambda p: abs(norm(p) - 0.5)


def test_importance_sample_classical():
    ro, rd = hit_rays(12, 2)
    near = (np.full((12, 1), 1.2)).astype(np.float32)
    far = (np.full((12, 1), 3.2)).astype(np.float32)
    z = (near + (far - near) * np.linspace(0, 1, 16, dtype=np.float32)[None]).astype(np.float32)
    zj = jax.jit(lambda *a: js.importance_sample_classical(
        sphere_udf("jax"), *a, 0.125, n_importance=20, up_sample_steps=4))(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z))
    zt = ts.importance_sample_classical(sphere_udf("torch"), torch.tensor(ro), torch.tensor(rd),
                                        torch.tensor(z), 0.125, n_importance=20,
                                        up_sample_steps=4)
    assert zt.shape == (12, 36) and bool((zt[:, 1:] >= zt[:, :-1]).all())
    # the sharpest rounds (s up to 512) move a sample by up to ~1e-4 (see RENDERS)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=2e-4)


RENDER_RAW = {
    "model": {
        "nerf": {"D": 2, "W": 32, "multires": 4, "multires_view": 2, "skips": [0]},
        "udf_network": {"d_out": 17, "d_hidden": 32, "n_layers": 3, "skip_in": [2],
                        "multires": 4},
        "rendering_network": {"d_feature": 16, "d_hidden": 16, "n_layers": 2},
    }
}
# (renderer config, tolerance relative to each output's largest entry).
# Uniform samples: f32 on both sides, the compositing chains a few hundred
# products. Up-sampling: its last rounds sharpen the inverse CDF (s up to
# 1024), so f32 differences in the udf move new samples by up to ~1e-4 and
# the alphas at them by ~1e-3.
RENDERS = {
    "uniform": ({"n_samples": 16, "n_importance": 0, "n_outside": 8}, 2e-5),
    "up_sampling": ({"n_samples": 16, "n_importance": 8, "n_outside": 8, "up_sample_steps": 4},
                    5e-3),
}
# exp(-25000 udf) turns an f32 udf difference of 6e-8 into 1.5e-3; after
# the up-sampling moved a sample by 1e-4, it is compared no more
SPARSE_TOL = 5e-3
KEYS = ["color", "color_base", "weights", "depth", "gradient_error", "sparse_error", "udf",
        "gradients", "normals", "vis_prob", "alpha", "z_vals", "weight_sum", "weight_sum_fg_bg",
        "variance", "beta", "gamma", "blend_strip_cover"]


@pytest.mark.parametrize("mode", sorted(RENDERS))
def test_render_matches_jax(mode):
    renderer_cfg, tol = RENDERS[mode]
    raw = {"model": dict(RENDER_RAW["model"], udf_renderer=renderer_cfg)}
    jcfg, tcfg = jconfig.from_dict(raw), tconfig.from_dict(raw)
    params_j = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params_t = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    batch = 10
    ro, rd = hit_rays(batch, 4)
    if mode == "uniform":  # some rays miss the sphere here
        rd[::3] = (rd[::3] + np.array([0.5, 0.0, 0.0], np.float32))
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    b = 2.0 * np.sum(ro * rd, -1, keepdims=True)
    near, far = -0.5 * b - 1.0, -0.5 * b + 1.0

    key = jax.random.PRNGKey(11)
    render_j = jax.jit(lambda p: JRenderer(jcfg.model).render(
        p, *map(jnp.asarray, (ro, rd, near, far)), key=key, cos_anneal_ratio=0.4,
        flip_saturation=0.9))
    ret_j = render_j(params_j)
    k1, k2 = jax.random.split(key)
    n_out = tcfg.model.udf_renderer.n_outside
    noise = {
        "t_rand": jax.random.uniform(k1, (batch, 1), jnp.float32) - 0.5,
        "t_r": jax.random.uniform(k2, (n_out,), jnp.float32),
    }
    noise = {k: torch.tensor(np.asarray(v)) for k, v in noise.items()}
    renderer_t = TRenderer(tcfg.model)
    ret_t = renderer_t.render(params_t, *map(torch.tensor, (ro, rd, near, far)),
                              noise=noise, cos_anneal_ratio=0.4, flip_saturation=0.9)
    # the port evaluates the iso-surface probe apart from the render, on the
    # points JAX's render draws
    pts_random = jax.random.uniform(jax.random.fold_in(key, 17), (1024, 3), jnp.float32)
    sparse_random = renderer_t.sparse_random_error(
        params_t, torch.tensor(np.asarray(pts_random * 2.0 - 1.0)))
    ret_t = dict(ret_t, sparse_random_error=sparse_random)
    for name in KEYS + ["sparse_random_error"]:
        if name == "sparse_error" and mode == "up_sampling":
            continue
        a = ret_t[name].detach().numpy()
        b = np.asarray(ret_j[name])
        scale = max(float(np.abs(b).max()), 1e-6)
        atol = SPARSE_TOL if name.startswith("sparse") else tol
        np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=name)
    for name in ("color_pixel", "patch_colors"):
        assert ret_t[name] is None and ret_j[name] is None

    # the background NeRF and the colour net receive the same gradients
    g_j = jax.jit(jax.grad(lambda p: jnp.sum(render_j(p)["color"])))(params_j)
    loss_t = torch.sum(ret_t["color"])
    leaf = params_t["nerf"]["rgb"]["w"], params_t["color"]["main"]["lin0"]["v"]
    g_t = torch.autograd.grad(loss_t, leaf)
    for a, b in zip(g_t, (g_j["nerf"]["rgb"]["w"], g_j["color"]["main"]["lin0"]["v"])):
        scale = max(float(np.abs(np.asarray(b)).max()), 1e-6)
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale,
                                   atol=max(tol, 1e-4))


def test_blending_is_not_ported():
    """What the renderer rejects of a blending request: a sampler it does not
    know and a strip sampler with no samples to take. Nothing else of
    blending is refused."""
    for bad in ({"warp_sampler": "strips"}, {"warp_sampler": "strip", "blend_top_k": 0}):
        tcfg = tconfig.from_dict({"model": {"udf_renderer": bad}})
        with pytest.raises(ValueError, match="warp_sampler"):
            TRenderer(tcfg.model)._strip_active({"color_maps": torch.zeros(1, 3, 4, 4)})
    auto = TRenderer(tconfig.from_dict({}).model)
    assert auto.rcfg.warp_sampler == "auto"
    assert not auto._strip_active({"color_maps": torch.zeros(1, 3, 4, 4)})  # CPU tensors: gather


# ---------------------------------------------------------------------------
# the blended render of the finetune
# ---------------------------------------------------------------------------

BH, BW = 64, 256  # one strip of the TPU sampler exactly: it loses no position


def blend_cameras(n_views=3, seed=8):
    """Source cameras on an arc of radius 2 that look at the origin, with
    white-noise images (every position error shows in the colours)."""
    rng = np.random.RandomState(seed)
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = 35.0
    intr[0, 2], intr[1, 2] = BW / 2, BH / 2
    c2ws = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views * 0.15 + 0.1
        loc = np.array([2.0 * np.sin(ang), 0.15 * i, -2.0 * np.cos(ang)], np.float32)
        fwd = -loc / np.linalg.norm(loc)
        right = np.cross(np.array([0, 1, 0], np.float32), fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(fwd, right), fwd, loc
        c2ws.append(c2w)
    return rng.rand(n_views, 3, BH, BW).astype(np.float32), np.stack([intr] * n_views), \
        np.stack(c2ws)


def blend_setup(sampler, n_outside, batch=6):
    rcfg = {"n_samples": 16, "n_importance": 0, "n_outside": n_outside, "h_patch_size": 2,
            "warp_sampler": sampler, "blend_top_k": 10, "blend_chunk": 4}  # k = 8 of 16
    raw = {"model": dict(RENDER_RAW["model"], udf_renderer=rcfg)}
    jcfg, tcfg = jconfig.from_dict(raw), tconfig.from_dict(raw)
    params_j = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params_t = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    ro, rd = hit_rays(batch, 4)
    b = 2.0 * np.sum(ro * rd, -1, keepdims=True)
    near, far = -0.5 * b - 1.0, -0.5 * b + 1.0
    imgs, intrinsics, c2ws = blend_cameras()
    ref_c2w = np.eye(4, dtype=np.float32)
    ref_c2w[:3, 3] = [0, 0, -2.0]
    blending = {"color_maps": imgs, "w2cs": np.linalg.inv(c2ws), "intrinsics": intrinsics,
                "query_c2w": ref_c2w,
                "rays_uv": np.random.RandomState(9).uniform(-0.5, 0.5, (batch, 2)).astype(
                    np.float32)}
    return jcfg, tcfg, params_j, params_t, (ro, rd, near, far), blending


# Tolerances of the blended outputs, relative to each output's largest entry.
# gather: exact f32 gathers on both sides, uniform samples. The pixel-blended
# colour reaches the 2e-5 that the stage-1 render holds; the patch colours
# reach 2.9e-5: a homography position near x = 250 px has an ulp of 1.5e-5 px,
# the two frameworks round its chain of products differently, and a
# white-noise image turns a position shift into colour one to one. strip: the Pallas kernel
# (interpret mode) rounds images and column weights to bf16, the port samples
# in f32: the JAX package's own bound for that is 5e-3.
BLEND_TOL = {"gather": 5e-5, "strip": 5e-3}
BLEND_CASES = [("gather", kind, n_out) for kind in ("pixel", "patch", "both") for n_out in (0, 8)]
BLEND_CASES += [("strip", "both", 0), ("strip", "both", 8), ("strip", "pixel", 8),
                ("strip", "patch", 0)]


@pytest.mark.parametrize("sampler,kind,n_outside", BLEND_CASES)
def test_blended_render_matches_jax(sampler, kind, n_outside):
    jcfg, tcfg, params_j, params_t, rays, blending = blend_setup(sampler, n_outside)
    pixel, patch = kind in ("pixel", "both"), kind in ("patch", "both")
    tol = BLEND_TOL[sampler]
    blend_j = {k: jnp.asarray(v) for k, v in blending.items()}
    blend_j["img_index"] = None
    blend_t = {k: torch.tensor(v) for k, v in blending.items()}
    opts_j = JRenderOptions(perturb=False, compute_random_sparse=False, pixel_blending=pixel,
                            patch_blending=patch)
    render_j = jax.jit(lambda p: JRenderer(jcfg.model).render(
        p, *map(jnp.asarray, rays), key=jax.random.PRNGKey(0), cos_anneal_ratio=0.9,
        flip_saturation=1.0, blending=blend_j, opts=opts_j))
    ret_j = render_j(params_j)
    render_t = lambda: TRenderer(tcfg.model).render(
        params_t, *map(torch.tensor, rays), cos_anneal_ratio=0.9, flip_saturation=1.0,
        blending=blend_t, opts=TRenderOptions(perturb=False, pixel_blending=pixel,
                                              patch_blending=patch))
    ret_t = render_t()

    names = ["color", "weights", "weight_sum", "blend_strip_cover"]
    names += ["color_pixel"] * pixel + ["patch_colors", "patch_mask"] * patch
    for name in names:
        a, b = ret_t[name].detach().numpy(), np.asarray(ret_j[name])
        assert a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1e-6)
        # the stage-1 outputs do not pass through the sampler; see BLEND_TOL
        exact = name in ("color", "weights", "weight_sum") or (
            sampler == "gather" and name == "color_pixel")
        atol = 2e-5 if exact else tol
        np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=name)
    if not pixel:
        assert ret_t["color_pixel"] is None and ret_j["color_pixel"] is None
    if not patch:
        assert ret_t["patch_colors"] is None and ret_j["patch_colors"] is None
    else:
        assert float(np.abs(np.asarray(ret_j["patch_mask"])).max()) > 0.0

    n_fg = 16
    if sampler == "gather":
        assert ret_t["blend_idx"] is None and float(ret_t["blend_strip_cover"]) == 1.0
    else:
        # the same samples are picked: JAX's top_k on its own weights
        w_j = jnp.asarray(np.asarray(ret_j["weights"])[:, :n_fg])
        idx_j = np.sort(np.asarray(jax.lax.top_k(w_j, 8)[1]), axis=-1)
        np.testing.assert_array_equal(ret_t["blend_idx"].numpy(), idx_j)
        assert 0.0 < float(ret_t["blend_strip_cover"]) <= 1.0

    # gradients through the blending logits and the compositing weights
    def scalar(ret, lib):
        parts = ([ret["color_pixel"]] if pixel else []) + ([ret["patch_colors"]] if patch else [])
        return sum(lib.mean(p ** 2) for p in parts)

    g_j = jax.jit(jax.grad(lambda p: scalar(render_j(p), jnp)))(params_j)
    leaves = (("color", "main", "lin2", "v"), ("udf", "lin1", "v"), ("variance", "variance"))
    g_t = torch.autograd.grad(scalar(ret_t, torch),
                              [toptim.get_path(params_t, path) for path in leaves])
    # strip: a bf16-rounded colour under a squared loss; measured up to 2e-3
    grad_tol = 1e-4 if sampler == "gather" else 1e-2
    for path, gt in zip(leaves, g_t):
        gj = g_j
        for key in path:
            gj = gj[key]
        scale = max(float(np.abs(np.asarray(gj)).max()), 1e-12)
        assert scale > 1e-12, path
        np.testing.assert_allclose(gt.numpy() / scale, np.asarray(gj) / scale, atol=grad_tol,
                                   err_msg=str(path))


def test_strip_equals_gather_when_every_sample_is_taken():
    """With blend_top_k = all samples the port's two samplers are the same
    function: the strip path (plain K3 on the CPU, f32) against the gather
    path, outputs and gradients, to f32 rounding."""
    _, tcfg, _, params_t, rays, blending = blend_setup("strip", 8)
    blend_t = {k: torch.tensor(v) for k, v in blending.items()}
    opts = TRenderOptions(perturb=False, pixel_blending=True, patch_blending=True)
    rets, grads = {}, {}
    for sampler in ("strip", "gather"):
        rcfg = dataclasses.replace(tcfg.model.udf_renderer, warp_sampler=sampler,
                                   blend_top_k=16, blend_chunk=4)
        ret = TRenderer(dataclasses.replace(tcfg.model, udf_renderer=rcfg)).render(
            params_t, *map(torch.tensor, rays), cos_anneal_ratio=0.9, flip_saturation=1.0,
            blending=blend_t, opts=opts)
        rets[sampler] = ret
        loss = torch.mean(ret["color_pixel"] ** 2) + torch.mean(ret["patch_colors"] ** 2)
        grads[sampler] = torch.autograd.grad(
            loss, [params_t["udf"]["lin1"]["v"], params_t["color"]["main"]["lin2"]["v"]])
    assert rets["strip"]["blend_idx"].shape == (6, 16)
    for name in ("color_pixel", "patch_colors", "patch_mask"):
        # the gather path normalises its positions (2x/(W-1) - 1) and back
        torch.testing.assert_close(rets["strip"][name], rets["gather"][name], atol=5e-5, rtol=0)
    for a, b in zip(grads["strip"], grads["gather"]):
        assert float(b.abs().max()) > 0
        torch.testing.assert_close(a / b.abs().max(), b / b.abs().max(), atol=1e-4, rtol=0)


def test_strip_top_k_ties_pick_like_jax():
    """Rays that miss the surface carry many equal weights; jax.lax.top_k
    keeps the lower index among equals and torch.topk promises no order, so
    the port sorts stably. Here: alphas of exactly 0 (weights 0) on most
    samples, and equal alphas next to each other."""
    jcfg, tcfg, _, _, _, blending = blend_setup("strip", 0, batch=4)
    rng = np.random.RandomState(3)
    n = 16
    alpha = np.zeros((4, n), np.float32)
    alpha[0, [3, 7]] = 0.25  # 2 positive weights, 14 ties at zero
    alpha[1, 5:9] = 0.0  # all zero: the first k indices
    alpha[2] = 0.1
    alpha[2, 0] = 0.0  # weights tie pairwise: w_0 = 0, and none else equal
    alpha[3, :] = rng.rand(n).astype(np.float32) * 0.2
    alpha[3, 10] = 1.0  # everything after sample 10 has weight 0
    pts = rng.uniform(-0.3, 0.3, (4, n, 3)).astype(np.float32)
    normals = rng.randn(4, n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    blend_j = {k: jnp.asarray(v) for k, v in blending.items()}
    blend_t = {k: torch.tensor(v) for k, v in blending.items()}
    opts = dict(pixel_blending=True, patch_blending=True)
    out_j = JRenderer(jcfg.model)._blend_warp_strip(
        blend_j, jnp.asarray(pts), jnp.asarray(normals), jnp.asarray(alpha),
        JRenderOptions(**opts))
    out_t = TRenderer(tcfg.model)._blend_warp_strip(
        blend_t, torch.tensor(pts), torch.tensor(normals), torch.tensor(alpha),
        TRenderOptions(**opts))
    idx_t = out_t[0].numpy()
    np.testing.assert_array_equal(idx_t, np.asarray(out_j[0]))
    assert idx_t[1].tolist() == list(range(8))
    assert {3, 7} <= set(idx_t[0].tolist()) and idx_t[0].tolist()[:6] == [0, 1, 2, 3, 4, 5]
    # torch.topk would be free to pick otherwise; colours and masks follow the pick
    for a, b in zip(out_t[1:5], out_j[1:5]):
        assert tuple(a.shape) == tuple(b.shape)
        if a.dtype == torch.bool:
            agree = (a.numpy() == np.asarray(b)).mean()
            assert agree > 0.999  # a position within rounding of a bound may flip
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3)
    np.testing.assert_allclose(float(out_t[5]), float(out_j[5]), atol=1e-3)
