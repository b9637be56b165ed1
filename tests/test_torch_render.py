"""The port's sampling and renderer against ``neuraludf_tpu.render`` on the
CPU: ``sample_pdf`` brackets (edges included), the classical up-sampling,
and a full stage-1 ``render`` on a tiny sphere setup with the random draws
taken from JAX's key exactly as ``UDFRenderer.render`` takes them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.render import alpha as jalpha
from neuraludf_tpu.render import sampling as js
from neuraludf_tpu.render.renderer import UDFRenderer as JRenderer
from neuraludf_tpu.train.runner import init_params as jax_init_params
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.render import alpha as talpha
from neuraludf_tpu_torch.render import sampling as ts
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
    tcfg = tconfig.from_dict({})
    r = TRenderer(tcfg.model)
    from neuraludf_tpu_torch.render.renderer import RenderOptions

    with pytest.raises(NotImplementedError, match="slice 2"):
        r.render_core({}, None, None, torch.zeros(1, 2), 0.1, blending={},
                      opts=RenderOptions(pixel_blending=True))
