"""The port's networks against ``neuraludf_tpu.nets`` on the CPU, in f32:
the embedding, the distance field (three heads) and its spatial gradient,
the residual colour net and the background NeRF. Parameters come from the
JAX initialisers and are converted with ``convert.py``; inputs are numpy
draws from a seed. Tolerance atol 1e-5: f32 on both sides, matmuls summed in
another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.nets import embedder as jemb
from neuraludf_tpu.nets import fields as jf
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.nets import embedder as temb
from neuraludf_tpu_torch.nets import fields as tf
from neuraludf_tpu_torch.nets import mlp as tmlp

ATOL = 1e-5

UDF_KW = dict(d_out=33, d_hidden=48, n_layers=4, skip_in=(2,), multires=4, scale=1.2)


def both(cls_name, **kw):
    return getattr(jconfig, cls_name)(**kw), getattr(tconfig, cls_name)(**kw)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b), atol=atol, rtol=1e-5)


def test_positional_encoding():
    x = np.random.RandomState(0).uniform(-1, 1, (11, 3)).astype(np.float32)
    for multires in (0, 1, 6, 10):
        close(temb.positional_encoding(torch.tensor(x), multires),
              jemb.positional_encoding(jnp.asarray(x), multires))
        assert temb.embed_dim(multires, 3) == jemb.embed_dim(multires, 3)


@pytest.mark.parametrize("head", ["abs", "square", "sdf"])
def test_distance_field_and_gradient(head):
    jc, tc = both("UDFNetworkConfig", udf_type=head, **UDF_KW)
    p_j = jf.init_distance_field(jax.random.PRNGKey(1), jc)
    p_t = convert.params_from_jax(to_np(p_j))
    x = np.random.RandomState(2).uniform(-1, 1, (37, 3)).astype(np.float32)
    close(tf.distance_field_apply(p_t, torch.tensor(x), tc),
          jf.distance_field_apply(p_j, jnp.asarray(x), jc))
    close(tf.distance_gradient(p_t, torch.tensor(x), tc),
          jf.distance_gradient(p_j, jnp.asarray(x), jc), atol=5e-5)
    u, f, g = tf.distance_value_and_gradient(p_t, torch.tensor(x), tc)  # auto -> plain on CPU
    uj, fj, gj = jf.distance_value_and_gradient(p_j, jnp.asarray(x), jc)
    for a, b in ((u, uj), (f, fj), (g, gj)):
        close(a, b, atol=5e-5)


def test_eikonal_parameter_gradients():
    """Second order: d/dparams of the eikonal term through the spatial gradient."""
    jc, tc = both("UDFNetworkConfig", **UDF_KW)
    p_j = jf.init_distance_field(jax.random.PRNGKey(3), jc)
    x = np.random.RandomState(4).uniform(-1, 1, (29, 3)).astype(np.float32)

    def eik_j(p):
        g = jf.distance_gradient(p, jnp.asarray(x), jc)
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    g_j = to_np(jax.grad(eik_j)(p_j))
    p_t = convert.params_from_jax(to_np(p_j))
    g = tf.distance_gradient(p_t, torch.tensor(x), tc)
    eik = torch.mean((torch.linalg.vector_norm(g, dim=-1) - 1.0) ** 2)
    paths = [(l, k) for l in p_t for k in p_t[l]]
    grads = torch.autograd.grad(eik, [p_t[l][k] for l, k in paths])
    for (l, k), gt in zip(paths, grads):
        scale = max(float(np.abs(g_j[l][k]).max()), 1e-6)
        np.testing.assert_allclose(gt.numpy() / scale, g_j[l][k] / scale, atol=1e-5,
                                   err_msg=f"{l}/{k}")


@pytest.mark.parametrize("mode", ["no_normal", "idr"])
def test_residual_color(mode):
    # idr feeds [points, normals, -normals, feature]: d_in - 3 = 9
    jc, tc = both("RenderingNetworkConfig", d_feature=16, d_hidden=24, n_layers=3, mode=mode,
                  d_in=12 if mode == "idr" else 6)
    p_j = jf.init_residual_color(jax.random.PRNGKey(5), jc)
    p_t = convert.params_from_jax(to_np(p_j))
    rng = np.random.RandomState(6)
    pts, nrm, dirs = (rng.randn(19, 3).astype(np.float32) for _ in range(3))
    feat = rng.randn(19, 16).astype(np.float32)
    out_t = tf.residual_color_apply(p_t, *map(torch.tensor, (pts, nrm, dirs, feat)), tc)
    out_j = jf.residual_color_apply(p_j, *map(jnp.asarray, (pts, nrm, dirs, feat)), jc)
    for a, b in zip(out_t, out_j):
        close(a, b)
    # normals are stop-grad inputs to the colour net
    nt = torch.tensor(nrm, requires_grad=True)
    _, color, _ = tf.residual_color_apply(p_t, torch.tensor(pts), nt, torch.tensor(dirs),
                                          torch.tensor(feat), tc)
    color.sum().backward()
    assert nt.grad is None


def test_background_nerf():
    jc, tc = both("NeRFConfig", D=4, W=32, multires=4, multires_view=2, skips=(1,))
    p_j = jf.init_background_nerf(jax.random.PRNGKey(7), jc)
    p_t = convert.params_from_jax(to_np(p_j))
    rng = np.random.RandomState(8)
    pts = rng.randn(23, 4).astype(np.float32)
    views = rng.randn(23, 3).astype(np.float32)
    out_t = tf.background_nerf_apply(p_t, torch.tensor(pts), torch.tensor(views), tc)
    out_j = jf.background_nerf_apply(p_j, jnp.asarray(pts), jnp.asarray(views), jc)
    for a, b in zip(out_t, out_j):
        close(a, b)
    alpha_t, rgb_t = tf.background_nerf_apply(p_t, torch.tensor(pts), None, tc)
    assert rgb_t is None
    close(alpha_t, out_j[0])


def test_scalar_nets():
    vj, vt = both("VarianceConfig", init_val=0.27)
    bj, bt = both("BetaNetworkConfig", init_var_beta=0.41, init_var_gamma=0.2, init_var_zeta=-0.3)
    pv_j, pb_j = jf.init_variance(vj), jf.init_beta(bj)
    pv_t, pb_t = tf.init_variance(vt), tf.init_beta(bt)
    close(tf.variance_inv_s(pv_t), jf.variance_inv_s(pv_j))
    close(tf.beta_value(pb_t), jf.beta_value(pb_j))
    close(tf.gamma_value(pb_t), jf.gamma_value(pb_j))
    close(tf.zeta_value(pb_t), jf.zeta_value(pb_j))


def test_inits_match_jax_layout():
    """The port's own initialisers give the JAX pytree's keys and shapes, and
    the geometric init's structure: zero PE rows in layer 0 and in the
    skip layer, the last layer's mean-shifted weights and -bias."""
    jc, tc = both("UDFNetworkConfig", **UDF_KW)
    gen = torch.Generator().manual_seed(0)
    p_t = tf.init_distance_field(gen, tc)
    convert.check_like(convert.to_numpy(p_t), to_np(jf.init_distance_field(jax.random.PRNGKey(0), jc)))
    w0 = tmlp.weight(p_t["lin0"]).detach().numpy()
    assert np.all(w0[3:] == 0) and np.any(w0[:3] != 0)
    d0 = temb.embed_dim(tc.multires, 3)
    assert np.all(tmlp.weight(p_t["lin2"]).detach().numpy()[-(d0 - 3):] == 0)
    last = tmlp.weight(p_t[f"lin{tc.n_layers}"]).detach().numpy()
    np.testing.assert_allclose(last.mean(), np.sqrt(np.pi) / np.sqrt(tc.d_hidden), rtol=1e-3)
    np.testing.assert_array_equal(p_t[f"lin{tc.n_layers}"]["b"].numpy(), -tc.bias)

    # torch nn.Linear's default: U(-1/sqrt(d_in), 1/sqrt(d_in))
    for name, init_t, init_j, first in (
            ("RenderingNetworkConfig", tf.init_residual_color, jf.init_residual_color,
             ("main", "lin0", "v")),
            ("NeRFConfig", tf.init_background_nerf, jf.init_background_nerf,
             ("pts", "lin0", "w"))):
        jcfg, tcfg = both(name)
        p = init_t(torch.Generator().manual_seed(1), tcfg)
        convert.check_like(convert.to_numpy(p), to_np(init_j(jax.random.PRNGKey(1), jcfg)))
        w = p[first[0]][first[1]][first[2]].numpy()
        assert 0.5 / np.sqrt(w.shape[0]) < np.abs(w).max() <= 1.0 / np.sqrt(w.shape[0])


def test_weight_norm_linear():
    rng = np.random.RandomState(9)
    w = rng.randn(7, 5).astype(np.float32)
    p = tmlp.to_weight_norm({"w": torch.tensor(w), "b": torch.zeros(5)})
    np.testing.assert_allclose(tmlp.weight(p).numpy(), w, rtol=1e-6)
    p["g"] = p["g"] * 2.0
    np.testing.assert_allclose(tmlp.weight(p).numpy(), 2.0 * w, rtol=1e-6)
    x = rng.randn(3, 7).astype(np.float32)
    close(tmlp.softplus100(torch.tensor(x)), jax.nn.softplus(100.0 * x) / 100.0)
