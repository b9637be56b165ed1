"""K4, the NeRF++ background MLP's kernels (``ops/nerf_mlp.py``), on the CPU.

* The kernels' roundings written out in torch (``explicit_forward``,
  ``explicit_backward``: bf16 operands, f32 sums, f32 biases, ReLU masks,
  f32 weight cotangents) at the DTU widths on 2,048 rows against the plain
  ``background_nerf_apply`` (f32 on the CPU) and JAX's, from one converted
  init; and against the bf16 chain the card ran before the kernels
  (``linear`` at the "bf16" policy), both held to an f64 evaluation.
* Which networks the kernels take, the launcher's refusal of CPU tensors,
  and the CPU path of ``background_nerf_apply`` (the plain chain, bit for
  bit, with no launch).
* On the card (marked ``card``, skipped without one): ``chip_smoke.check_nerf``.

Inputs are numpy draws from a seed, shaped as ``render_core_outside`` makes
them (points as (x/r, 1/r) with r >= 1, unit view directions); the
cotangents are uniform, of a positive mean, as a loss's are.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.nets import fields as jf
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.nets import fields as tf
from neuraludf_tpu_torch.nets import mlp as tmlp
from neuraludf_tpu_torch.nets.embedder import positional_encoding
from neuraludf_tpu_torch.ops import nerf_mlp as nm
from neuraludf_tpu_torch.train.optim import leaves
from neuraludf_tpu_torch.utils import trace

CONFS = Path(__file__).resolve().parents[1] / "confs"
ROWS = 2048
# max |K4's roundings - reference| / max |reference| per output and leaf,
# against the f32 plain path and JAX (which agree to 4e-7): bf16 operands
# in every product. Measured on seeds 0 and 1: raw and rgb <= 4.8e-3, the
# weight and bias cotangents <= 1.7e-2 (lin0's, the deepest in the
# backward chain).
TOL_FWD = 1e-2
TOL_GRAD = 4e-2
# K4's roundings against the bf16 chain, both held to f64 by RMS over RMS:
# K4's error is at most this times the chain's in every output and leaf
# (measured: 0.45-0.99; the heads' biases are exact in both).
TOL_PRECISION_RATIO = 1.1


def inputs(n: int, seed: int):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 1.0 + rng.exponential(3.0, size=(n, 1))
    pts = np.concatenate([d, 1.0 / r], 1).astype(np.float32)
    v = rng.randn(n, 3)
    views = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    d_raw = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    d_rgb = rng.uniform(-0.5, 1.0, (n, 3)).astype(np.float32)
    return pts, views, d_raw, d_rgb


def dtu_params(seed: int):
    """JAX's init of the DTU NeRF++ and its conversion into the port's tree."""
    p_j = jf.init_background_nerf(jax.random.PRNGKey(seed), jconfig.NeRFConfig())
    return p_j, convert.params_from_jax(jax.tree_util.tree_map(np.asarray, p_j))


def tree(ws, bs):
    """The port's parameter tree of layer lists in ``nm.LAYERS`` order."""
    out = {}
    for path, w, b in zip(nm.LAYERS, ws, bs):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = {"w": w, "b": b}
    return out


def plain_grads(ws, bs, pts, views, d_raw, d_rgb, dtype=torch.float64):
    """Outputs and leaf cotangents of ``background_nerf_apply_plain`` in
    ``dtype``, weights in LAYERS order, then biases."""
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in (*ws, *bs)]
    n = len(nm.LAYERS)
    raw, rgb = tf.background_nerf_apply_plain(tree(leaves[:n], leaves[n:]), pts.to(dtype),
                                              views.to(dtype), tconfig.NeRFConfig())
    g = torch.autograd.grad((raw * d_raw.to(dtype)).sum() + (rgb * d_rgb.to(dtype)).sum(),
                            leaves)
    return (raw, rgb), list(g)


def max_rel(a, b) -> float:
    a, b = (np.asarray(t.detach() if torch.is_tensor(t) else t, dtype=np.float64) for t in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def rms_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def jax_leaf(tree_j, path):
    for key in path:
        tree_j = tree_j[key]
    return tree_j


@pytest.mark.parametrize("seed", [0, 1])
def test_explicit_version_matches_the_plain_path_and_jax(seed):
    p_j, p_t = dtu_params(seed)
    ws, bs = nm.layer_params(p_t)
    pts, views, d_raw, d_rgb = inputs(ROWS, seed)
    P, V, DR, DC = map(torch.tensor, (pts, views, d_raw, d_rgb))
    raw, rgb = nm.explicit_forward(P, V, ws, bs)
    dws, dbs = nm.explicit_backward(P, V, ws, bs, DR, DC)
    assert raw.shape == (ROWS, 1) and rgb.shape == (ROWS, 3)

    plain, g = plain_grads(ws, bs, P, V, DR, DC, torch.float32)
    out_j, vjp = jax.vjp(lambda p: jf.background_nerf_apply(p, jnp.asarray(pts),
                                                            jnp.asarray(views),
                                                            jconfig.NeRFConfig()), p_j)
    (g_j,) = vjp((jnp.asarray(d_raw), jnp.asarray(d_rgb)))
    for k, ref_t, ref_j in zip((raw, rgb), plain, out_j):
        assert max_rel(k, ref_t) < TOL_FWD
        assert max_rel(k, ref_j) < TOL_FWD
    n = len(nm.LAYERS)
    for i, path in enumerate(nm.LAYERS):
        leaf_j = jax_leaf(g_j, path)
        assert dws[i].shape == nm.SHAPES[i] and dbs[i].shape == nm.SHAPES[i][1:]
        assert max_rel(dws[i], g[i]) < TOL_GRAD, path
        assert max_rel(dbs[i], g[n + i]) < TOL_GRAD, path
        assert max_rel(dws[i], leaf_j["w"]) < TOL_GRAD, path
        assert max_rel(dbs[i], leaf_j["b"]) < TOL_GRAD, path


def bf16_chain(x, w, role):
    """``mlp._matmul`` as the card ran it before the kernels, on any device."""
    if tmlp.PRECISION_POLICY[role] == "bf16":
        return torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16)).to(x.dtype)
    return torch.matmul(x, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_roundings_are_at_least_as_precise_as_the_bf16_chain(seed, monkeypatch):
    """Against an f64 evaluation, K4's roundings are no further off than
    the per-layer bf16 chain in raw, rgb and every weight and bias
    cotangent (within TOL_PRECISION_RATIO)."""
    _, p_t = dtu_params(seed)
    ws, bs = nm.layer_params(p_t)
    P, V, DR, DC = map(torch.tensor, inputs(ROWS, seed))
    ref_out, ref_g = plain_grads(ws, bs, P, V, DR, DC, torch.float64)
    monkeypatch.setattr(tmlp, "_matmul", bf16_chain)
    chain_out, chain_g = plain_grads(ws, bs, P, V, DR, DC, torch.float32)
    k_out = nm.explicit_forward(P, V, ws, bs)
    dws, dbs = nm.explicit_backward(P, V, ws, bs, DR, DC)
    for k, chain, ref in zip((*k_out, *dws, *dbs), (*chain_out, *chain_g), (*ref_out, *ref_g)):
        k_err, chain_err = rms_rel(k, ref), rms_rel(chain, ref)
        assert k_err <= TOL_PRECISION_RATIO * chain_err + 1e-6, (k_err, chain_err)


def test_the_kernel_geometry_is_the_dtu_nerfs():
    """The kernels' fixed layer shapes are what ``init_background_nerf``
    makes of the DTU configuration, in ``nm.LAYERS`` order."""
    cfg = tconfig.load(str(CONFS / "udf_dtu_blending.conf")).model.nerf
    params = tf.init_background_nerf(torch.Generator().manual_seed(0), cfg)
    ws, bs = nm.layer_params(params)
    assert [tuple(w.shape) for w in ws] == list(nm.SHAPES)
    assert [tuple(b.shape) for b in bs] == [s[1:] for s in nm.SHAPES]
    assert nm.PE_DIM == positional_encoding(torch.zeros(1, cfg.d_in), cfg.multires).shape[1]


@pytest.mark.parametrize("conf", ["udf_dtu_blending.conf", "udf_dtu_blending_ft.conf",
                                  "udf_garment_blending.conf", "synthetic_smoke.conf"])
def test_the_kernels_take_the_published_nerf(conf):
    assert nm.nerf_kernel_takes(tconfig.load(str(CONFS / conf)).model.nerf)


@pytest.mark.parametrize("change", [
    dict(D=2, W=32, multires=4, multires_view=2, skips=(0,)),  # the tests' renderer
    dict(D=4), dict(W=128), dict(skips=()), dict(skips=(3,)), dict(use_viewdirs=False),
    dict(multires=6), dict(multires_view=0), dict(d_in=3),
])
def test_the_kernels_refuse_other_networks(change):
    assert not nm.nerf_kernel_takes(tconfig.NeRFConfig(**change))


def test_layer_params_refuses_another_tree():
    _, p_t = dtu_params(0)
    assert nm.layer_params(p_t) is not None
    normed = dict(p_t, feature=tmlp.to_weight_norm(p_t["feature"]))
    assert nm.layer_params(normed) is None
    small = tf.init_background_nerf(torch.Generator().manual_seed(0),
                                    tconfig.NeRFConfig(D=2, W=32, skips=(0,)))
    assert nm.layer_params(small) is None


def test_the_launchers_refuse_cpu_tensors_and_count_nothing():
    _, p_t = dtu_params(0)
    ws, bs = nm.layer_params(p_t)
    P, V, DR, DC = map(torch.tensor, inputs(16, 0))
    fwd, bwd = nm.nerf_forward.launches, nm.nerf_backward.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nm.nerf_forward(P, V, ws, bs, save=True)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nm.nerf_backward(ws, 16, DR, DC, torch.empty(0, dtype=torch.uint8))
    assert (nm.nerf_forward.launches, nm.nerf_backward.launches) == (fwd, bwd)


def parent_background_nerf_apply(params, pts, views, cfg):
    """``background_nerf_apply`` as it was before the kernels."""
    h_in = positional_encoding(pts, cfg.multires) if cfg.multires > 0 else pts
    h = h_in
    for i in range(cfg.D):
        h = torch.relu(tmlp.linear(params["pts"][f"lin{i}"], h, "nerf"))
        if i in cfg.skips:
            h = torch.cat([h_in, h], dim=-1)
    alpha = tmlp.linear(params["alpha"], h, "nerf")
    if views is None:
        return alpha, None
    v_in = positional_encoding(views, cfg.multires_view) if cfg.multires_view > 0 else views
    h = torch.cat([tmlp.linear(params["feature"], h, "nerf"), v_in], dim=-1)
    h = torch.relu(tmlp.linear(params["views"]["lin0"], h, "nerf"))
    return alpha, tmlp.linear(params["rgb"], h, "nerf")


@pytest.mark.parametrize("cfg", [tconfig.NeRFConfig(),
                                 tconfig.NeRFConfig(D=2, W=32, multires=4, multires_view=2,
                                                    skips=(0,))],
                         ids=["dtu", "test_renderer"])
@pytest.mark.parametrize("with_views", [True, False])
def test_cpu_tensors_take_the_plain_chain_bit_for_bit(cfg, with_views):
    """On the CPU ``background_nerf_apply`` is the parent's chain bit for
    bit, outputs and gradients; nothing launches and nothing counts as a
    fallback (``nerf.plain`` counts CUDA calls only)."""
    params = tf.init_background_nerf(torch.Generator().manual_seed(3), cfg)
    pts, views, d_raw, d_rgb = map(torch.tensor, inputs(300, 3))
    views = views if with_views else None
    tensors = [t.requires_grad_(True) for _, t in leaves(params)]
    fwd, bwd = nm.nerf_forward.launches, nm.nerf_backward.launches
    trace.reset()
    trace.enable()
    try:
        out = tf.background_nerf_apply(params, pts, views, cfg)
        counts = trace.snapshot()["counts"]
    finally:
        trace.disable()
        trace.reset()
    ref = parent_background_nerf_apply(params, pts, views, cfg)
    assert "nerf.plain" not in counts and "op.nerf_fwd" not in counts
    assert (nm.nerf_forward.launches, nm.nerf_backward.launches) == (fwd, bwd)
    loss = lambda o: (o[0] * d_raw).sum() + ((o[1] * d_rgb).sum() if o[1] is not None else 0.0)
    grads = torch.autograd.grad(loss(out), tensors, allow_unused=True)
    ref_grads = torch.autograd.grad(loss(ref), tensors, allow_unused=True)
    for a, b in zip(out, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(grads, ref_grads):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.card
def test_the_kernels_match_both_plain_versions_on_the_card():
    """``chip_smoke.check_nerf`` (it raises where K4's forward or backward
    leaves its tolerances from the explicit version or from autograd of the
    plain path, at a DTU step's rows and a validation chunk's, inside a
    CUDA graph)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    out = chip_smoke.check_nerf(torch.device("cuda:0"))
    assert out["capture_launches"] == {"fwd": 1, "bwd": 1}
