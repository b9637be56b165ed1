"""The port's fused distance-field op (K1 forward, K2 second-order backward)
on the CPU, where ``FusedDistance`` runs the explicit plain version: values,
features, spatial gradients and the VJP w.r.t. (x, W, b) with random
cotangents on all three outputs, against

* JAX's plain path (``distance_field_apply`` + ``distance_gradient``) under
  ``jax.vjp``;
* JAX's Pallas kernels in interpret mode (``fwd_block=16, bwd_block=16``);
* the port's autograd plain version.

All three heads, a skip layer and odd widths (27-wide embedding, a 13-wide
layer before the skip, a 33-wide head). Tolerances, relative to each
output's largest entry: 2e-5 against JAX (f32, another summation order;
x̄ carries softplus100's 100x second derivative), 1e-5 between the two
plain versions of the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.nets import fields as jf
from neuraludf_tpu.ops.fused_distance import distance_value_feat_grad_fused as jax_fused
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.ops import fused_distance as fd

KW = dict(d_out=33, d_hidden=40, n_layers=4, skip_in=(2,), multires=4, scale=1.3)
N = 37
TOL_JAX, TOL_PORT = 2e-5, 1e-5


def setup(head, seed=0):
    jc = jconfig.UDFNetworkConfig(udf_type=head, **KW)
    tc = tconfig.UDFNetworkConfig(udf_type=head, **KW)
    rng = np.random.RandomState(seed)
    p = jf.init_distance_field(jax.random.PRNGKey(seed), jc)
    # leave the geometric init's zero blocks so every weight matters
    p = jax.tree_util.tree_map(lambda a: a + 0.01 * rng.randn(*a.shape).astype(np.float32), p)
    x = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    cot = (rng.randn(N, 1).astype(np.float32), rng.randn(N, KW["d_out"] - 1).astype(np.float32),
           rng.randn(N, 3).astype(np.float32))
    return jc, tc, p, x, cot


def leaf_paths(p):
    return [(l, k) for l in sorted(p) for k in sorted(p[l])]


def assert_rel(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-6)
    np.testing.assert_allclose(a / scale, b / scale, atol=tol, err_msg=what)


def jax_reference(jc, p, x, cot, kernel: bool):
    if kernel:
        f = lambda pp, xx: jax_fused(pp, xx, jc, fwd_block=16, bwd_block=16, interpret=True)
    else:
        def f(pp, xx):
            out = jf.distance_field_apply(pp, xx, jc)
            return out[:, :1], out[:, 1:], jf.distance_gradient(pp, xx, jc)
    out, vjp = jax.vjp(f, p, jnp.asarray(x))
    pbar, xbar = vjp(tuple(jnp.asarray(c) for c in cot))
    return [np.asarray(o) for o in out], np.asarray(xbar), jax.tree_util.tree_map(np.asarray, pbar)


def port_vjp(tc, p_np, x, cot, which: str):
    params = convert.params_from_jax(p_np)
    xt = torch.tensor(x, requires_grad=True)
    if which == "explicit":
        out = fd.distance_value_feat_grad_fused(
            params, xt, dataclasses.replace(tc, fused_precision="highest"))
    else:
        ws, bs = fd.effective_weights(params, tc)
        out = fd.plain_autograd(xt, ws, bs, tc)
    paths = leaf_paths(params)
    grads = torch.autograd.grad(out, [xt] + [params[l][k] for l, k in paths],
                                grad_outputs=[torch.tensor(c) for c in cot])
    pbar = {l: {} for l, _ in paths}
    for (l, k), g in zip(paths, grads[1:]):
        pbar[l][k] = g.numpy()
    return [o.detach().numpy() for o in out], grads[0].numpy(), pbar


@pytest.mark.parametrize("head", ["abs", "square", "sdf"])
def test_plain_versions_match_jax_and_each_other(head):
    jc, tc, p, x, cot = setup(head)
    p_np = jax.tree_util.tree_map(np.asarray, p)
    ref_out, ref_xbar, ref_pbar = jax_reference(jc, p, x, cot, kernel=False)
    if head == "abs":  # both signs of the head occur
        assert (np.asarray(jf.distance_field_apply(
            p, jnp.asarray(x), jconfig.UDFNetworkConfig(udf_type="sdf", **KW))[:, 0]) < 0).any()
    results = {w: port_vjp(tc, p_np, x, cot, w) for w in ("explicit", "autograd")}
    for which, (out, xbar, pbar) in results.items():
        for name, a, b in zip(("udf", "feat", "grad"), out, ref_out):
            assert_rel(a, b, TOL_JAX, f"{which} {name}")
        assert_rel(xbar, ref_xbar, TOL_JAX, f"{which} xbar")
        for l, k in leaf_paths(p_np):
            assert_rel(pbar[l][k], ref_pbar[l][k], TOL_JAX, f"{which} {l}/{k}")
    (oe, xe, pe), (oa, xa, pa) = results["explicit"], results["autograd"]
    for a, b in zip(oe + [xe], oa + [xa]):
        assert_rel(a, b, TOL_PORT, "explicit vs autograd")
    for l, k in leaf_paths(p_np):
        assert_rel(pe[l][k], pa[l][k], TOL_PORT, f"explicit vs autograd {l}/{k}")


@pytest.mark.parametrize("head", ["abs", "square", "sdf"])
def test_explicit_matches_pallas_interpret(head):
    jc, tc, p, x, cot = setup(head, seed=1)
    ref_out, ref_xbar, ref_pbar = jax_reference(jc, p, x, cot, kernel=True)
    out, xbar, pbar = port_vjp(tc, jax.tree_util.tree_map(np.asarray, p), x, cot, "explicit")
    for name, a, b in zip(("udf", "feat", "grad"), out, ref_out):
        assert_rel(a, b, TOL_JAX, name)
    assert_rel(xbar, ref_xbar, TOL_JAX, "xbar")
    for l, k in leaf_paths(pbar):
        assert_rel(pbar[l][k], ref_pbar[l][k], TOL_JAX, f"{l}/{k}")


def test_default_tier_rounds_operands_to_bf16():
    """Tier "default" is bf16 operands with f32 accumulation, and bf16 for
    what the reverse sweep reads back from the forward one (sigma(100 a) and
    q = 100 sigma (1 - sigma) t_a, as the kernels store them): within 3e-2
    of the largest entry of "highest", and not equal to it. The bound is
    bf16's 2^-9 per rounded value, summed over the nine products a value
    passes and amplified by softplus100's second derivative (x̄ and W̄ are
    the worst, 2e-2 here); the stored sigma and q add their 2^-9 once per
    layer and stay inside it."""
    _, tc, p, x, cot = setup("abs", seed=2)
    lay = fd.layout_for(tc)
    ws, bs = fd.effective_weights(convert.params_from_jax(jax.tree_util.tree_map(np.asarray, p)), tc)
    wflat, bflat = fd.pack([w.detach() for w in ws], [b.detach() for b in bs], lay)
    xt = torch.tensor(x)
    hi = fd.explicit_forward(xt, wflat, bflat, lay, "highest")
    lo = fd.explicit_forward(xt, wflat, bflat, lay, "default")
    for a, b in zip(lo, hi):
        assert_rel(a, b, 3e-2, "default vs highest")
    assert not torch.equal(lo[1], hi[1])
    cot_t = [torch.tensor(c) for c in cot]
    bw_hi = fd.explicit_backward(xt, wflat, bflat, lay, "highest", *cot_t)
    bw_lo = fd.explicit_backward(xt, wflat, bflat, lay, "default", *cot_t)
    for a, b in zip(bw_lo, bw_hi):
        assert_rel(a, b, 3e-2, "default vs highest (backward)")
    # what is kept between the sweeps is bf16 at "default" and untouched at "highest"
    sg = torch.sigmoid(torch.tensor(x[:, :1] * 3.0))
    assert torch.equal(fd._stored(sg, "default"), sg.to(torch.bfloat16).float())
    assert fd._stored(sg, "highest") is sg
    assert not torch.equal(fd._stored(sg, "default"), sg)


LAYOUT_CASES = {
    # name: (config overrides, true widths, padded head, whether the "default" kernels take it)
    "small": (KW, [(27, 40), (40, 13), (40, 40), (40, 40), (40, 33)], 64, False),
    "full": ({}, [(39, 256), (256, 256), (256, 256), (256, 217), (256, 256), (256, 256),
                  (256, 256), (256, 256), (256, 257)], 320, True),
    "full_wide_head": (dict(d_out=300), None, 320, True),
    "full_narrow_head": (dict(d_out=200), None, 256, False),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_padding_round_trip(case):
    kw, dims, head_np, takes = LAYOUT_CASES[case]
    tc = tconfig.UDFNetworkConfig(**kw)
    lay = fd.layout_for(tc)
    assert lay.pe_w == 64 and all(v % fd.TILE == 0 for v in lay.kp + lay.np_)
    assert lay.np_[-1] == head_np and fd.default_tier_takes(lay) == takes
    assert fd.ROW_TILE == {"highest": 64, "default": 128}  # rows are padded per tier
    if case == "small":
        assert lay.n_true == (40, 13, 40, 40, 33)
        assert lay.skip == (False, False, True, False, False)
    if case == "full":  # the 8x256 main-path net
        assert lay.n_true[3] == 217 and lay.kp[4] == 256 + 64
    if dims is None:
        dims = [(lay.h_true[l] + (lay.d0 if l == 0 or lay.skip[l] else 0), lay.n_true[l])
                for l in range(lay.n_layers)]
    rng = np.random.RandomState(3)
    ws = [torch.tensor(rng.randn(*d).astype(np.float32)) for d in dims]
    bs = [torch.tensor(rng.randn(d[1]).astype(np.float32)) for d in dims]
    wflat, bflat = fd.pack(ws, bs, lay)
    assert float(wflat.abs().sum()) == pytest.approx(sum(float(w.abs().sum()) for w in ws),
                                                     rel=1e-6)
    ws2, bs2 = fd.unpack(wflat, bflat, lay)
    for a, b in zip(ws + bs, ws2 + bs2):
        assert torch.equal(a, b)


def test_switches_and_wrapper_contract():
    cpu = torch.device("cpu")
    auto = tconfig.UDFNetworkConfig(**KW)
    assert not fd.fused_enabled(auto, cpu)
    assert fd.fused_enabled(auto, torch.device("cuda", 0))
    assert not fd.fused_enabled(tconfig.UDFNetworkConfig(fused_core="off", **KW), cpu)
    with pytest.raises(RuntimeError):
        fd.fused_enabled(tconfig.UDFNetworkConfig(fused_core="on", **KW), cpu)
    with pytest.raises(NotImplementedError):
        fd.precision_tier(tconfig.UDFNetworkConfig(fused_precision="high", **KW))
    assert fd.precision_tier(auto) == "default"
    # the kernels' launchers take CUDA tensors only, and count nothing else
    lay = fd.layout_for(auto)
    wflat = torch.zeros(lay.w_offsets()[-1])
    bflat = torch.zeros(lay.b_offsets()[-1])
    before = fd.fused_forward.launches
    with pytest.raises(ValueError):
        fd.fused_forward(torch.zeros(5, 3), wflat, bflat, lay, "default")
    assert fd.fused_forward.launches == before
    assert not fd.default_tier_takes(lay)  # 40-wide: only tier "highest" runs it on the card
