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
plain versions of the port.

Tier "high" (bf16x3) of the explicit version, each head, against two
references: ``_value_feat_grad`` of the JAX package with a ``_dot3`` whose
passes round both operands to bf16 as the TPU's MXU does (``tpu_pass``,
transposed into passes of the same kind, as XLA transposes a dot), and its
``jax.vjp`` (TOL_HIGH_TPU); and the Pallas kernels in interpret mode at
``fused_precision="high"``, which run f32 passes on the CPU
(TOL_HIGH_INTERPRET)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.nets import fields as jf
from neuraludf_tpu.ops import fused_distance as jfd
from neuraludf_tpu.ops.fused_distance import distance_value_feat_grad_fused as jax_fused
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.ops import fused_distance as fd

KW = dict(d_out=33, d_hidden=40, n_layers=4, skip_in=(2,), multires=4, scale=1.3)
N = 37
TOL_JAX, TOL_PORT = 2e-5, 1e-5
# "high" against the TPU-semantics reference: the same bf16 roundings in the
# same places; the f32 sums run in another order, which may move a value on
# a bf16 rounding boundary to the neighbouring bf16 value (measured 9e-6;
# "highest" and "default" are 2e-3 and more away from it, see below).
TOL_HIGH_TPU = 3e-5
# "high" against the interpret-mode Pallas kernels (f32 passes on the CPU):
# the cotangents of the gradient sweep and of the reverse sweep are bf16 at
# "high", 2^-9 relative each, over five layers, amplified in x̄ and W̄ by
# softplus100's second derivative (measured 5.3e-3).
TOL_HIGH_INTERPRET = 1.5e-2


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


def _bf16(a):
    return a.astype(jnp.bfloat16).astype(jnp.float32)


@jax.custom_vjp
def tpu_pass(a, b):
    """One MXU pass as the TPU runs jnp.dot at Precision.DEFAULT: both
    operands rounded to bf16, f32 accumulation. Its transpose is two passes
    of the same kind (XLA keeps a dot's precision when it transposes it)."""
    return jnp.dot(_bf16(a), _bf16(b), precision=jax.lax.Precision.HIGHEST)


tpu_pass.defvjp(lambda a, b: (tpu_pass(a, b), (a, b)),
                lambda res, ct: (tpu_pass(ct, res[1].T), tpu_pass(res[0].T, ct)))


def dot3_tpu(x, w):
    """The JAX package's _dot3 with TPU passes."""
    xh = _bf16(x)
    xl = x - xh
    wh = _bf16(w)
    wl = w - wh
    return tpu_pass(xh, wh) + tpu_pass(xh, wl) + tpu_pass(xl, wh)


def high_tier_references(jc, p, x, cot):
    """(udf, feat, grad), x̄, W̄ and b̄ lists of _value_feat_grad with the TPU's
    _dot3 and with the interpret-mode kernels' f32 one."""
    ws, bs = jfd.effective_weights(p, jc)
    refs = {}
    for name, dot in (("tpu", dot3_tpu), ("interpret", jfd._DOTS["high"])):
        f = lambda xx, ws_, bs_: jfd._value_feat_grad(xx, ws_, bs_, jc, dot)
        out, vjp = jax.vjp(f, jnp.asarray(x), ws, bs)
        xbar, wsbar, bsbar = vjp(tuple(jnp.asarray(c) for c in cot))
        refs[name] = [np.asarray(o) for o in out], np.asarray(xbar), wsbar, bsbar
    # the interpret-mode kernels are this reference's f32 arithmetic
    kout, kvjp = jax.vjp(lambda xx: jax_fused(p, xx, dataclasses.replace(jc, fused_precision="high"),
                                              fwd_block=16, bwd_block=16, interpret=True),
                         jnp.asarray(x))
    (kxbar,) = kvjp(tuple(jnp.asarray(c) for c in cot))
    for a, b in zip(list(kout) + [kxbar], refs["interpret"][0] + [refs["interpret"][1]]):
        assert_rel(a, b, TOL_JAX, "interpret-mode kernels vs _value_feat_grad")
    return refs, ws


def explicit_at(tc, ws, bs, x, cot, tier):
    lay = fd.layout_for(tc)
    wflat, bflat = fd.pack([torch.tensor(np.asarray(w)) for w in ws],
                           [torch.tensor(np.asarray(b)) for b in bs], lay)
    xt = torch.tensor(x)
    out = fd.explicit_forward(xt, wflat, bflat, lay, tier)
    xbar, wbar, bbar = fd.explicit_backward(xt, wflat, bflat, lay, tier,
                                            *[torch.tensor(c) for c in cot])
    wsbar, bsbar = fd.unpack(wbar, bbar, lay)
    return [o.numpy() for o in out], xbar.numpy(), wsbar, bsbar


@pytest.mark.parametrize("head", ["abs", "square", "sdf"])
def test_high_tier_matches_tpu_passes_and_pallas_interpret(head):
    jc, tc, p, x, cot = setup(head, seed=4)
    refs, ws = high_tier_references(jc, p, x, cot)
    bs = jfd.effective_weights(p, jc)[1]
    names = ("udf", "feat", "grad", "xbar")
    got = {t: explicit_at(tc, ws, bs, x, cot, t) for t in ("high", "highest")}
    for ref, tol in (("tpu", TOL_HIGH_TPU), ("interpret", TOL_HIGH_INTERPRET)):
        out, xbar, wsbar, bsbar = refs[ref]
        e_out, e_xbar, e_wsbar, e_bsbar = got["high"]
        for name, a, b in zip(names, e_out + [e_xbar], out + [xbar]):
            assert_rel(a, b, tol, f"high vs {ref}: {name}")
        for l in range(len(ws)):
            assert_rel(e_wsbar[l].numpy(), np.asarray(wsbar[l]), tol, f"high vs {ref}: W̄{l}")
            assert_rel(e_bsbar[l].numpy(), np.asarray(bsbar[l]), tol, f"high vs {ref}: b̄{l}")
    # the roundings are what the tight tolerance sees: f32 everywhere
    # ("highest") is far outside it in the gradient, x̄ and W̄
    out, xbar, wsbar, _ = refs["tpu"]
    h_out, h_xbar, h_wsbar, _ = got["highest"]
    worst = max(float(np.abs(a - np.asarray(b)).max() / np.abs(np.asarray(b)).max())
                for a, b in [(h_out[2], out[2]), (h_xbar, xbar)]
                + [(h_wsbar[l].numpy(), wsbar[l]) for l in range(len(ws))])
    assert worst > 20 * TOL_HIGH_TPU, worst


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
    # rows are padded per route: the bf16 sweeps take 128-row tiles, the others 64
    assert fd.ROW_TILE == {"gemm": 64, "sweep": 128, "bf16x3": 64, "tf32x3": 64}
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
    assert fd.precision_tier(tconfig.UDFNetworkConfig(fused_precision="high", **KW)) == "high"
    with pytest.raises(ValueError):
        fd.precision_tier(tconfig.UDFNetworkConfig(fused_precision="bf16x3", **KW))
    assert fd.precision_tier(auto) == "default"
    # the kernels' launchers take CUDA tensors only, and count nothing else
    lay = fd.layout_for(auto)
    wflat = torch.zeros(lay.w_offsets()[-1])
    bflat = torch.zeros(lay.b_offsets()[-1])
    before = fd.fused_forward.launches
    for tier in fd.TIERS:
        with pytest.raises(ValueError):
            fd.fused_forward(torch.zeros(5, 3), wflat, bflat, lay, tier)
    assert fd.fused_forward.launches == before
    assert not fd.default_tier_takes(lay)  # 40-wide: only tier "highest" runs it on the card


def test_tf32_rounding_on_hand_picked_values():
    """``tf32`` rounds as ``cvt.rna.tf32.f32``: to 10 fraction bits, to
    nearest, ties away from zero; exact tf32 values, zeros, infinities and
    NaN pass unchanged; subnormals round on the same bits; a value that
    rounds past the largest float becomes infinite. ``split_tf32`` gives hi
    and lo with the 13 low bits clear and hi + lo within 2^-22 of t."""
    u = 2.0 ** -10  # the tf32 ulp of [1, 2)
    tiny = 2.0 ** -149  # the smallest f32 subnormal
    cases = [
        (1.0, 1.0), (1.0 + u / 2, 1.0 + u), (-(1.0 + u / 2), -(1.0 + u)),  # ties away from zero
        (1.0 + 3 * u / 2, 1.0 + 2 * u), (1.0 + u / 2 - 2.0 ** -23, 1.0),  # tie up; just below a tie
        (1.0 + u / 2 + 2.0 ** -23, 1.0 + u), (3.0 + 2 * u, 3.0 + 2 * u), (1.5, 1.5),  # exact
        (2.0 ** -126, 2.0 ** -126), (-0.0, -0.0), (0.0, 0.0),
        (5000 * tiny, 8192 * tiny), (4095 * tiny, 0.0), (4096 * tiny, 8192 * tiny),  # subnormals
        (12288 * tiny, 16384 * tiny), (-4096 * tiny, -8192 * tiny),
        (float("inf"), float("inf")), (-float("inf"), -float("inf")),
        (float(np.finfo(np.float32).max), float("inf")),
    ]
    t = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    want = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    got = fd.tf32(t)
    assert torch.equal(got, want), [(a, b, c) for a, b, c in zip(t.tolist(), got.tolist(), want.tolist())
                                    if b != c]
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert torch.isnan(fd.tf32(torch.tensor([float("nan")]))).all()
    v = torch.tensor(np.random.RandomState(0).randn(10000).astype(np.float32))
    hi, lo = fd.split_tf32(v)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert float(((hi + lo - v).abs() / v.abs()).max()) <= 2.0 ** -22
    assert float(((hi - v).abs() / v.abs()).max()) <= 2.0 ** -11


# The "tf32x3" route against f32, relative to each output's largest entry:
# the tolerance chip_smoke.py holds the kernels to at tier "highest".
TOL_TF32X3 = 1e-4


@pytest.mark.parametrize("head", ["abs", "square"])
def test_tf32x3_products_match_f32_and_jax_highest_at_main_width(head):
    """The explicit sweeps with the 3xTF32 route's products (``tf32x3_mm``:
    hi and lo as the kernels round them, three passes) at the main-path
    width (8x256, the skip at 4, the 257-wide head, 4,096 points seeded with
    numpy) against the f32 explicit version and against the JAX package's
    "highest" path (``_value_feat_grad`` with ``_DOTS["highest"]`` under
    ``jax.vjp``): udf, feature, gradient, x̄, W̄ and b̄ within TOL_TF32X3 of
    each output's largest entry. Measured on the CPU: at most 2.3e-6
    against the f32 explicit version and 2.1e-6 against JAX, where the f32
    explicit version itself is 2.0e-6 from JAX: the split keeps f32's
    accuracy (a single tf32 pass is ~1e-3 away)."""
    jc = jconfig.UDFNetworkConfig(udf_type=head)
    tc = tconfig.UDFNetworkConfig(udf_type=head)
    n = 4096
    rng = np.random.RandomState(5)
    p = jf.init_distance_field(jax.random.PRNGKey(5), jc)
    p = jax.tree_util.tree_map(lambda a: a + 0.01 * rng.randn(*a.shape).astype(np.float32), p)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cot = (rng.randn(n, 1).astype(np.float32), rng.randn(n, jc.d_out - 1).astype(np.float32),
           rng.randn(n, 3).astype(np.float32))
    ws, bs = jfd.effective_weights(p, jc)
    f = lambda xx, ws_, bs_: jfd._value_feat_grad(xx, ws_, bs_, jc, jfd._DOTS["highest"])
    out, vjp = jax.vjp(f, jnp.asarray(x), ws, bs)
    xbar, wsbar, bsbar = vjp(tuple(jnp.asarray(c) for c in cot))
    flat = lambda ts: np.concatenate([np.asarray(t).reshape(-1) for t in ts])
    ref_jax = [np.asarray(o) for o in out] + [np.asarray(xbar), flat(wsbar), flat(bsbar)]
    got = {}
    for tier in ("tf32x3", "highest"):
        o, xb, wsb, bsb = explicit_at(tc, ws, bs, x, cot, tier)
        got[tier] = o + [xb, flat(t.numpy() for t in wsb), flat(t.numpy() for t in bsb)]
    names = ("udf", "feat", "grad", "xbar", "wbar", "bbar")
    for ref_name, ref in (("f32 explicit", got["highest"]), ("JAX highest", ref_jax)):
        for name, a, b in zip(names, got["tf32x3"], ref):
            assert_rel(a, b, TOL_TF32X3, f"tf32x3 vs {ref_name}: {name}")
    # the split is what runs: the products are not the f32 ones
    assert not np.array_equal(got["tf32x3"][3], got["highest"][3])


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_highest_route_over_layout_cases(case):
    """Tier "highest" takes the 3xTF32 sweeps exactly where the "default"
    sweeps take the net, else the f32 CUDA-core GEMMs; "default" and "high"
    (the bf16x3 sweeps) take the same nets and refuse the others before any
    launch."""
    kw, _, _, takes = LAYOUT_CASES[case]
    lay = fd.layout_for(tconfig.UDFNetworkConfig(**kw))
    assert fd.highest_route(lay) == ("tf32x3" if takes else "gemm")
    assert fd.route_for(lay, "highest") == fd.highest_route(lay)
    for tier, route in (("default", "sweep"), ("high", "bf16x3")):
        if takes:
            assert fd.route_for(lay, tier) == route
        else:
            with pytest.raises(ValueError):
                fd.route_for(lay, tier)
    assert set(fd.ROW_TILE) == set(fd.ROUTES) == set(fd.W_SPLITS)


# The "bf16x3" route's plain products (tier "high" on the sweeps' nets) at
# the main-path width, relative to each output's largest entry: against the
# explicit "high" version, which adds the same passes in JAX's order (measured
# 1.1e-7 at most); against JAX's _dot3 with TPU passes and its VJP (the same
# roundings; measured 5.3e-6, the skip's x / sqrt(2) against x * alpha moving
# a value across a bf16 boundary), TOL_HIGH_TPU; against the JAX package's
# _dot3 as the CPU runs it (f32 passes: its lo and its cotangent unrounded),
# the forward within TOL_HIGH_TPU (measured 4.2e-6) and the transposes within
# TOL_B3_CPU_VJP (the bf16 cotangent, 2^-9 of each term: measured 1.8e-3).
TOL_B3_ORDER = 1e-6
TOL_B3_CPU_VJP = 5e-3


@pytest.mark.parametrize("skip", [False, True])
def test_bf16x3_products_match_explicit_high_and_jax_dot3_at_main_width(skip):
    """``bf16x3_mm`` (the forward products: alpha A split, three passes, the
    small terms first), ``bf16x3_rev`` with ``dot3_sum`` (the reverse
    products: P and S kept apart, P + bf16((S + P) - P)) and the weight
    cotangent (H and L apart) on a [4096 x 256] (the skip layer: [4096 x
    320], alpha = 1/sqrt(2)) activation and a 256-wide W, seeded with
    numpy."""
    rng = np.random.RandomState(7)
    n, k = 4096, 320 if skip else 256
    alpha = 1 / np.sqrt(2) if skip else 1.0
    a = (rng.uniform(0, 0.3, (n, k))).astype(np.float32)
    w = (rng.randn(k, 256) / np.sqrt(k)).astype(np.float32)
    g = (rng.randn(n, 256) * 1e-2).astype(np.float32)
    at, wt, gt = (torch.tensor(v) for v in (a, w, g))
    # the weight cotangent: the left side alpha A split, the right side bf16,
    # H and L kept apart over the split-K sums, combined by dot3_sum
    ah, al = fd._split(alpha * at)
    gb = fd._bf16(gt)
    got = {"y": fd.bf16x3_mm(alpha * at, wt),
           "xbar": alpha * fd.dot3_sum(*fd.bf16x3_rev(gt, wt.T)),
           "wbar": fd.dot3_sum(ah.T @ gb, al.T @ gb)}
    high = {"y": fd._fwd_mm(at, wt, alpha, "high"), "xbar": fd._rev_mm(gt, wt, alpha, "high"),
            "wbar": fd._w_mm(at[:n // 2], at[n // 2:], gt[:n // 2], gt[n // 2:], alpha, "high")}
    for name in got:
        assert_rel(got[name].numpy(), high[name].numpy(), TOL_B3_ORDER, f"bf16x3 vs high: {name}")
    for ref, dot, tol_vjp in (("TPU passes", dot3_tpu, TOL_HIGH_TPU),
                              ("CPU passes", jfd._dot3, TOL_B3_CPU_VJP)):
        f = lambda x, ww: dot(x / np.float32(np.sqrt(2)) if skip else x, ww)
        y, vjp = jax.vjp(f, jnp.asarray(a), jnp.asarray(w))
        xbar, wbar = vjp(jnp.asarray(g))
        assert_rel(got["y"].numpy(), y, TOL_HIGH_TPU, f"bf16x3 vs _dot3 ({ref}): y")
        assert_rel(got["xbar"].numpy(), xbar, tol_vjp, f"bf16x3 vs _dot3 VJP ({ref}): x̄")
        assert_rel(got["wbar"].numpy(), wbar, tol_vjp, f"bf16x3 vs _dot3 VJP ({ref}): W̄")
    # the bf16 cotangent is what the transposes round: f32 is far from them
    f32 = (alpha * gt @ wt.T).numpy()
    assert float(np.abs(got["xbar"].numpy() - f32).max() / np.abs(f32).max()) > 20 * TOL_HIGH_TPU


def rms_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))


# The explicit "high" version on the net of chip_smoke.check_high_rounding's
# skip case (two 256-wide hidden layers, the second fed [h; PE(x)] / sqrt(2),
# the 257-wide head), against JAX's _value_feat_grad with the TPU passes'
# _dot3 under jax.vjp: RMS difference over RMS within TOL_SKIP_RMS (measured
# 1.7e-4 at most, x̄ with the abs and sdf heads: one ulp on x moves the
# explicit version itself by up to 1.5e-4 on this net, the rounding flips
# cascading through sigma(100 a) over two layers), while f32 ("highest") lies
# at least SKIP_SEPARATION times as far from JAX in grad, x̄, W̄ and b̄
# (measured 7.6x at least, the abs head's gradient). On the card the "high"
# kernels are held to this explicit version on this net.
TOL_SKIP_RMS = 3e-4
SKIP_SEPARATION = 5


@pytest.mark.parametrize("head", ["abs", "square", "sdf"])
def test_high_explicit_matches_jax_dot3_on_a_skip_net_at_main_width(head):
    kw = dict(udf_type=head, n_layers=2, skip_in=(1,))
    jc, tc = jconfig.UDFNetworkConfig(**kw), tconfig.UDFNetworkConfig(**kw)
    lay = fd.layout_for(tc)
    assert lay.skip == (False, True, False) and fd.route_for(lay, "high") == "bf16x3"
    n = 4096
    rng = np.random.RandomState(5)
    p = jf.init_distance_field(jax.random.PRNGKey(5), jc)
    p = jax.tree_util.tree_map(lambda a: a + 0.01 * rng.randn(*a.shape).astype(np.float32), p)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cot = (rng.randn(n, 1).astype(np.float32), rng.randn(n, jc.d_out - 1).astype(np.float32),
           rng.randn(n, 3).astype(np.float32))
    ws, bs = jfd.effective_weights(p, jc)
    f = lambda xx, ws_, bs_: jfd._value_feat_grad(xx, ws_, bs_, jc, dot3_tpu)
    out, vjp = jax.vjp(f, jnp.asarray(x), ws, bs)
    xbar, wsbar, bsbar = vjp(tuple(jnp.asarray(c) for c in cot))
    flat = lambda ts: np.concatenate([np.asarray(t).reshape(-1) for t in ts])
    ref = [np.asarray(o) for o in out] + [np.asarray(xbar), flat(wsbar), flat(bsbar)]
    got = {}
    for tier in ("high", "highest"):
        o, xb, wsb, bsb = explicit_at(tc, ws, bs, x, cot, tier)
        got[tier] = o + [xb, flat(t.numpy() for t in wsb), flat(t.numpy() for t in bsb)]
    for i, name in enumerate(("udf", "feat", "grad", "xbar", "wbar", "bbar")):
        err = rms_rel(got["high"][i], ref[i])
        assert err <= TOL_SKIP_RMS, (name, err)
        if name not in ("udf", "feat"):
            assert rms_rel(got["highest"][i], ref[i]) >= SKIP_SEPARATION * err, name
