"""K5, the up-sampling's value-only distance pass (``ops/fused_distance.py``
``sampling_distance_fn``, ``csrc/fused_distance.cu`` ``value_kernel``), on
the CPU.

* K5's roundings written out in torch (``explicit_value``: bf16 operands,
  f32 sums, f32 biases and softplus100, the head's column 0 alone) at the
  DTU widths against the f32 chain (``fields.distance_value``, which is
  f32 on the CPU at every role), against the value column of K1's explicit
  version at tier "default", and against the bf16 chain the card ran before
  K5, both held to an f64 evaluation; it and the port's CPU pass against
  the JAX package's up-sampling pass (its ``UDFRenderer.udf_fn``) on one
  converted net.
* Which nets, devices and policies the gate (``value_kernel_takes``) sends
  to K5; which parameter trees ``value_layers`` takes; the launchers'
  refusal of CPU tensors.
* The CPU path of ``UDFRenderer.udf_fn`` and of both importance samplers,
  bit for bit the parent's chain with no launch and no counter; with the
  launchers replaced by the explicit version, one pack a render and one K5
  launch a pass: 5 passes of a DTU render, 6 of a garment one.
* On the card (marked ``card``, skipped without one): ``chip_smoke.check_value``.

The net is the seeded init of the DTU configuration with every leaf moved
by 5% of its RMS (the init's field is a smooth sphere); the points are
uniform in [-1.2, 1.2]^3, where the up-sampling's samples lie.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.nets import fields as jf
from neuraludf_tpu.render import renderer as jrenderer
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.nets import fields
from neuraludf_tpu_torch.nets import mlp as tmlp
from neuraludf_tpu_torch.ops import fused_distance as fd
from neuraludf_tpu_torch.render import renderer as trenderer
from neuraludf_tpu_torch.render import sampling
from neuraludf_tpu_torch.utils import trace

CONFS = Path(__file__).resolve().parents[1] / "confs"
ROWS = 4096
# max |explicit - f32 chain| / max |f32 chain|: bf16 operands in every
# product (measured on seeds 0 and 1: 5.2e-3 and 6.1e-3; the bf16 chain
# 6.9e-3 and 6.8e-3).
TOL_F32 = 1.5e-2
# the port's CPU pass (the f32 chain) against JAX's (f32 on the CPU): the
# same f32 formulas in other kernels (measured 1.1e-6 and 7.1e-7; the
# explicit version against JAX, under TOL_F32: 5.8e-3 and 4.5e-3).
TOL_JAX = 1e-5
# against the value column of K1's explicit version at "default": the same
# roundings, the head's column taken alone, so its sum in another order
# (measured 3.6e-7 and 6.5e-7).
TOL_K1 = 1e-5
# K5's roundings against the bf16 chain, both held to f64 by RMS over RMS:
# K5's error is at most this times the chain's (measured 0.73 and 0.76: the
# chain also rounds every product's output to bf16).
TOL_PRECISION_RATIO = 0.9


def udf_cfg(conf: str = "udf_dtu_blending.conf"):
    return tconfig.load(str(CONFS / conf)).model.udf_network


def net(seed: int, cfg=None):
    cfg = cfg or udf_cfg()
    gen = torch.Generator().manual_seed(seed)
    params = fields.init_distance_field(gen, cfg)
    for p in params.values():
        for k, t in p.items():
            p[k] = t + 0.05 * float(t.pow(2).mean().sqrt()) * torch.randn(t.shape, generator=gen)
    return params


def points(n: int, seed: int) -> torch.Tensor:
    return torch.rand(n, 3, generator=torch.Generator().manual_seed(100 + seed)) * 2.4 - 1.2


def max_rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def rms_rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bf16_chain(x, w, role):
    """``mlp._matmul`` as the card runs it at the "bf16" policy, on any device."""
    if tmlp.PRECISION_POLICY[role] == "bf16":
        return torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16)).to(x.dtype)
    return torch.matmul(x, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_explicit_version_matches_the_f32_chain_and_k1(seed):
    cfg, params, x = udf_cfg(), net(seed), points(ROWS, seed)
    got = fd.explicit_value(x, params, cfg)
    assert got.shape == (ROWS,) and got.dtype == torch.float32
    chain = fields.distance_value(params, x, cfg, role="sampling")[:, 0]  # f32 on the CPU
    assert torch.equal(chain, fields.distance_value(params, x, cfg)[:, 0])
    assert max_rel(got, chain) < TOL_F32
    lay = fd.layout_for(cfg)
    wflat, bflat = fd.pack(*fd.effective_weights(params, cfg), lay)
    k1_udf = fd.explicit_forward(x, wflat, bflat, lay, "default")[0][:, 0]
    assert max_rel(got, k1_udf) < TOL_K1


@pytest.mark.parametrize("seed", [0, 1])
def test_explicit_version_and_the_cpu_pass_match_jax(seed):
    """K5's roundings and the port's CPU pass (``sampling_distance_fn``)
    against the JAX package's up-sampling pass (``UDFRenderer.udf_fn``,
    f32 on the CPU) on JAX's init of the DTU net, moved as ``net`` moves
    the port's, and converted."""
    conf = str(CONFS / "udf_dtu_blending.conf")
    jmodel = jconfig.load(conf).model
    p_j = jf.init_distance_field(jax.random.PRNGKey(seed), jmodel.udf_network)
    rng = np.random.RandomState(seed)
    p_j = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * float(np.sqrt(np.mean(np.square(a))))
        * rng.randn(*a.shape).astype(np.float32), p_j)
    cfg = udf_cfg()
    params = convert.params_from_jax(p_j)
    x = points(ROWS, seed)
    ref = torch.tensor(np.asarray(
        jrenderer.UDFRenderer(jmodel).udf_fn({"udf": p_j})(jnp.asarray(x.numpy()))))
    with torch.no_grad():
        got = fd.explicit_value(x, params, cfg)
        cpu_pass = fd.sampling_distance_fn(params, cfg)(x)
    assert max_rel(got, ref) < TOL_F32
    assert max_rel(cpu_pass, ref) < TOL_JAX


@pytest.mark.parametrize("seed", [0, 1])
def test_explicit_version_is_at_least_as_precise_as_the_bf16_chain(seed, monkeypatch):
    cfg, params, x = udf_cfg(), net(seed), points(ROWS, seed)
    ref = fields.distance_value({k: {n: t.double() for n, t in p.items()}
                                 for k, p in params.items()}, x.double(), cfg)[:, 0]
    monkeypatch.setattr(tmlp, "_matmul", bf16_chain)
    chain = fields.distance_value(params, x, cfg, role="sampling")[:, 0]
    got = fd.explicit_value(x, params, cfg)
    assert rms_rel(got, ref) <= TOL_PRECISION_RATIO * rms_rel(chain, ref)


@pytest.mark.parametrize("conf", ["udf_dtu_blending.conf", "udf_dtu_blending_ft.conf",
                                  "udf_garment_blending.conf", "synthetic_smoke.conf"])
def test_the_gate_takes_the_published_nets_on_cuda(conf):
    cfg = udf_cfg(conf)
    assert fd.value_kernel_takes(cfg, torch.device("cuda"))
    assert fd.value_kernel_takes(cfg, "cuda:1")
    assert not fd.value_kernel_takes(cfg, torch.device("cpu"))


@pytest.mark.parametrize("change", [
    dict(d_hidden=128), dict(multires=11), dict(n_layers=17), dict(skip_in=(8,)),
    dict(skip_in=(0,)), dict(d_out=1), dict(d_out=400), dict(d_in=4), dict(udf_type="other"),
    dict(fused_core="off"),
])
def test_the_gate_refuses_other_nets_and_fused_core_off(change):
    import dataclasses

    cfg = dataclasses.replace(udf_cfg(), **change)
    assert not fd.value_kernel_takes(cfg, torch.device("cuda"))


def test_the_gate_refuses_the_f32_sampling_policy(monkeypatch):
    """The benchmark's f32 witness sets every role's policy to "highest"."""
    monkeypatch.setitem(tmlp.PRECISION_POLICY, "sampling", "highest")
    assert not fd.value_kernel_takes(udf_cfg(), torch.device("cuda"))


def test_value_layers_takes_the_field_tree_and_refuses_another():
    """The field's leaves as they are (a strided one as a contiguous copy
    of it); ValueError for a leaf of another dtype, shape or device, and for
    a tree of other layers or leaves."""
    cfg, params = udf_cfg(), net(0)
    layers = fd.value_layers(params, cfg, torch.device("cpu"))
    assert len(layers) == cfg.n_layers + 1
    assert all(v is params[f"lin{l}"]["v"] and g is params[f"lin{l}"]["g"]
               and b is params[f"lin{l}"]["b"] for l, (v, g, b) in enumerate(layers))
    plain = {k: {"w": tmlp.weight(p), "b": p["b"]} for k, p in params.items()}
    assert all(g is None for _, g, _ in fd.value_layers(plain, cfg, "cpu"))
    strided = {k: dict(p) for k, p in params.items()}
    strided["lin3"]["v"] = params["lin3"]["v"].t().contiguous().t()
    v3 = fd.value_layers(strided, cfg, "cpu")[3][0]
    assert v3.is_contiguous() and torch.equal(v3, params["lin3"]["v"])
    with pytest.raises(ValueError, match="lin0.v: need a contiguous float32 tensor on cuda"):
        fd.value_layers(params, cfg, torch.device("cuda"))  # another device
    for bad, match in ((lambda v: v.double(), "lin3.v: need a contiguous float32"),
                       (lambda v: v[:-1], "lin3.v: expected shape"),
                       (lambda v: v.t().contiguous(), "lin3.v: expected shape")):
        tree = {k: dict(p) for k, p in params.items()}
        tree["lin3"]["v"] = bad(params["lin3"]["v"])
        with pytest.raises(ValueError, match=match):
            fd.value_layers(tree, cfg, "cpu")
    with pytest.raises(ValueError, match="lin8: expected the leaves"):
        fd.value_layers({k: p for k, p in params.items() if k != "lin8"}, cfg, "cpu")
    both = {k: dict(p) for k, p in params.items()}
    both["lin0"]["w"] = both["lin0"]["v"]
    with pytest.raises(ValueError, match="lin0: expected the leaves"):
        fd.value_layers(both, cfg, "cpu")


def test_the_launchers_refuse_cpu_tensors_and_count_nothing():
    cfg, params = udf_cfg(), net(0)
    lay = fd.layout_for(cfg)
    before = fd.value_pack.launches, fd.fused_value.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fd.value_pack(fd.value_layers(params, cfg, "cpu"), lay)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fd.fused_value(points(16, 0), torch.empty(0, dtype=torch.uint8), lay)
    assert (fd.value_pack.launches, fd.fused_value.launches) == before


def render_inputs(n_rays: int, seed: int):
    gen = torch.Generator().manual_seed(200 + seed)
    rays_d = torch.randn(n_rays, 3, generator=gen)
    rays_d = rays_d / rays_d.norm(dim=1, keepdim=True)
    rays_o = -1.6 * rays_d + 0.2 * torch.randn(n_rays, 3, generator=gen)
    z_vals = 0.4 + 2.4 * torch.linspace(0.0, 1.0, 64)[None, :].expand(n_rays, 64).contiguous()
    return rays_o, rays_d, z_vals, torch.tensor(2.4 / 64)


def importance(kind: str, udf_fn, rcfg, rays):
    if kind == "classical":
        return sampling.importance_sample_classical(
            udf_fn, *rays, n_importance=rcfg.n_importance, up_sample_steps=rcfg.up_sample_steps)
    beta, gamma = torch.tensor([40.0]), torch.tensor([60.0])
    return sampling.importance_sample_mix(
        udf_fn, *rays, beta, gamma, n_importance=rcfg.n_importance,
        up_sample_steps=rcfg.up_sample_steps)


@pytest.mark.parametrize("conf,kind", [("udf_dtu_blending.conf", "classical"),
                                       ("udf_garment_blending.conf", "mix")])
def test_the_cpu_path_is_the_parents_chain_bit_for_bit(conf, kind):
    """On the CPU ``udf_fn`` and the importance samplers through it are the
    parent's (``distance_value`` at the "sampling" role) bit for bit;
    nothing launches and no counter moves."""
    model = tconfig.load(str(CONFS / conf)).model
    params = {"udf": net(3, model.udf_network)}
    parent_fn = lambda pts: fields.distance_value(params["udf"], pts, model.udf_network,
                                                  role="sampling")[:, 0]
    rays = render_inputs(48, 3)
    before = fd.value_pack.launches, fd.fused_value.launches
    trace.reset()
    trace.enable()
    try:
        udf_fn = trenderer.UDFRenderer(model).udf_fn(params)
        x = points(777, 3)
        assert torch.equal(udf_fn(x), parent_fn(x))
        z = importance(kind, udf_fn, model.udf_renderer, rays)
        counts = trace.snapshot()["counts"]
    finally:
        trace.disable()
        trace.reset()
    assert torch.equal(z, importance(kind, parent_fn, model.udf_renderer, rays))
    assert "op.fd_value" not in counts and "fd_value.plain" not in counts
    assert (fd.value_pack.launches, fd.fused_value.launches) == before


class ExplicitLaunchers:
    """K5's launchers replaced by the explicit version, with the gate open
    on the CPU: the calls the CUDA path would make."""

    def __init__(self, monkeypatch, params, cfg):
        self.packs, self.passes = 0, []
        monkeypatch.setattr(fd, "value_kernel_takes", lambda c, device: True)
        monkeypatch.setattr(fd, "value_pack", self.pack)
        monkeypatch.setattr(fd, "fused_value", self.value)
        self.params, self.cfg = params, cfg

    def pack(self, layers, lay):
        self.packs += 1
        return torch.empty(0, dtype=torch.uint8)

    def value(self, x, packed, lay):
        self.passes.append(x.shape[0])
        return fd.explicit_value(x, self.params, self.cfg)


@pytest.mark.parametrize("conf,kind,passes", [
    ("udf_dtu_blending.conf", "classical", [48 * 64] + [48 * 10] * 4),
    ("udf_garment_blending.conf", "mix", [48 * 64] + [48 * 13] * 5)])
def test_one_pack_a_render_and_one_launch_a_pass(conf, kind, passes, monkeypatch):
    """Where the gate takes the net: the weights packed once at the first
    pass, K5 once a pass (a DTU render's 64 + 4 x 10 samples a ray, a
    garment render's 64 + 5 x 13), each counted as ``op.fd_value``; the
    samples those of the same rounds on the explicit version's values."""
    model = tconfig.load(str(CONFS / conf)).model
    params = {"udf": net(4, model.udf_network)}
    fake = ExplicitLaunchers(monkeypatch, params["udf"], model.udf_network)
    rays = render_inputs(48, 4)
    trace.reset()
    trace.enable()
    try:
        z = importance(kind, trenderer.UDFRenderer(model).udf_fn(params), model.udf_renderer,
                       rays)
        counts = trace.snapshot()["counts"]
    finally:
        trace.disable()
        trace.reset()
    assert fake.packs == 1 and fake.passes == passes
    assert counts.get("op.fd_value") == len(passes) and "fd_value.plain" not in counts
    want = importance(kind, lambda pts: fd.explicit_value(pts, params["udf"], model.udf_network),
                      model.udf_renderer, rays)
    assert torch.equal(z, want)


@pytest.mark.parametrize("leaf,match", [("g", "lin2.g: need a contiguous float32"),
                                         ("b", "lin2.b: expected shape")])
def test_a_tree_the_kernel_cannot_read_raises(leaf, match, monkeypatch):
    """The gate open: a leaf K5 cannot read raises at the first pass, with
    no pack, no launch and no plain chain in its place; a strided leaf is
    packed from a contiguous copy."""
    cfg = udf_cfg()
    params = net(5)
    bad = {k: dict(p) for k, p in params.items()}
    bad["lin2"][leaf] = bad["lin2"][leaf].double() if leaf == "g" else bad["lin2"][leaf][:-1]
    fake = ExplicitLaunchers(monkeypatch, params, cfg)
    x = points(300, 5)
    with pytest.raises(ValueError, match=match):
        fd.sampling_distance_fn(bad, cfg)(x)
    assert fake.packs == 0 and fake.passes == []
    strided = {k: dict(p) for k, p in params.items()}
    strided["lin2"]["v"] = params["lin2"]["v"].t().contiguous().t()
    got = fd.sampling_distance_fn(strided, cfg)(x)
    assert fake.packs == 1 and fake.passes == [300]
    assert torch.equal(got, fd.explicit_value(x, params, cfg))


@pytest.mark.card
def test_k5_matches_its_plain_versions_on_the_card():
    """``chip_smoke.check_value`` (it raises where K5 leaves ``TOL_VALUE``
    from the explicit version, the bf16 chain or the f32 chain, is further
    from the f32 chain than the bf16 chain, or two graph replays differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    out = chip_smoke.check_value(torch.device("cuda:0"))
    assert all(out[n]["capture_launches"] == {"K5": 1, "K5p": 1} for n in chip_smoke.VALUE_ROWS)
