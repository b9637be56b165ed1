"""The frozen plain reference held to the port's eager step on the CPU, and
the frozen scene generators to the port's, at tiny sizes. These tests
import both; the reference itself imports nothing of the port."""

import ast
import dataclasses

import numpy as np
import pytest
import torch

from conftest import HERE, tiny_conf
from harness import check, scene, session
import models
from reference import config as ref_config
from reference.dataset import load_scene
from reference.renderer import UDFRenderer as RefRenderer
from reference.step import build_step_body as ref_body

torch.set_num_threads(2)


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "neuraludf_tpu",
                                               "neuraludf_tpu_torch", "harness"), (path, n)


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    spec = {"kind": "sphere", "views": 12, "height": 30, "width": 40, "focal": 45}
    out, _ = scene.ensure_scene(spec, tmp_path_factory.mktemp("scenes"))
    return out


@pytest.mark.parametrize("kind, focal", [("sphere", 45.0), ("garment", 40 / 1.1547)])
def test_frozen_scene_writes_the_ports_pixels(tmp_path, kind, focal):
    from neuraludf_tpu_torch.data.png import read_png
    from neuraludf_tpu_torch.data.synthetic import generate_scene

    scene.generate_scene(str(tmp_path / "a"), kind=kind, n_views=3, H=30, W=40, focal=focal)
    generate_scene(str(tmp_path / "b"), kind=kind, n_views=3, H=30, W=40, focal=focal)
    for sub in ("image", "mask"):
        for i in range(3):
            a = read_png(str(tmp_path / "a" / sub / f"{i:03d}.png"))
            b = read_png(str(tmp_path / "b" / sub / f"{i:03d}.png"))
            assert np.array_equal(a, b)
    ca, cb = np.load(tmp_path / "a" / "cameras.npz"), np.load(tmp_path / "b" / "cameras.npz")
    assert sorted(ca.files) == sorted(cb.files)
    for k in ca.files:
        assert np.array_equal(ca[k], cb[k])


def test_reference_scene_equals_the_ports(tiny_scene):
    from neuraludf_tpu_torch import config as port_config
    from neuraludf_tpu_torch.data.dataset import Dataset

    conf = tiny_conf("t")
    path = tiny_scene.parent / "t.conf"
    path.write_text(conf)
    cfg = port_config.load(str(path), **session.overrides(str(tiny_scene), str(tiny_scene)))
    port = Dataset(cfg.dataset, "cpu").scene
    ref = load_scene(str(tiny_scene), [3], "cpu", sources=8)
    loaded = {3} | set(port["ref_src_pairs"][3][:8].tolist())
    for key in ("intrinsics", "intrinsics_inv", "poses", "ref_src_pairs"):
        assert torch.equal(port[key], ref[key]), key
    for v in loaded:
        assert torch.equal(port["images"][v], ref["images"][v])
        assert torch.equal(port["masks"][v], ref["masks"][v])


@pytest.mark.parametrize("finetune, kind", [(False, "classical"), (True, "classical"),
                                             (False, "mix")])
def test_reference_step_is_the_ports_eager_step(tiny_scene, tmp_path, finetune, kind):
    """Three steps of each from the same seeded weights on the same draws,
    views and schedules: the same losses, moments and parameters."""
    from neuraludf_tpu_torch import config as port_config
    from neuraludf_tpu_torch.data.dataset import Dataset
    from neuraludf_tpu_torch.render.renderer import UDFRenderer
    from neuraludf_tpu_torch.train.optim import init_adam_state
    from neuraludf_tpu_torch.train.schedules import compute_step_schedules, schedule_rows
    from neuraludf_tpu_torch.train.step import build_step_body

    path = tmp_path / "c.conf"
    path.write_text(tiny_conf("c", finetune=finetune, up=kind, outside=0 if kind == "mix" else 4,
                              norm=kind == "mix"))
    ov = session.overrides(str(tmp_path), str(tiny_scene))
    pcfg, rcfg = port_config.load(str(path), **ov), ref_config.load(str(path), **ov)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    model = models.load(models.DEFAULT)
    w = model.init_weights(rcfg, 1234567890123, "cpu")
    own = lambda: {p: t.clone().requires_grad_(True) for p, t in check.flat_leaves(w)}
    pp, rp = _tree(own()), _tree(own())
    po, ro = init_adam_state(pp), init_adam_state(rp)
    draws = model.make_draws(rcfg, (12, 30, 40), 3, 77, "cpu")
    idxs = session.image_indices(12, 0, 3)
    c = rcfg.color_loss
    rows = torch.as_tensor(schedule_rows([compute_step_schedules(
        j, pcfg.train, c.color_base_weight, c.color_weight, c.color_pixel_weight,
        c.color_patch_weight, is_finetune=finetune, reg_weights_schedule=False,
        same_lr=pcfg.train.same_lr, beta_trainable=True, variance_trainable=True)
        for j in range(3)]))
    pscene = Dataset(pcfg.dataset, "cpu").scene
    rscene = load_scene(str(tiny_scene), idxs, "cpu", sources=8)
    pb = build_step_body(pcfg, UDFRenderer(pcfg.model), blending=finetune)
    rb = ref_body(rcfg, RefRenderer(rcfg.model), blending=finetune)
    for j in range(3):
        mp = pb(pp, po, pscene, int(idxs[j]), rows[j], noise=dict(draws[j]))
        mr = rb(rp, ro, rscene, int(idxs[j]), rows[j], noise=dict(draws[j]))
        assert float(mp["loss"]) == float(mr["loss"])
        if finetune:
            assert float(mr["color_patch_loss"]) != 0.0 and float(mr["color_pixel_loss"]) != 0.0
    for (path_, a), (_, b) in zip(check.flat_leaves(pp), check.flat_leaves(rp)):
        assert torch.equal(a, b), path_
    for (path_, a), (_, b) in zip(check.flat_leaves(po), check.flat_leaves(ro)):
        assert torch.equal(a, b), path_


def _tree(flat):
    out = {}
    for path, t in flat.items():
        check.put(out, path, t)
    return out


def test_seeded_weights_fit_the_ports_tree_at_the_published_widths():
    from neuraludf_tpu_torch import config as port_config
    from neuraludf_tpu_torch.train.runner import init_params

    for conf in ("dtu.conf", "garment.conf"):
        cfg = port_config.load(str(HERE / "configs" / conf))
        port = dict(check.flat_leaves(init_params(torch.Generator().manual_seed(0), cfg)))
        mine = dict(check.flat_leaves(models.load(models.DEFAULT).init_weights(
            ref_config.load(str(HERE / "configs" / conf)), 2**31 + 5, "cpu")))
        assert port.keys() == mine.keys()
        for k in port:
            assert port[k].shape == mine[k].shape, k
            if k[-1] == "g":  # weight norm starts at g = ||v||
                v = mine[k[:-1] + ("v",)]
                assert torch.allclose(mine[k], torch.linalg.vector_norm(v, dim=0))
        # the geometric init: layer 0 reads xyz alone, the head's bias is -0.5
        assert torch.count_nonzero(mine[("udf", "lin0", "v")][3:]) == 0
        assert torch.all(mine[("udf", "lin8", "b")] == -0.5)
        assert torch.count_nonzero(mine[("udf", "lin4", "v")][-36:]) == 0
