"""The port runner's mesh modes and the CLI's, on the CPU at a tiny size:
``validate_mesh``, ``extract_udf_mesh`` and ``validate_fields`` write their
files under the JAX runner's names, the fields grid equals the JAX
package's ``extract_fields`` on the same parameters (atol 1e-5: f32 on both
sides, matmuls summed in another order), the periodic hooks fire on every
multiple of ``val_mesh_freq`` and the CLI's train mode ends in the closing
extraction."""

import os

import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.mesh import grid as jgrid
from neuraludf_tpu.train import runner as jrunner
from neuraludf_tpu_torch import cli as tcli
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.data.synthetic import generate_scene
from neuraludf_tpu_torch.mesh.ply import load_ply
from neuraludf_tpu_torch.train import runner as trunner

RES = 24


def raw_config(scene_dir, exp_dir, end_iter=2, val_mesh_freq=1000, incremental=False):
    return {
        "general": {"base_exp_dir": exp_dir, "expname": "mesh"},
        "dataset": {"data_dir": scene_dir, "dataset_name": "general"},
        "train": {"end_iter": end_iter, "batch_size": 16, "warm_up_end": 10,
                  "anneal_end": 20, "fix_geo_end": 2, "save_freq": 1000, "val_freq": 1000,
                  "val_mesh_freq": val_mesh_freq, "report_freq": 1000,
                  "incremental_mesh": incremental},
        "model": {
            "nerf": {"D": 2, "W": 32, "multires": 4, "multires_view": 2, "skips": [0]},
            "udf_network": {"d_out": 17, "d_hidden": 32, "n_layers": 3, "skip_in": [2],
                            "multires": 2},
            "rendering_network": {"d_feature": 16, "d_hidden": 16, "n_layers": 2},
            "udf_renderer": {"n_samples": 8, "n_importance": 4, "n_outside": 4,
                             "up_sample_steps": 2},
        },
    }


def to_hocon(tree, indent=""):
    lines = []
    for key, val in tree.items():
        if isinstance(val, dict):
            lines += [f"{indent}{key} {{", to_hocon(val, indent + "  "), f"{indent}}}"]
        elif isinstance(val, (list, tuple)):
            lines.append(f"{indent}{key} = [{', '.join(str(v) for v in val)}]")
        elif isinstance(val, bool):
            lines.append(f"{indent}{key} = {'True' if val else 'False'}")
        else:
            lines.append(f"{indent}{key} = {val}")
    return "\n".join(lines)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_runner_mesh") / "sphere"
    generate_scene(str(d), kind="sphere", n_views=4, H=40, W=48, focal=64.0)
    return str(d)


def relative(path, root):
    return os.path.relpath(path, root)


def test_mesh_modes_match_jax(scene_dir, tmp_path):
    t_root, j_root = str(tmp_path / "torch"), str(tmp_path / "jax")
    runner = trunner.Runner(tconfig.from_dict(raw_config(scene_dir, t_root)), device="cpu")
    jr = jrunner.Runner(jconfig.from_dict(raw_config(scene_dir, j_root)), seed=0)
    runner.iter_step = jr.iter_step = 7
    calls = [("validate_mesh", dict(resolution=RES, threshold=0.02)),
             ("extract_udf_mesh", dict(resolution=RES, world_space=True,
                                       dist_threshold_ratio=5.0)),
             ("extract_udf_mesh", dict(resolution=RES, algorithm="lewiner")),
             ("validate_fields", dict(resolution=20))]
    for name, kw in calls:
        p_t, p_j = getattr(runner, name)(**kw), getattr(jr, name)(**kw)
        assert relative(p_t, t_root) == relative(p_j, j_root)
        assert os.path.isfile(p_t)
        if p_t.endswith(".ply"):
            assert len(load_ply(p_t)[1]) > 0, p_t
    assert relative(p_t, t_root) == os.path.join("mesh", "fields", "00000007_dist.npy")

    # the fields grid of the port's parameters, through the JAX package
    params_j = {"udf": convert.to_numpy(runner.params["udf"])}
    ref = jgrid.extract_fields(params_j, jr.cfg.model.udf_network, runner.dataset.object_bbox_min,
                               runner.dataset.object_bbox_max, 20)
    np.testing.assert_allclose(np.load(p_t), ref, atol=1e-5, rtol=0)


def test_incremental_cache_per_resolution(scene_dir, tmp_path):
    raw = raw_config(scene_dir, str(tmp_path), incremental=True)
    runner = trunner.Runner(tconfig.from_dict(raw), device="cpu")
    for _ in range(2):
        runner.extract_udf_mesh(resolution=RES)
    runner.extract_udf_mesh(resolution=RES + 1)
    assert sorted(runner._mesh_caches) == [RES, RES + 1]
    assert runner._mesh_caches[RES]["incr_count"] == 1
    assert runner._mesh_caches[RES + 1]["incr_count"] == 0


def test_periodic_mesh_hooks(scene_dir, tmp_path, monkeypatch):
    """validate_mesh, then extract_udf_mesh (world space, threshold ratio 2)
    on every multiple of val_mesh_freq; a failed extraction is logged and
    training goes on."""
    raw = raw_config(scene_dir, str(tmp_path), end_iter=4, val_mesh_freq=2)
    runner = trunner.Runner(tconfig.from_dict(raw), device="cpu")
    calls = []
    monkeypatch.setattr(runner, "validate_mesh", lambda: calls.append(("vm", runner.iter_step)))

    def extract(**kw):
        calls.append(("udf", runner.iter_step, kw))
        raise RuntimeError("extraction failed")

    monkeypatch.setattr(runner, "extract_udf_mesh", extract)
    runner.train()
    assert runner.iter_step == 4
    kw = {"world_space": True, "dist_threshold_ratio": 2.0}
    assert calls == [("vm", 2), ("udf", 2, kw), ("vm", 4), ("udf", 4, kw)]


def test_cli_mesh_modes(scene_dir, tmp_path, monkeypatch):
    """--mode train ends in the closing extraction at
    --final_mesh_resolution; the mesh modes run from the newest checkpoint."""
    monkeypatch.setattr(trunner, "default_device", lambda gpu=0: torch.device("cpu"))
    raw = raw_config(scene_dir, str(tmp_path / "exp"))
    raw["train"]["save_freq"] = 2
    conf = tmp_path / "tiny.conf"
    conf.write_text(to_hocon(raw))
    base = ["--conf", str(conf), "--case", "sphere"]
    tcli.main(base + ["--mode", "train", "--final_mesh_resolution", str(RES)])
    exp = tmp_path / "exp" / "mesh"
    assert (exp / "checkpoints" / "ckpt_000002.ckpt").is_file()
    assert (exp / "udf_meshes" / f"udf_res{RES}_step2.ply").is_file()
    for mode, out in (("extract_udf_mesh", f"udf_meshes/udf_res{RES}_step2_lewiner.ply"),
                      ("validate_udf_mesh", f"udf_meshes/udf_res{RES}_step2_lewiner.ply"),
                      ("validate_mesh", f"meshes/00000002_thresh0.0200_res{RES}.ply"),
                      ("validate_fields", "fields/00000002_dist.npy")):
        (exp / out).unlink(missing_ok=True)
        tcli.main(base + ["--mode", mode, "--is_continue", "--resolution", str(RES),
                          "--mc_algorithm", "lewiner", "--threshold", "0.02"])
        assert (exp / out).is_file(), mode
