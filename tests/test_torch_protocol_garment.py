"""``scripts/torch_benchmark_garment.py`` against ``scripts/benchmark_garment.py``:
its stage configurations against the JAX script's (the finetune's learning
rates read from ``confs/udf_garment_blending_ft.conf``), its DF3D scoring
against the JAX script's steps applied in the same order to the same mesh
and scene (the same Chamfer distance and F-scores, raw and after the visual
hull, to 1e-6 relative; measured equal), and its ``main`` end to end on the
CPU at a tiny size, which writes a results line with the JAX script's
keys."""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.data import synthetic as jsynthetic
from neuraludf_tpu.eval import chamfer as jchamfer
from neuraludf_tpu.eval import clean_mesh as jclean
from neuraludf_tpu_torch.data import synthetic as tsynthetic
from neuraludf_tpu_torch.mesh import mc as tmc
from neuraludf_tpu_torch.mesh.ply import export_ply

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import torch_benchmark_garment as garment  # noqa: E402
from test_torch_protocol_lobed import few_threads, jax_row_keys  # noqa: E402,F401

TOL_SCORE = 1e-6  # relative, Chamfer and F-scores
N_GT = 20_000  # the protocol's 400k points, cut for the CPU


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("garment") / "scene"
    garment.build_scene(str(d), n_views=4, H=40, W=48)
    return str(d)


def garment_patch(path):
    """A band of the drape sheet by marching cubes at 48³ (y in [0, 0.15],
    x > 0: the DF3D sampling at 0.002 stays short on the CPU), written as
    PLY."""
    xs = np.linspace(-1, 1, 48, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    verts, faces = tmc.marching_cubes_classic(tsynthetic._garment_f(g), 0.0)
    verts = verts * (2.0 / 47) - 1.0
    c = verts[faces].mean(axis=1)
    faces = faces[(c[:, 1] > 0.0) & (c[:, 1] < 0.15) & (c[:, 0] > 0.0)]
    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    export_ply(str(path), verts[used], remap[faces].astype(np.int32))
    return str(path)


@pytest.mark.parametrize("ft_blend,gate", [(False, 0.0), (True, 0.01)])
def test_configs_match_jax_script(tmp_path, scene_dir, ft_blend, gate):
    exp_dir = str(tmp_path / "exp")
    cfg = garment.stage1_config(exp_dir, scene_dir, iters=1234, batch_size=256,
                                sparse_weight=0.003, freeze_variance=True, fused="on",
                                precision="highest")
    ft = garment.finetune_config(cfg, 777, ft_blend=ft_blend, sparse_depth_gate=gate)
    # scripts/benchmark_garment.py's steps
    j = jconfig.load(str(ROOT / "confs" / "udf_garment_blending.conf"), case="garment")
    j = dataclasses.replace(
        j, general=dataclasses.replace(j.general, base_exp_dir=exp_dir),
        dataset=dataclasses.replace(j.dataset, data_dir=scene_dir,
                                    render_cameras_name="cameras.npz",
                                    object_cameras_name="cameras.npz"),
        train=dataclasses.replace(j.train, end_iter=1234, batch_size=256, save_freq=25_000,
                                  val_freq=10**9, val_mesh_freq=10**9, report_freq=1000,
                                  sparse_weight=0.003, freeze_variance=True))
    ft_color, ft_model = j.color_loss, j.model
    if ft_blend:
        ft_color = dataclasses.replace(j.color_loss, color_pixel_weight=0.1,
                                       color_patch_weight=0.1, h_patch_size=5)
        ft_model = dataclasses.replace(j.model, udf_renderer=dataclasses.replace(
            j.model.udf_renderer, h_patch_size=5))
    if gate:
        ft_model = dataclasses.replace(ft_model, udf_renderer=dataclasses.replace(
            ft_model.udf_renderer, sparse_depth_gate=gate))
    j_ft = dataclasses.replace(
        j, color_loss=ft_color, model=ft_model,
        train=dataclasses.replace(j.train, end_iter=777, learning_rate=5e-5,
                                  learning_rate_geo=5e-5, same_lr=True,
                                  warm_up_end=min(5000, 777 // 10),
                                  anneal_end=min(25_000, 777 // 2)))
    for port, jax_cfg in ((cfg, j), (ft, j_ft)):
        p, q = dataclasses.asdict(port), dataclasses.asdict(jax_cfg)
        assert (p["model"]["udf_network"].pop("fused_core"),
                p["model"]["udf_network"].pop("fused_precision")) == ("on", "highest")
        for key in ("fused_core", "fused_precision"):
            q["model"]["udf_network"].pop(key)
        assert p == q
    r = cfg.model.udf_renderer
    assert (r.n_samples, r.n_importance, r.n_outside, r.upsampling_type) == (64, 80, 0, "mix")


def test_scoring_matches_jax_steps(tmp_path, scene_dir):
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
    raw = garment_patch(tmp_path / "port" / "raw.ply")
    raw_j = str(tmp_path / "jax" / "raw.ply")
    shutil.copy(raw, raw_j)

    r, rc = garment.score(raw, scene_dir, str(tmp_path / "port" / "vis"), n_gt=N_GT)

    # scripts/benchmark_garment.py's steps, in its order
    gt = jsynthetic.gt_surface_points("garment", n=N_GT).astype(np.float64)
    rj = jchamfer.eval_mesh(raw_j, gt, downsample_density=0.002, max_dist=0.1, thresh1=0.001,
                            thresh2=0.002, vis_out_dir=str(tmp_path / "jax" / "vis"), scan=0)
    cleaned = raw_j.replace(".ply", "_vhull.ply")
    jclean.clean_mesh_faces_by_visualhull(raw_j, cleaned, scene_dir, mask_dilated_size=11,
                                          border=0)
    rcj = jchamfer.eval_mesh(cleaned, gt, downsample_density=0.002, max_dist=0.1,
                             thresh1=0.001, thresh2=0.002, vis_out_dir=None, scan=0)

    for a_r, b_r in ((r, rj), (rc, rcj)):
        for key in ("chamfer", "mean_d2s", "mean_s2d", "fscore_1", "fscore_2", "precision_1",
                    "recall_1"):
            a, b = getattr(a_r, key), getattr(b_r, key)
            assert abs(a - b) <= TOL_SCORE * abs(b), key
    assert 0 < r.mean_d2s < 0.01 and r.precision_2 > 0.05  # on the sheet, to 48³'s accuracy
    assert ((tmp_path / "port" / "raw_vhull.ply").read_bytes()
            == (tmp_path / "jax" / "raw_vhull.ply").read_bytes())


def test_main_end_to_end_writes_the_jax_results_line(tmp_path, scene_dir, monkeypatch):
    """Stage 1 (5 iterations: the reg-weights schedule divides by
    end_iter // 5, in both packages), the garment finetune (2), validation
    and ray statistics, the 32³ extraction and both scores, on the CPU. The
    mesh is sampled every 0.02, not 0.002: 100x fewer points (the scoring
    test holds the protocol's own density)."""
    original = garment.score
    monkeypatch.setattr(garment, "score", lambda *a, **k: original(*a, **dict(k, n_gt=N_GT)))
    monkeypatch.setitem(garment.DF3D, "downsample_density", 0.02)
    exp_root = tmp_path / "exp"
    row = garment.main(["--tag", "tiny", "--iters", "5", "--ft_iters", "2", "--resolution",
                        "32", "--batch_size", "32", "--device", "cpu", "--scene", scene_dir,
                        "--exp_root", str(exp_root)])
    assert list(row) == jax_row_keys("benchmark_garment.py")
    lines = (exp_root / "benchmark_garment" / "results.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == [row]
    assert (row["iters"], row["ft_iters"], row["resolution"]) == (5, 2, 32)
    assert np.isfinite(row["chamfer_e-3"]) and row["n_verts"] > 0 and row["train_s"] > 0
    assert (exp_root / "benchmark_garment" / "tiny" / "udf_garment" / "ray_statis").is_dir()


def test_resume_continues_stage_one(tmp_path, scene_dir, monkeypatch):
    """--resume (the JAX script's is_continue) loads the newest stage-1
    checkpoint under the tag's directory before training on."""
    from neuraludf_tpu_torch.train import runner as runner_mod

    seen = {}

    class Stop(Exception):
        pass

    def recorder(cfg, mode="train", **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(runner_mod, "Runner", recorder)
    with pytest.raises(Stop):
        garment.main(["--tag", "r", "--resume", "--device", "cpu", "--scene", scene_dir,
                      "--exp_root", str(tmp_path)])
    assert seen["is_continue"] and seen["reg_weights_schedule"] and seen["seed"] == 0


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device|none is available"):
        garment.main(["--tag", "x"])
