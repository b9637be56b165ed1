"""``scripts/torch_benchmark_lobed.py`` against ``scripts/benchmark_lobed.py``:
its stage configurations against the JAX script's, its cleaning and scoring
functions against the JAX script's steps applied in the same order to the
same mesh and scene (the same Chamfer distance and F-scores to 1e-6
relative; measured equal), and its ``main`` end to end on the CPU at a tiny
size, which writes a results line with the JAX script's keys."""

import ast
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
from neuraludf_tpu.mesh.ply import export_ply as j_export_ply
from neuraludf_tpu.mesh.ply import load_ply as j_load_ply
from neuraludf_tpu_torch.data import synthetic as tsynthetic
from neuraludf_tpu_torch.mesh import mc as tmc
from neuraludf_tpu_torch.mesh.ply import export_ply

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import torch_benchmark_lobed as lobed  # noqa: E402

TOL_SCORE = 1e-6  # relative, Chamfer and F-scores
N_GT, OBS_RES = 20_000, 0.05  # the protocol's 400k points and 0.01 voxel, cut for the CPU


def jax_row_keys(script: str) -> list:
    """The keys of the ``row`` dict the JAX script writes."""
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "row" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no row dict in {script}")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the training steps here are many small ops, and
    with one thread a core for each of several test processes at once they
    wait on each other's cores (10x slower, measured with two)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lobed") / "scene"
    lobed.build_scene(str(d), n_views=6, H=40, W=48)
    return str(d)


def lobed_mesh(path):
    """The lobed shell by marching cubes at 40³, the faces with x > 0.2 (a
    quarter of its area keeps the CPU's scoring short), and a small stray
    component the outlier removal drops."""
    xs = np.linspace(-1, 1, 40, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    verts, faces = tmc.marching_cubes_classic(tsynthetic._lobed_f(g), 0.0)
    verts = verts * (2.0 / 39) - 1.0
    faces = faces[verts[faces].mean(axis=1)[:, 0] > 0.2]
    stray = np.array([[0.0, 0.0, 0.0], [0.02, 0.0, 0.0], [0.0, 0.02, 0.0]], np.float32)
    export_ply(str(path), np.concatenate([verts, stray]),
               np.concatenate([faces, [[len(verts), len(verts) + 1, len(verts) + 2]]])
               .astype(np.int32))
    return str(path)


def test_configs_match_jax_script(tmp_path, scene_dir):
    """The stage-1 and finetune configurations the JAX script builds, field
    for field, with the flags' values."""
    exp_dir = str(tmp_path / "exp")
    cfg = lobed.stage1_config(exp_dir, scene_dir, iters=1234, batch_size=256,
                              sparse_weight=0.002, fused="off", precision="high")
    ft = lobed.finetune_config(cfg, 777, blend_top_k=16)
    # the JAX script's steps (it reads the scene from the conf's relative
    # data_dir and sets fused_core/precision by environment variables)
    j = jconfig.load(str(ROOT / "confs" / "synthetic_smoke.conf"), case="lobed")
    j = dataclasses.replace(
        j, general=dataclasses.replace(j.general, base_exp_dir=exp_dir),
        train=dataclasses.replace(j.train, end_iter=1234, batch_size=256, sparse_weight=0.002,
                                  save_freq=25_000, val_freq=10**9, val_mesh_freq=10**9,
                                  report_freq=1000))
    j_ft = dataclasses.replace(
        j, train=dataclasses.replace(j.train, end_iter=777, learning_rate=1e-4,
                                     learning_rate_geo=1e-4, fix_geo_end=500,
                                     warm_up_end=min(5000, 777 // 10),
                                     anneal_end=min(25_000, 777 // 2)),
        color_loss=jconfig.ColorLossConfig(
            color_base_weight=0.01, color_weight=1.0, color_pixel_weight=0.1,
            color_patch_weight=0.1, pixel_loss_type="l1", patch_loss_type="ssim",
            h_patch_size=5),
        model=dataclasses.replace(j.model, udf_renderer=dataclasses.replace(
            j.model.udf_renderer, h_patch_size=5, blend_top_k=16)))
    for port, jax_cfg in ((cfg, j), (ft, j_ft)):
        p, q = dataclasses.asdict(port), dataclasses.asdict(jax_cfg)
        assert p["dataset"].pop("data_dir") == scene_dir
        assert q["dataset"].pop("data_dir") == "./data/synthetic/lobed/"
        assert (p["model"]["udf_network"].pop("fused_core"),
                p["model"]["udf_network"].pop("fused_precision")) == ("off", "high")
        for key in ("fused_core", "fused_precision"):
            q["model"]["udf_network"].pop(key)
        assert p == q


def test_cleaning_and_scoring_match_jax_steps(tmp_path, scene_dir):
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
    raw = lobed_mesh(tmp_path / "port" / "raw.ply")
    raw_j = str(tmp_path / "jax" / "raw.ply")
    shutil.copy(raw, raw_j)

    # the protocol's voxel is the JAX script's constant (cut to OBS_RES here)
    assert (f"lobed_observability_mask(res={lobed.OBS_RES})"
            in (ROOT / "scripts" / "benchmark_lobed.py").read_text())
    final, _ = lobed.clean(raw, scene_dir)
    r, n_verts = lobed.score(final, str(tmp_path / "port" / "vis"), n_gt=N_GT, obs_res=OBS_RES)

    # scripts/benchmark_lobed.py's steps, in its order
    mesh_mask = jclean.clean_mesh_faces_by_mask(raw_j, raw_j.replace(".ply", "_cleanmask.ply"),
                                                scene_dir, minimal_vis=2, mask_dilated_size=11)
    mesh_hull = jclean.clean_mesh_faces_by_visualhull(
        mesh_mask, raw_j.replace(".ply", "_cleanhull.ply"), scene_dir, mask_dilated_size=11,
        border=20)
    mesh_final = jclean.clean_outliers(mesh_hull, raw_j.replace(".ply", "_final.ply"),
                                       faces_num=500, keep_largest=False)
    verts, faces = j_load_ply(mesh_final)
    mm_ply = raw_j.replace(".ply", "_final_mm.ply")
    j_export_ply(mm_ply, verts * lobed.MM_SCALE, faces)
    gt_mm = jsynthetic.gt_surface_points("lobed", n=N_GT).astype(np.float64) * lobed.MM_SCALE
    obs, bb, res = jsynthetic.lobed_observability_mask(res=OBS_RES)
    rj = jchamfer.eval_mesh(mm_ply, gt_mm, downsample_density=0.2, max_dist=20.0,
                            obs_mask=(obs, bb * lobed.MM_SCALE, res * lobed.MM_SCALE),
                            vis_out_dir=str(tmp_path / "jax" / "vis"), scan=0)

    assert n_verts == len(verts) > 100
    for key in ("chamfer", "mean_d2s", "mean_s2d", "fscore_1", "fscore_2", "precision_1",
                "recall_1"):
        a, b = getattr(r, key), getattr(rj, key)
        assert abs(a - b) <= TOL_SCORE * abs(b), key
    assert 0 < r.chamfer < 5.0 and r.fscore_2 > 0.3  # mm: the shell itself, at 40³
    for name in ("vis_000_d2gt.ply", "vis_000_gt2d.ply"):
        assert ((tmp_path / "port" / "vis" / name).read_bytes()
                == (tmp_path / "jax" / "vis" / name).read_bytes())


def test_main_end_to_end_writes_the_jax_results_line(tmp_path, scene_dir, monkeypatch):
    """Stage 1 and the blending finetune (5 + 5 iterations: the reg-weights
    schedule divides by end_iter // 5, in both packages), validation, the
    32³ extraction, the cleaning and the score, on the CPU. The world is
    scaled x20 here, not x200: the lattice sampling at 0.2 mm then has 100x
    fewer points (the scoring test holds the protocol's own scale)."""
    original = lobed.score
    monkeypatch.setattr(lobed, "score",
                        lambda *a, **k: original(*a, **dict(k, n_gt=N_GT, obs_res=OBS_RES)))
    monkeypatch.setattr(lobed, "MM_SCALE", 20.0)
    exp_root = tmp_path / "exp"
    row = lobed.main(["--tag", "tiny", "--iters", "5", "--ft_iters", "5", "--resolution", "32",
                      "--batch_size", "32", "--device", "cpu", "--scene", scene_dir,
                      "--exp_root", str(exp_root)])
    assert list(row) == jax_row_keys("benchmark_lobed.py")
    lines = (exp_root / "benchmark_lobed" / "results.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == [row]
    assert (row["iters"], row["ft_iters"], row["resolution"]) == (5, 5, 32)
    assert np.isfinite(row["chamfer_mm"]) and row["n_verts_final"] > 0 and row["train_s"] > 0


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device|none is available"):
        lobed.main(["--tag", "x"])
