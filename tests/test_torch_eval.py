"""The port's mesh evaluation (``neuraludf_tpu_torch/eval``) against
``neuraludf_tpu.eval`` on the CPU. Both are numpy/scipy code over the same
inputs, so every result must be equal: the Chamfer evaluator's numbers and
point clouds, the cleaned meshes' bytes. The port dilates masks with
``scipy.ndimage`` where the JAX package calls OpenCV: held exactly against
``cv2.dilate`` and against a loop over the structuring element."""

import dataclasses
import os
import runpy

import cv2
import numpy as np
import pytest

from neuraludf_tpu.eval import chamfer as jchamfer
from neuraludf_tpu.eval import clean_mesh as jclean
from neuraludf_tpu_torch.data.synthetic import generate_scene, gt_surface_points
from neuraludf_tpu_torch.eval import chamfer as tchamfer
from neuraludf_tpu_torch.eval import clean_mesh as tclean
from neuraludf_tpu_torch.mesh import mc as tmc
from neuraludf_tpu_torch.mesh.ply import export_ply, load_ply


def sphere_mesh(n=32, radius=0.5):
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    verts, faces = tmc.marching_cubes_classic(np.linalg.norm(g, axis=-1) - radius, 0.0)
    return verts * (2.0 / (n - 1)) - 1.0, faces


def mesh_with_outliers(path):
    """A sphere mesh, a small second component outside the sphere's visual
    hull and a stray triangle outside every mask, written as PLY."""
    verts, faces = sphere_mesh()
    small_v, small_f = sphere_mesh(12, 0.8)
    stray = np.array([[-1.2, -1.2, -1.2], [-1.18, -1.2, -1.2], [-1.2, -1.18, -1.2]], np.float32)
    v = np.concatenate([verts, small_v * 0.03 + np.array([0.6, 0.3, 0.3], np.float32), stray])
    stray_f = np.array([[0, 1, 2]]) + len(verts) + len(small_v)
    f = np.concatenate([faces, small_f + len(verts), stray_f])
    export_ply(str(path), v, f.astype(np.int32))
    return str(path)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_eval") / "sphere"
    # six views: the visual-hull cleaner drops what is outside in five
    generate_scene(str(d), kind="sphere", n_views=6, H=40, W=48, focal=64.0)
    return str(d)


def test_sample_and_downsample_match_jax():
    verts, faces = sphere_mesh()
    verts = verts.astype(np.float64)
    pt = tchamfer.sample_mesh_to_pcd(verts, faces, 0.01)
    np.testing.assert_array_equal(pt, jchamfer.sample_mesh_to_pcd(verts, faces, 0.01))
    assert len(pt) > 3 * len(verts)
    down = tchamfer.greedy_downsample(pt, 0.01, seed=3)
    np.testing.assert_array_equal(down, jchamfer.greedy_downsample(pt, 0.01, seed=3))
    assert len(down) < len(pt)


@pytest.mark.parametrize("protocol", ["plain", "obs_mask"])
def test_eval_mesh_matches_jax(tmp_path, protocol):
    path = mesh_with_outliers(tmp_path / "m.ply")
    gt = gt_surface_points("sphere", n=20_000).astype(np.float64)
    kw = dict(downsample_density=0.01, max_dist=0.5, thresh1=0.01, thresh2=0.02)
    if protocol == "obs_mask":
        rng = np.random.RandomState(0)
        obs = rng.rand(20, 20, 20) > 0.2
        kw.update(obs_mask=(obs, np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]), 0.1),
                  ground_plane=np.array([0.0, 1.0, 0.0, 0.3]), patch_size=0.05)
    rt = tchamfer.eval_mesh(path, gt, vis_out_dir=str(tmp_path / "t"), scan=7, **kw)
    rj = jchamfer.eval_mesh(path, gt, vis_out_dir=str(tmp_path / "j"), scan=7, **kw)
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    assert 0 < rt.chamfer < 0.05 and rt.fscore_2 > 0.5
    for name in ("vis_007_d2gt.ply", "vis_007_gt2d.ply"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def dilate_reference(image, element):
    """cv.dilate by definition: the maximum of the pixels under the element
    placed with its centre (k // 2) on each pixel; outside pixels ignored."""
    h, w = image.shape[:2]
    k = element.shape[0]
    c = k // 2
    padded = np.zeros((h + k, w + k) + image.shape[2:], image.dtype)
    padded[c:c + h, c:c + w] = image
    out = np.zeros_like(image)
    for dy, dx in zip(*np.nonzero(element)):
        out = np.maximum(out, padded[dy:dy + h, dx:dx + w])
    return out


@pytest.mark.parametrize("size", [1, 4, 11])
def test_mask_dilation_matches_opencv(size):
    element = tclean.ellipse_element(size)
    np.testing.assert_array_equal(
        element, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size)))
    rng = np.random.RandomState(size)
    image = ((rng.rand(37, 53, 3) > 0.97) * 255).astype(np.uint8)
    image[0, 0], image[-1, -1] = 255, 255  # element reaching past the border
    out = tclean.dilate(image, element)
    np.testing.assert_array_equal(out, dilate_reference(image, element))
    np.testing.assert_array_equal(out, cv2.dilate(image, element, iterations=1))


def test_eval_dtu_entry_matches_script(tmp_path, capsys, monkeypatch):
    """``python -m neuraludf_tpu_torch.eval.eval_dtu`` prints the lines and
    writes the ``eval_result.txt`` of ``scripts/eval_dtu.py``."""
    from neuraludf_tpu_torch.eval import eval_dtu

    rng = np.random.default_rng(0)
    verts = rng.random((60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, (80, 3)).astype(np.int32)
    gt = (rng.random((500, 3)) * 1.1).astype(np.float32)
    outs = {}
    for who in ("scripts", "port"):
        d = tmp_path / who
        d.mkdir()
        export_ply(str(d / "mesh.ply"), verts, faces)
        export_ply(str(d / "gt.ply"), gt, np.zeros((0, 3), np.int32))
        argv = ["--data", str(d / "mesh.ply"), "--gt", str(d / "gt.ply"),
                "--downsample_density", "0.05", "--max_dist", "0.5"]
        if who == "scripts":
            script = os.path.join(os.path.dirname(__file__), "..", "scripts", "eval_dtu.py")
            monkeypatch.setattr("sys.argv", ["eval_dtu.py"] + argv)
            runpy.run_path(script, run_name="__main__")
        else:
            eval_dtu.main(argv)
        outs[who] = (capsys.readouterr().out, (d / "eval_result.txt").read_text())
    assert outs["port"] == outs["scripts"]
    assert outs["port"][0].startswith("over_all: ")


@pytest.mark.parametrize("flags", [[], ["--downsample_density", "0.05", "--max_dist", "0.5",
                                         "--scan", "3"]], ids=["defaults", "flags"])
def test_eval_deepfashion_entry_matches_script(tmp_path, capsys, monkeypatch, flags):
    """``python -m neuraludf_tpu_torch.eval.eval_deepfashion`` prints the
    lines and writes the ``eval_result.txt`` of ``scripts/eval_deepfashion.py``
    (and its error-coloured point clouds), at the DF3D defaults and with
    every flag given."""
    from neuraludf_tpu_torch.eval import eval_deepfashion

    verts, faces = sphere_mesh(24, 0.3)
    gt = gt_surface_points("sphere", n=5_000).astype(np.float32) * 0.61
    outs = {}
    for who in ("scripts", "port"):
        d = tmp_path / who
        d.mkdir()
        export_ply(str(d / "mesh.ply"), verts, faces)
        export_ply(str(d / "gt.ply"), gt, np.zeros((0, 3), np.int32))
        argv = ["--data", str(d / "mesh.ply"), "--gt", str(d / "gt.ply"),
                "--vis_out_dir", str(d / "vis"), "--log", str(d / "log.txt")] + flags
        if who == "scripts":
            script = os.path.join(os.path.dirname(__file__), "..", "scripts",
                                  "eval_deepfashion.py")
            monkeypatch.setattr("sys.argv", ["eval_deepfashion.py"] + argv)
            runpy.run_path(script, run_name="__main__")
        else:
            eval_deepfashion.main(argv)
        outs[who] = (capsys.readouterr().out, (d / "log.txt").read_text(),
                     sorted((p.name, p.read_bytes()) for p in (d / "vis").iterdir()))
    assert outs["port"] == outs["scripts"]
    assert outs["port"][0].startswith("over_all: ") and "fscore_2mm" in outs["port"][0]
    assert len(outs["port"][2]) == 2


def test_clean_dtu_mesh_entry_matches_script(tmp_path, scene_dir, capsys, monkeypatch):
    """``python -m neuraludf_tpu_torch.eval.clean_dtu_mesh`` writes the
    meshes of ``scripts/clean_dtu_mesh.py``, byte for byte."""
    from neuraludf_tpu_torch.eval import clean_dtu_mesh

    mesh = mesh_with_outliers(tmp_path / "m.ply")
    outs = {}
    for who in ("scripts", "port"):
        argv = ["--mesh", mesh, "--data_dir", scene_dir, "--out_dir", str(tmp_path / who),
                "--scan", "7", "--mask_kernel_size", "5", "--keep_largest"]
        if who == "scripts":
            script = os.path.join(os.path.dirname(__file__), "..", "scripts", "clean_dtu_mesh.py")
            monkeypatch.setattr("sys.argv", ["clean_dtu_mesh.py"] + argv)
            runpy.run_path(script, run_name="__main__")
        else:
            clean_dtu_mesh.main(argv)
        printed = capsys.readouterr().out.replace(str(tmp_path / who), "<out>")
        outs[who] = (printed, [(tmp_path / who / f"{k}_007.ply").read_bytes()
                               for k in ("clean", "visualhull")])
    assert outs["port"] == outs["scripts"]
    assert 0 < len(outs["port"][1][1]) < os.path.getsize(mesh)


@pytest.mark.parametrize("cleaner", ["clean_mesh_faces_by_mask", "clean_mesh_faces_by_visualhull"])
def test_mask_cleaning_matches_jax(tmp_path, scene_dir, cleaner):
    path = mesh_with_outliers(tmp_path / "m.ply")
    kw = {"mask_dilated_size": 5}
    if cleaner.endswith("visualhull"):
        kw["border"] = 2
    getattr(tclean, cleaner)(path, str(tmp_path / "t.ply"), scene_dir, **kw)
    getattr(jclean, cleaner)(path, str(tmp_path / "j.ply"), scene_dir, **kw)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    n_in, n_out = len(load_ply(path)[0]), len(load_ply(str(tmp_path / "t.ply"))[0])
    assert 0 < n_out < n_in, (n_out, n_in)


@pytest.mark.parametrize("keep_largest", [True, False])
def test_clean_outliers_matches_jax(tmp_path, keep_largest):
    path = mesh_with_outliers(tmp_path / "m.ply")
    tclean.clean_outliers(path, str(tmp_path / "t.ply"), faces_num=50, keep_largest=keep_largest)
    jclean.clean_outliers(path, str(tmp_path / "j.ply"), faces_num=50, keep_largest=keep_largest)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    _, faces = sphere_mesh()
    assert (tmp_path / "t.ply").stat().st_size < (tmp_path / "m.ply").stat().st_size
    comp = tclean.connected_components(faces, faces.max() + 1)
    assert len(np.unique(comp)) == 1
