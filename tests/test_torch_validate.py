"""The port's validation renders, ray statistics, HDF5 dump and the CLI modes
around them, against the JAX package's on the CPU at a tiny size: a scene of
9 views at 40x48 (so the pixel-blended colour is rendered), a 3-layer net of
width 32, 8 + 4 samples and 4 outside, ``perturb = 0``, the same parameters
(the JAX runner's, converted) in both runners.

Tolerances. Ray generation: atol 1e-6 (f32 on both sides; ``linspace``
rounds its last ulp differently). The renders: the frameworks differ by f32
rounding, which the up-sampling rounds amplify where a ray misses the
surface (every alpha ~1e-5 there, a difference of two sigmoids, so an ulp
moves a new sample by up to ~1e-3 of the ray): colours atol 1e-4, normals
and depth atol 5e-4 (measured: 1.6e-5, 8.2e-5, 5.8e-5). PNGs: the same
names; pixels within 1 (uint8 truncation of values that differ by ~1e-5
may fall on two sides of an integer). Ground truth at a resolution level:
within 1 of OpenCV (its 11-bit fixed-point weights)."""

import json
import logging
import os

import cv2
import h5py
import jax
import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.train import runner as jrunner
from neuraludf_tpu_torch import cli as tcli
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.data import image as timage
from neuraludf_tpu_torch.data.synthetic import generate_scene
from neuraludf_tpu_torch.train import colormap
from neuraludf_tpu_torch.train import runner as trunner
from neuraludf_tpu_torch.utils import hdf5, trace

IDX, ITER = 3, 7
TOL = {"color": 1e-4, "color_pixel": 1e-4, "normal": 5e-4, "depth": 5e-4}


def raw_config(scene_dir, exp_dir, **train):
    return {
        "general": {"base_exp_dir": exp_dir, "expname": "val"},
        "dataset": {"data_dir": scene_dir, "dataset_name": "general"},
        "train": {"end_iter": 2, "batch_size": 8, "warm_up_end": 10, "anneal_end": 20,
                  "fix_geo_end": 2, "save_freq": 1000, "val_freq": 1000, "val_mesh_freq": 1000,
                  "report_freq": 1000, **train},
        "model": {
            "nerf": {"D": 2, "W": 32, "multires": 4, "multires_view": 2, "skips": [0]},
            "udf_network": {"d_out": 17, "d_hidden": 32, "n_layers": 3, "skip_in": [2],
                            "multires": 2},
            "rendering_network": {"d_feature": 16, "d_hidden": 16, "n_layers": 2},
            "udf_renderer": {"n_samples": 8, "n_importance": 4, "n_outside": 4,
                             "up_sample_steps": 2, "perturb": 0.0},
        },
    }


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_validate") / "sphere"
    generate_scene(str(d), kind="sphere", n_views=9, H=40, W=48, focal=64.0)
    return str(d)


@pytest.fixture(scope="module")
def runners(scene_dir, tmp_path_factory):
    """(JAX runner, port runner) on the same parameters at iteration 7."""
    root = tmp_path_factory.mktemp("torch_validate_exp")
    jr = jrunner.Runner(jconfig.from_dict(raw_config(scene_dir, str(root / "jax"))), seed=0)
    tr = trunner.Runner(tconfig.from_dict(raw_config(scene_dir, str(root / "torch"))),
                        device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jr.params)
    # a positive density bias, so the background NeRF's samples carry weight
    params["nerf"]["alpha"]["b"] = params["nerf"]["alpha"]["b"] + 1.0
    jr.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    tr.params = convert.to_torch(params, "cpu", requires_grad=True)
    jr.iter_step = tr.iter_step = ITER
    return jr, tr


def read(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED).astype(np.int64)


def assert_same_pngs(j_dir, t_dir):
    names = sorted(os.listdir(j_dir))
    assert names and names == sorted(os.listdir(t_dir))
    for name in names:
        a, b = read(os.path.join(j_dir, name)), read(os.path.join(t_dir, name))
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1, name


def test_rays_and_images_match_jax(runners):
    jr, tr = runners
    jd, td = jr.dataset, tr.dataset
    for level in (1, 2, 3):
        for a, b in zip(jd.gen_rays_at(IDX, level), td.gen_rays_at(IDX, level)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
        gt_j, gt_t = jd.image_at(IDX, level), td.image_at(IDX, level)
        assert gt_t.dtype == np.uint8 and gt_t.shape == gt_j.shape
        assert np.abs(gt_t.astype(int) - gt_j).max() <= 1
    np.testing.assert_allclose(td.gen_one_ray_at(5, 17, 29).numpy(),
                               np.asarray(jd.gen_one_ray_at(5, 17, 29)), atol=1e-6, rtol=0)
    for a, b in zip(jd.gen_rays_between(0, 4, 0.3, 2), td.gen_rays_between(0, 4, 0.3, 2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
    rays_o, rays_d = td.gen_rays_at(IDX, 4)
    for a, b in zip(jd.near_far_from_sphere(jax.numpy.asarray(rays_o.numpy()),
                                            jax.numpy.asarray(rays_d.numpy())),
                    td.near_far_from_sphere(rays_o, rays_d)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


@pytest.mark.parametrize("size", [(40, 48), (37, 53), (600, 800)])
def test_resize_matches_opencv(size):
    h, w = size
    img = np.random.default_rng(h).integers(0, 256, (h, w, 3)).astype(np.uint8)
    for level in (2, 3, 4):
        dsize = (w // level, h // level)
        ours = timage.resize(img, dsize)
        assert ours.dtype == np.uint8
        assert np.abs(ours.astype(int) - cv2.resize(img, dsize)).max() <= 1
        assert np.abs(timage.resize(img[:, :, 0], dsize).astype(int)
                      - cv2.resize(img[:, :, 0], dsize)).max() <= 1
    f = img / 256.0
    for fx in (0.5, 0.3, 1.7):
        ref = cv2.resize(f, None, fx=fx, fy=fx, interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(timage.resize(f, fx=fx), ref, atol=1e-6, rtol=0)


def test_colorize_depth_matches_jax():
    rng = np.random.default_rng(0)
    depths = [rng.random((30, 40)).astype(np.float32) * 3.0, rng.random((7, 9)),
              np.full((5, 6), 2.0, np.float32), np.array([[0.0, 1.0, np.nan, 0.5]], np.float32)]
    for d in depths:
        ours = colormap.colorize_depth(d)
        assert ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, jrunner.colorize_depth(d))
    lut = jrunner.colorize_depth(np.linspace(0.0, 1.0, 257)[None])[0, :256]
    np.testing.assert_array_equal(colormap.PLASMA, lut)


def test_validate_matches_jax(runners, monkeypatch):
    """The colour, pixel colour, normal and depth arrays of a 1,920-ray
    render (30 chunks of 64 rays: 4 windows, the last padded), then the PNGs
    that both runners write."""
    jr, tr = runners
    captured = []
    window_fn = jr._render_val_window_fn

    def recording(pixel_blending, n_chunks):
        fn = window_fn(pixel_blending, n_chunks)

        def run(*args):
            out = fn(*args)
            captured.append([np.asarray(o) for o in out])
            return out
        return run

    monkeypatch.setattr(jr, "_render_val_window_fn", recording)
    rendered = []
    render_rays = tr.render_rays
    monkeypatch.setattr(tr, "render_rays",
                        lambda *a, **k: rendered.append(render_rays(*a, **k)) or rendered[-1])
    jr.validate(IDX, resolution_level=1)
    tr.validate(IDX, resolution_level=1)

    n = tr.dataset.H * tr.dataset.W
    ref = [np.concatenate([w[i].reshape(-1, w[i].shape[-1]) for w in captured])[:n]
           for i in range(4)]
    (out,) = rendered
    assert out.shape == (n, 10) and len(captured) == 4
    for (name, tol), a, b in zip(TOL.items(), ref, (out[:, 0:3], out[:, 3:6], out[:, 6:9],
                                                    out[:, 9:10])):
        np.testing.assert_allclose(b, a, atol=tol, rtol=0, err_msg=name)
    assert np.abs(out[:, 3:6]).max() > 0.05  # the pixel-blended colour was rendered
    for sub in ("validations_fine", "normals", "depth"):
        assert_same_pngs(os.path.join(jr.base_exp_dir, sub), os.path.join(tr.base_exp_dir, sub))
    assert os.listdir(os.path.join(tr.base_exp_dir, "normals")) == [f"{ITER:0>8d}_{IDX}.png"]


def test_novel_views_match_jax(runners):
    """validate_novel_image, and validate with only_color (the CLI's
    validate_image)."""
    jr, tr = runners
    jr.validate_novel_image(0, 4, 0.3, out_idx=5, resolution_level=2)
    path = tr.validate_novel_image(0, 4, 0.3, out_idx=5, resolution_level=2)
    assert os.path.basename(path) == "5.png"
    jr.validate(2, resolution_level=4, only_color=True)
    tr.validate(2, resolution_level=4, only_color=True)
    for sub in ("render", "novel_view"):
        assert_same_pngs(os.path.join(jr.base_exp_dir, sub), os.path.join(tr.base_exp_dir, sub))


def test_visualize_one_ray_matches_jax(runners):
    jr, tr = runners
    jr.visualize_one_ray(4, 20, 18)
    fig = tr.visualize_one_ray(4, 20, 18)
    rel = os.path.join("ray_statis", f"step{ITER}", "statis_px20_py18")
    assert fig == os.path.join(tr.base_exp_dir, rel + ".png")
    ref = np.load(os.path.join(jr.base_exp_dir, rel + ".npy"), allow_pickle=True).item()
    ours = np.load(os.path.join(tr.base_exp_dir, rel + ".npy"), allow_pickle=True).item()
    assert sorted(ours) == sorted(ref) == ["cos", "udf", "z_vals"]
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], atol=5e-4, rtol=0, err_msg=key)
    img = read(fig)
    assert img.shape == (4200, 1000, 3) and (img != 255).any()


def test_save_hdf5_matches_jax(runners):
    jr, tr = runners
    jr.save_hdf5(resolution=16)
    path = tr.save_hdf5(resolution=16)
    assert path == os.path.join(tr.base_exp_dir, "hdf5", "out.hdf5")
    with h5py.File(os.path.join(jr.base_exp_dir, "hdf5", "out.hdf5"), "r") as f:
        ref = f["16_sdf"][:]
    with h5py.File(path, "r") as f:
        assert list(f.keys()) == ["16_sdf"]
        ours = f["16_sdf"][:]
    assert ours.dtype == np.float32 and ours.shape == (17, 17, 17)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_hdf5_writer_round_trip(tmp_path):
    """Shapes of rank 1 to 3 read back by h5py, bit for bit; the checksum is
    lookup3's (a file of h5py's own, latest format, carries it)."""
    rng = np.random.default_rng(1)
    for shape in ((5,), (3, 4), (6, 1, 7)):
        data = rng.standard_normal(shape).astype(np.float32)
        path = str(tmp_path / f"{len(shape)}.h5")
        hdf5.write_dataset(path, "x_sdf", data)
        with h5py.File(path, "r") as f:
            np.testing.assert_array_equal(f["x_sdf"][:], data)
    ref = str(tmp_path / "ref.h5")
    with h5py.File(ref, "w", libver="latest") as f:
        f.create_dataset("y", data=np.arange(4, dtype=np.float32))
    raw = open(ref, "rb").read()
    assert int.from_bytes(raw[44:48], "little") == hdf5.lookup3(raw[:44])


def test_file_backup(scene_dir, tmp_path, monkeypatch):
    """The .py files of each recording directory (paths relative to the
    working directory, as the reference's confs give them) and the config."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "a.py").write_text("A = 1\n")
    (tmp_path / "src" / "b.txt").write_text("not copied")
    raw = raw_config(scene_dir, str(tmp_path / "exp"))
    raw["general"]["recording"] = ["src", "missing"]
    cfg = tconfig.from_dict(raw)
    trunner.Runner(cfg, "validate_mesh", device="cpu")
    rec = tmp_path / "exp" / "val" / "recording"
    assert not rec.exists()  # only the training modes snapshot
    runner = trunner.Runner(cfg, device="cpu")
    assert sorted(os.listdir(rec)) == ["config.txt", "src"]
    assert sorted(os.listdir(rec / "src")) == ["a.py"]
    assert (rec / "config.txt").read_text() == repr(runner.cfg)


def test_periodic_validation_hooks(scene_dir, tmp_path, monkeypatch, caplog):
    """validate on every multiple of val_freq, the ray statistics of a
    column of pixels on every multiple of 2 val_mesh_freq with vis_ray; a
    failed render is logged and training goes on; the checkpoint written at
    the same iteration holds the render's random draws."""
    raw = raw_config(scene_dir, str(tmp_path), end_iter=8, val_freq=2, val_mesh_freq=2000,
                     save_freq=4)
    runner = trunner.Runner(tconfig.from_dict(raw), device="cpu", vis_ray=True)
    calls = []
    monkeypatch.setattr(runner, "validate_mesh", lambda: calls.append(("vm", runner.iter_step)))
    validate = runner.validate

    def failing_validate():
        calls.append(("val", runner.iter_step))
        if runner.iter_step == 4:
            raise RuntimeError("render failed")
        validate()

    monkeypatch.setattr(runner, "validate", failing_validate)
    with caplog.at_level(logging.ERROR):
        runner.train()
    assert runner.iter_step == 8
    assert calls == [("val", 2), ("val", 4), ("val", 6), ("val", 8)]
    assert "validate failed at iter 4" in caplog.text
    names = sorted(os.listdir(tmp_path / "val" / "validations_fine"))
    assert [n.split("_")[0] for n in names] == ["00000002", "00000006", "00000008"]
    resumed = trunner.Runner(tconfig.from_dict(raw), device="cpu", is_continue=True)
    assert resumed.iter_step == 8
    assert torch.equal(resumed.generator.get_state(), runner.generator.get_state())

    raw = raw_config(scene_dir, str(tmp_path / "vis"), end_iter=4, val_mesh_freq=1)
    runner = trunner.Runner(tconfig.from_dict(raw), device="cpu", vis_ray=True)
    rays = []
    monkeypatch.setattr(runner, "visualize_one_ray", lambda i, x, y: rays.append(
        (runner.iter_step, i, x, y)))
    monkeypatch.setattr(runner, "validate_mesh", lambda: None)
    monkeypatch.setattr(runner, "extract_udf_mesh", lambda **kw: None)
    runner.train()
    # view min(33, 8), the centre column, rows H/2 - H/4 ... in steps of max(20, H/8)
    assert rays == [(2, 8, 24, 10), (4, 8, 24, 10)]


def test_cli_modes(scene_dir, tmp_path, monkeypatch):
    """train with --profile_dir and --vis_ray writes a trace, which holds the
    program's spans, and the ray statistics; validate_image, save_hdf5 and vis_one_ray run from the newest
    checkpoint. The meshes (tests/test_torch_runner_mesh.py) are stubbed."""
    monkeypatch.setattr(trunner, "default_device", lambda gpu=0: torch.device("cpu"))
    meshes = []
    monkeypatch.setattr(trunner.Runner, "validate_mesh", lambda self: meshes.append("vm"))
    monkeypatch.setattr(trunner.Runner, "extract_udf_mesh",
                        lambda self, **kw: meshes.append(kw.get("resolution")))
    raw = raw_config(scene_dir, str(tmp_path / "exp"), save_freq=2, val_mesh_freq=1)
    conf = tmp_path / "tiny.conf"
    conf.write_text(to_hocon(raw))
    base = ["--conf", str(conf), "--case", "sphere"]
    prof = tmp_path / "prof"
    tcli.main(base + ["--mode", "train", "--final_mesh_resolution", "16", "--vis_ray",
                      "--profile_dir", str(prof)])
    exp = tmp_path / "exp" / "val"
    assert (prof / "trace.json").stat().st_size > 0
    with open(prof / "trace.json") as f:  # the program's spans are in the operator's trace
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"runner.window", "window.call", "step.render"} <= names
    assert not trace.enabled()  # the profiled training alone was traced
    assert meshes == ["vm", None, "vm", None, 16]  # iterations 1 and 2, then the closing one
    assert (exp / "checkpoints" / "ckpt_000002.ckpt").is_file()
    assert (exp / "ray_statis" / "step2" / "statis_px24_py10.npy").is_file()
    for mode, outs in (("validate_image", ["novel_view/pred_0.png", "novel_view/gt_0.png"]),
                       ("save_hdf5", ["hdf5/out.hdf5"]),
                       ("vis_one_ray", ["ray_statis/step2/statis_px24_py20.png"])):
        tcli.main(base + ["--mode", mode, "--is_continue", "--resolution", "12"])
        for out in outs:
            assert (exp / out).is_file(), (mode, out)
    assert read(exp / "novel_view" / "pred_0.png").shape == (40, 48, 3)
    with h5py.File(exp / "hdf5" / "out.hdf5", "r") as f:
        assert f["12_sdf"].shape == (13, 13, 13)
    assert not (exp / "novel_view" / "pred_10.png").exists()  # 9 views: index 0 only


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
