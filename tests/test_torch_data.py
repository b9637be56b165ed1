"""The port's data layer against the JAX package's on the CPU: the PNG
reader and writer against OpenCV (BGR order), the numpy RQ camera
decomposition against the OpenCV branch, the synthetic scene generator, the
loaded scene tensors, training-ray sampling with injected pixels, the
ground-truth patch crop and the source views of the blending finetune."""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

from neuraludf_tpu.config import DatasetConfig as JDatasetConfig
from neuraludf_tpu.data import cameras as jcameras
from neuraludf_tpu.data.dataset import Dataset as JDataset
from neuraludf_tpu.data.dataset import ref_src_info as j_ref_src_info
from neuraludf_tpu.data.dataset import sample_random_rays as j_sample_random_rays
from neuraludf_tpu.data.synthetic import generate_scene as j_generate_scene
from neuraludf_tpu_torch.config import DatasetConfig as TDatasetConfig
from neuraludf_tpu_torch.data import cameras as tcameras
from neuraludf_tpu_torch.data import png
from neuraludf_tpu_torch.data.dataset import Dataset as TDataset
from neuraludf_tpu_torch.data.dataset import (near_far_from_sphere, ref_src_info,
                                              sample_random_rays)
from neuraludf_tpu_torch.data.synthetic import generate_scene as t_generate_scene

SCENE = dict(kind="sphere", n_views=3, H=30, W=40, focal=48.0)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    j_generate_scene(str(root / "jax"), **SCENE)  # written by OpenCV
    t_generate_scene(str(root / "torch"), **SCENE)  # written by the port's PNG writer
    return str(root / "jax"), str(root / "torch")


def test_png_reader_matches_opencv(scenes):
    jdir, _ = scenes
    for sub in ("image", "mask"):
        for name in sorted(os.listdir(os.path.join(jdir, sub))):
            path = os.path.join(jdir, sub, name)
            np.testing.assert_array_equal(png.read_png(path), cv2.imread(path), err_msg=path)


def test_png_writer_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    bgr = rng.randint(0, 256, (17, 23, 3)).astype(np.uint8)
    grey = rng.randint(0, 256, (9, 11)).astype(np.uint8)
    png.write_png(str(tmp_path / "c.png"), bgr)
    png.write_png(str(tmp_path / "g.png"), grey)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "c.png")), bgr)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "c.png")), bgr)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED), grey)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "g.png")), grey[..., None].repeat(3, -1))
    # OpenCV's own filters (Sub, Up, Average, Paeth) on a textured image
    cv2.imwrite(str(tmp_path / "cv.png"), bgr)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "cv.png")), bgr)


def test_png_rejects_other_kinds(tmp_path):
    rgba = np.zeros((4, 4, 4), np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), rgba)
    cv2.imwrite(str(tmp_path / "w.png"), np.zeros((4, 4), np.uint16))
    for name in ("a.png", "w.png"):
        with pytest.raises(ValueError):
            png.read_png(str(tmp_path / name))
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "f.png"), np.zeros((4, 4, 3), np.float32))


def test_generator_matches_jax(scenes):
    jdir, tdir = scenes
    for sub in ("image", "mask"):
        for name in sorted(os.listdir(os.path.join(jdir, sub))):
            np.testing.assert_array_equal(cv2.imread(os.path.join(tdir, sub, name)),
                                          cv2.imread(os.path.join(jdir, sub, name)))
    cj, ct = np.load(os.path.join(jdir, "cameras.npz")), np.load(os.path.join(tdir, "cameras.npz"))
    assert sorted(cj.files) == sorted(ct.files)
    for k in cj.files:
        np.testing.assert_array_equal(ct[k], cj[k])


def test_rq_decomposition_matches_opencv(scenes):
    jdir, _ = scenes
    cams = np.load(os.path.join(jdir, "cameras.npz"))
    for i in range(SCENE["n_views"]):
        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
        k_cv, pose_cv = jcameras.decompose_projection(P)  # OpenCV is installed here
        k_rq, pose_rq = tcameras.decompose_projection(P)
        np.testing.assert_allclose(k_rq, k_cv, atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(pose_rq, pose_cv, atol=1e-5)


def test_dataset_and_ray_sampling(scenes):
    _, tdir = scenes
    jds = JDataset(JDatasetConfig(data_dir=tdir, dataset_name="general"))
    tds = TDataset(TDatasetConfig(data_dir=tdir, dataset_name="general"), "cpu")
    for k in ("images", "masks", "intrinsics", "intrinsics_inv", "poses"):
        np.testing.assert_allclose(tds.scene[k].numpy(), np.asarray(jds.scene[k]), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(tds.ref_src_pairs, np.asarray(jds.ref_src_pairs))
    np.testing.assert_allclose(tds.object_bbox_min, jds.object_bbox_min)

    key = jax.random.PRNGKey(5)
    kx, ky, _ = jax.random.split(key, 3)
    px = torch.tensor(np.asarray(jax.random.randint(kx, (24,), 0, tds.W)))
    py = torch.tensor(np.asarray(jax.random.randint(ky, (24,), 0, tds.H)))
    ref = j_sample_random_rays(jds.scene, 2, key, 24)
    out = sample_random_rays(tds.scene, 2, 24, px=px, py=py)
    np.testing.assert_allclose(out["rays"].numpy(), np.asarray(ref["rays"]), atol=1e-6)
    np.testing.assert_allclose(out["rays_ndc_uv"].numpy(), np.asarray(ref["rays_ndc_uv"]),
                               atol=1e-6)
    near, far = near_far_from_sphere(out["rays"][:, :3], out["rays"][:, 3:6])
    assert bool((far - near - 2.0).abs().max() < 1e-5) and float(near.min()) > 0.0

    # drawn from a generator: in range, reproducible
    gen = lambda: torch.Generator().manual_seed(3)
    a = sample_random_rays(tds.scene, 0, 32, generator=gen())
    b = sample_random_rays(tds.scene, 0, 32, generator=gen())
    assert torch.equal(a["rays"], b["rays"])
    np.testing.assert_allclose(torch.linalg.vector_norm(a["rays"][:, 3:6], dim=-1).numpy(), 1.0,
                               rtol=1e-5)


def test_downsampled_dataset_matches_jax(scenes):
    """downsample_factor 0.5: the images and masks resized bilinearly in
    float64 (atol 1e-6 against OpenCV), the intrinsics scaled with them."""
    _, tdir = scenes
    jds = JDataset(JDatasetConfig(data_dir=tdir, dataset_name="general", downsample_factor=0.5))
    tds = TDataset(TDatasetConfig(data_dir=tdir, dataset_name="general", downsample_factor=0.5),
                   "cpu")
    assert (tds.H, tds.W) == (jds.H, jds.W) == (SCENE["H"] // 2, SCENE["W"] // 2)
    np.testing.assert_allclose(tds.images_np, jds.images_np, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tds.masks_np, jds.masks_np, atol=1e-6, rtol=0)
    for k in ("images", "masks", "intrinsics", "intrinsics_inv", "poses"):
        np.testing.assert_allclose(tds.scene[k].numpy(), np.asarray(jds.scene[k]), atol=1e-5,
                                   err_msg=k)
    for a, b in zip(jds.gen_rays_at(1, 1), tds.gen_rays_at(1, 1)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


@pytest.mark.parametrize("h_patch", [1, 3])
def test_patch_crop_matches_jax(scenes, h_patch):
    _, tdir = scenes
    jds = JDataset(JDatasetConfig(data_dir=tdir, dataset_name="general"))
    tds = TDataset(TDatasetConfig(data_dir=tdir, dataset_name="general"), "cpu")
    key = jax.random.PRNGKey(9)
    kx, ky, _ = jax.random.split(key, 3)
    n = 64
    px = np.asarray(jax.random.randint(kx, (n,), 0, tds.W))
    py = np.asarray(jax.random.randint(ky, (n,), 0, tds.H))
    ref = j_sample_random_rays(jds.scene, 1, key, n, crop_patch=True, h_patch_size=h_patch)
    out = sample_random_rays(tds.scene, 1, n, px=torch.tensor(px), py=torch.tensor(py),
                             crop_patch=True, h_patch_size=h_patch)
    npx = (2 * h_patch + 1) ** 2
    assert out["rays_patch_color"].shape == (n, npx, 3)
    # integer pixel centres: the crop is the image's own values, zeros outside
    np.testing.assert_allclose(out["rays_patch_color"].numpy(),
                               np.asarray(ref["rays_patch_color"]), atol=1e-6)
    assert out["rays_patch_mask"].shape == (n, 1) and out["rays_patch_mask"].dtype == torch.bool
    np.testing.assert_array_equal(out["rays_patch_mask"].numpy(),
                                  np.asarray(ref["rays_patch_mask"]))
    # strict bounds: a pixel exactly h from a border is outside the mask
    edge = sample_random_rays(tds.scene, 1, 4, px=torch.tensor([h_patch, h_patch + 1, 20, 20]),
                              py=torch.tensor([10, 10, tds.H - h_patch, tds.H - h_patch - 1]),
                              crop_patch=True, h_patch_size=h_patch)
    assert edge["rays_patch_mask"][:, 0].tolist() == [False, True, False, True]
    np.testing.assert_allclose(out["rays"].numpy(), np.asarray(ref["rays"]), atol=1e-6)
    # without the crop the two entries are None, as in the JAX package
    plain = sample_random_rays(tds.scene, 1, n, px=torch.tensor(px), py=torch.tensor(py))
    assert plain["rays_patch_color"] is None and plain["rays_patch_mask"] is None


def test_ref_src_info_matches_jax(scenes):
    _, tdir = scenes
    jds = JDataset(JDatasetConfig(data_dir=tdir, dataset_name="general"))
    tds = TDataset(TDatasetConfig(data_dir=tdir, dataset_name="general"), "cpu")
    assert tds.scene["ref_src_pairs"].dtype == torch.long
    np.testing.assert_array_equal(tds.scene["ref_src_pairs"].numpy(), tds.ref_src_pairs)
    for idx in range(SCENE["n_views"]):
        for num in (8, 1):
            ref = j_ref_src_info(jds.scene, jds.ref_src_pairs, idx, num)
            out = ref_src_info(tds.scene, idx, num)
            n_src = min(num, SCENE["n_views"] - 1)
            assert out[3].shape == (n_src, 3, SCENE["H"], SCENE["W"])
            for a, b in zip(out, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # the images are the channel-first view of a channel-last copy
    assert ref_src_info(tds.scene, 0)[3].permute(0, 2, 3, 1).is_contiguous()
