"""The BlendedMVS layout (``dataset_name = "bmvs"``: ``blended_images/*.jpg``,
``masks/*.jpg``) in the port's ``Dataset`` against the JAX package's, which
reads the JPEGs with ``cv2.imread``: a sphere written as cv2 JPEGs, as
``tests/test_train_smoke.py::test_bmvs_layout`` writes it, and the committed
576x768 scene (``tests/data/bmvs_sphere``). The images and masks agree to
1/256 (one level; measured equal), a view's rays to f32 rounding."""

import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from neuraludf_tpu.config import DatasetConfig as JDatasetConfig
from neuraludf_tpu.data.dataset import Dataset as JDataset
from neuraludf_tpu.data.dataset import rays_at as j_rays_at
from neuraludf_tpu.data.synthetic import generate_scene
from neuraludf_tpu_torch.config import DatasetConfig as TDatasetConfig
from neuraludf_tpu_torch.data.dataset import Dataset as TDataset
from neuraludf_tpu_torch.data.dataset import rays_at as t_rays_at

FIXTURE = Path(__file__).resolve().parent / "data" / "bmvs_sphere"
TOL_IMAGE = 1.0 / 256  # one 8-bit level of the /256 convention
TOL_RAYS = 1e-6


def written_as_jpegs(tmp_path) -> str:
    """test_bmvs_layout's scene: three sphere views, each PNG re-written by
    cv2 as a JPEG at its defaults."""
    src = str(tmp_path / "src")
    generate_scene(src, kind="sphere", n_views=3, H=40, W=48, focal=64.0)
    dst = tmp_path / "bmvs"
    (dst / "blended_images").mkdir(parents=True)
    (dst / "masks").mkdir()
    for i in range(3):
        cv2.imwrite(str(dst / "blended_images" / f"{i:03d}.jpg"), cv2.imread(f"{src}/image/{i:03d}.png"))
        cv2.imwrite(str(dst / "masks" / f"{i:03d}.jpg"), cv2.imread(f"{src}/mask/{i:03d}.png"))
    shutil.copy(f"{src}/cameras.npz", dst / "cameras.npz")
    return str(dst)


@pytest.mark.parametrize("scene", ["written_as_jpegs", "committed_576x768"])
def test_bmvs_dataset_matches_jax(tmp_path, scene):
    data_dir = written_as_jpegs(tmp_path) if scene == "written_as_jpegs" else str(FIXTURE)
    jds = JDataset(JDatasetConfig(data_dir=data_dir, dataset_name="bmvs"))
    tds = TDataset(TDatasetConfig(data_dir=data_dir, dataset_name="bmvs"), "cpu")
    n_views, shape = (3, (40, 48)) if scene == "written_as_jpegs" else (8, (576, 768))
    assert tds.n_images == jds.n_images == n_views
    assert tds.scene["images"].shape == (n_views,) + shape + (3,)
    for key in ("images", "masks"):
        diff = np.abs(tds.scene[key].numpy() - np.asarray(jds.scene[key])).max()
        assert diff <= TOL_IMAGE, key
    assert tds.scene["masks"].max() > 0.9 and tds.scene["images"].std() > 0.05
    for a, b in zip(j_rays_at(jds.scene, 1, 2), t_rays_at(tds.scene, 1, 2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL_RAYS, rtol=0)
