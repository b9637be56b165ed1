"""Tests of the benchmark's harness. Most run on the CPU at tiny sizes; a
test that needs the card is marked ``card`` and skips, deciding inside the
test, where there is none. The ``tiny_bench`` fixture writes a benchmark
folder of tiny cells (the real metric readers, tiny configurations)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

TINY_MODEL = """
model {
  nerf { D = 2, d_in = 4, d_in_view = 3, W = 16, multires = 2, multires_view = 1, output_ch = 4, skips = [], use_viewdirs = True }
  udf_network { d_out = 17, d_in = 3, d_hidden = 16, n_layers = 3, skip_in = [2], multires = 2, bias = 0.5, scale = 1.0, geometric_init = True, weight_norm = True, udf_type = abs }
  variance_network { init_val = 0.3 }
  rendering_network { d_feature = 16, mode = no_normal, d_in = 6, d_out = 3, d_hidden = 16, n_layers = 2, weight_norm = True, multires_view = 1, squeeze_out = True, blending_cand_views = 10 }
  beta_network { init_var_beta = 0.5, init_var_gamma = 0.3, init_var_zeta = 0.3, beta_min = 0.00005, requires_grad_beta = True, requires_grad_gamma = False, requires_grad_zeta = False }
  udf_renderer { n_samples = 8, n_importance = 8, n_outside = %(outside)d, up_sample_steps = 2, perturb = 1.0, sdf2alpha_type = numerical, upsampling_type = %(up)s, h_patch_size = %(hp)d, warp_sampler = strip, blend_top_k = 8, blend_chunk = 4, sparse_scale_factor = 25000, use_norm_grad_for_cosine = %(norm)s }
}
"""

TINY_TRAIN = """
general {
  base_exp_dir = ./exp/benchmark/
  expname = %(name)s
  model_type = udf
  recording = []
}
dataset {
  data_dir = ./benchmark/.cache/scenes/
  render_cameras_name = cameras.npz
  object_cameras_name = cameras.npz
  dataset_name = dtu
  downsample_factor = 1.0
}
train {
  learning_rate = %(lr)g
  learning_rate_geo = 1e-4
  learning_rate_alpha = 0.05
  same_lr = %(same)s
  end_iter = %(end)d
  batch_size = 16
  warm_up_end = 5
  anneal_end = 25
  fix_geo_end = 2
  use_white_bkgd = False
  save_freq = 10000
  val_freq = %(val)d
  val_mesh_freq = %(val)d
  report_freq = 100
  igr_weight = 0.1
  igr_ns_weight = 0.01
  mask_weight = 0.0
  sparse_weight = 0.001
}
color_loss {
  color_base_weight = 0.01
  color_weight = 1.0
  color_pixel_weight = %(pix)g
  color_patch_weight = %(pix)g
  pixel_loss_type = l1
  patch_loss_type = ssim
  h_patch_size = %(hp)d
}
scene { kind = %(kind)s, views = 12, height = 30, width = 40, focal = 45 }
"""


def tiny_conf(name, *, kind="sphere", outside=4, up="classical", finetune=False, norm=False,
              val=2500):
    """A tiny configuration; ``val`` is its ``val_freq`` and ``val_mesh_freq``."""
    hp = 2 if finetune else 1
    return TINY_TRAIN % {"name": name, "lr": 1e-4 if finetune else 5e-4,
                         "same": "False", "end": 500 if finetune else 3000,
                         "pix": 0.1 if finetune else 0.0, "hp": hp, "kind": kind,
                         "val": val} + TINY_MODEL % {
        "outside": outside, "up": up, "hp": hp, "norm": "True" if norm else "False"}


def write_tiny_bench(root: Path) -> Path:
    """A benchmark folder under ``root`` with the tiny cells ``tiny.stage1``,
    ``tinyg.stage1`` (garment kind, mix up-sampling, no background),
    ``tiny.finetune`` and ``tiny.multiscan2`` (a campaign of two scans on
    spheres of radius 0.5 and 0.4), and the real metric readers; returns
    it."""
    here = root / "benchmark"
    (here / "configs").mkdir(parents=True)
    (here / "workloads").mkdir()
    shutil.copytree(HERE / "metrics", here / "metrics")
    shutil.copytree(HERE / "models", here / "models", ignore=shutil.ignore_patterns("__pycache__"))
    (here / "configs" / "tiny.conf").write_text(tiny_conf("tiny"))
    (here / "configs" / "tiny.finetune.conf").write_text(tiny_conf("tiny_ft", finetune=True))
    (here / "configs" / "tinyg.conf").write_text(
        tiny_conf("tinyg", kind="garment", outside=0, up="mix", norm=True))
    limits = {"loss_gap": 1e-4, "eikonal_gap": 1e-4, "grad_gap": 1e-4, "udf_grad_gap": 1e-4,
              "change_gap": 1e-3}
    cells = {"tiny.stage1": {"config": "tiny", "conf": "tiny.conf", "stage": "stage1"},
             "tinyg.stage1": {"config": "tinyg", "conf": "tinyg.conf", "stage": "stage1",
                              "reg_weights_schedule": True},
             "tiny.finetune": {"config": "tiny", "conf": "tiny.finetune.conf",
                               "stage": "finetune", "setup_conf": "tiny.conf",
                               "setup_steps": 50},
             "tiny.multiscan2": {"config": "tiny", "conf": "tiny.conf", "stage": "stage1",
                                 "scans": 2, "scenes": [{"radius": 0.5}, {"radius": 0.4}]}}
    for name, wl in cells.items():
        (here / "workloads" / f"{name}.json").write_text(json.dumps({**wl, "limits": limits}))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": n, "config": wl["config"], "traffic": n.split(".", 1)[1],
                           "chips": 1, "why": "tiny"} for n, wl in cells.items()]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return here


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    return write_tiny_bench(tmp_path_factory.mktemp("bench"))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
