"""The port's training step against the JAX package's, end to end on the CPU
at a small config (2-layer skip net of width 64, 16 rays, 16 + 8 samples, 8
outside): loss, the 19 metrics, the parameter gradients and the Adam update,
for stage 1 and for the blending finetune under both warp samplers; then a
short ``Runner.train`` with a checkpoint round trip, the import of a JAX
checkpoint, and a finetune that starts from a saved stage-1 checkpoint."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.data.dataset import Dataset as JDataset
from neuraludf_tpu.data.synthetic import generate_scene
from neuraludf_tpu.render.renderer import UDFRenderer as JRenderer
from neuraludf_tpu.train import optim as joptim
from neuraludf_tpu.train import runner as jrunner
from neuraludf_tpu.train import step as jstep
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.data.dataset import Dataset as TDataset
from neuraludf_tpu_torch.render.renderer import UDFRenderer as TRenderer
from neuraludf_tpu_torch.train import optim as toptim
from neuraludf_tpu_torch.train import schedules
from neuraludf_tpu_torch.train import step as tstep
from neuraludf_tpu_torch.train.runner import Runner as TRunner

BATCH = 16


def raw_config(scene_dir, exp_dir, end_iter=6):
    return {
        "general": {"base_exp_dir": exp_dir, "expname": "step"},
        "dataset": {"data_dir": scene_dir, "dataset_name": "general"},
        "train": {"learning_rate": 5e-4, "learning_rate_geo": 2e-4, "end_iter": end_iter,
                  "batch_size": BATCH, "warm_up_end": 10, "anneal_end": 20, "fix_geo_end": 2,
                  # no periodic 256³ meshes here: tests/test_torch_runner_mesh.py
                  # holds the mesh hooks
                  "save_freq": 3, "val_freq": 3, "val_mesh_freq": 3000, "report_freq": 3},
        "model": {
            "nerf": {"D": 2, "W": 32, "multires": 4, "multires_view": 2, "skips": [0]},
            "udf_network": {"d_out": 33, "d_hidden": 64, "n_layers": 2, "skip_in": [1],
                            "multires": 4},
            "rendering_network": {"d_feature": 32, "d_hidden": 32, "n_layers": 2},
            "udf_renderer": {"n_samples": 16, "n_importance": 8, "n_outside": 8,
                             "up_sample_steps": 4},
        },
    }


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_step") / "sphere"
    generate_scene(str(d), kind="sphere", n_views=4, H=40, W=48, focal=64.0)
    return str(d)


def jax_noise(key, batch, h, w, n_outside):
    """The draws the JAX step makes from its key, for the port to take as given."""
    k_rays, k_render = jax.random.split(key)
    kx, ky, _ = jax.random.split(k_rays, 3)
    k1, k2 = jax.random.split(k_render)
    draws = {
        "px": jax.random.randint(kx, (batch,), 0, w),
        "py": jax.random.randint(ky, (batch,), 0, h),
        "t_rand": jax.random.uniform(k1, (batch, 1), jnp.float32) - 0.5,
        "t_r": jax.random.uniform(k2, (n_outside,), jnp.float32),
    }
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def sched_at(cfg, step, is_finetune=False):
    c = cfg.color_loss
    s = schedules.compute_step_schedules(
        step, cfg.train, c.color_base_weight, c.color_weight, c.color_pixel_weight,
        c.color_patch_weight, is_finetune=is_finetune, reg_weights_schedule=False, same_lr=False,
        beta_trainable=True, variance_trainable=True)
    return dataclasses.asdict(s)


# Gradient tolerances, relative to each leaf's largest gradient. With
# uniform samples only, the two frameworks differ by f32 rounding (~1e-6).
# The up-sampling rounds place new samples by an inverse CDF that is
# ill-conditioned on rays far from the surface: there every alpha is ~1e-5,
# a difference of two sigmoids, so ulp-level differences between XLA's and
# torch's sigmoid move a new sample by up to ~2e-3, and the gradients at
# that sample with it.
SAMPLING = {
    "uniform_samples": ({"n_samples": 16, "n_importance": 0, "n_outside": 8}, 2e-5),
    "up_sampling": ({"n_samples": 16, "n_importance": 8, "n_outside": 8,
                     "up_sample_steps": 4}, 5e-3),
    # the garment renderer of confs/udf_garment_blending.conf: importance_sample_mix
    # (up_sample_no_occ_aware rounds, then an unbiased one), the cosine from the
    # normalised gradient, no background NeRF. Its gradients agree to 1.6e-5
    # here (measured): the no-occlusion rounds' alphas are not the ill-
    # conditioned differences of sigmoids of the classical rounds
    "mix": ({"n_samples": 16, "n_importance": 80, "n_outside": 0, "up_sample_steps": 5,
             "upsampling_type": "mix", "use_norm_grad_for_cosine": True}, 2e-4),
}


# Metrics held looser than rtol 1e-4 in one sampling mode. The mix rounds
# place samples on the surface, where sparse_error's exp(-25000 udf) turns
# the ~1e-4 by which the rounds move a sample into 1.4e-3 (measured; the
# render test holds it at SPARSE_TOL for the same reason).
METRIC_RTOL = {"mix": {"sparse_error": 5e-3}}


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_one_step_matches_jax(scene_dir, tmp_path, monkeypatch, sampling):
    renderer_cfg, grad_tol = SAMPLING[sampling]
    raw = raw_config(scene_dir, str(tmp_path))
    raw["model"]["udf_renderer"] = renderer_cfg
    jcfg, tcfg = jconfig.from_dict(raw), tconfig.from_dict(raw)
    sched = sched_at(tcfg, 5)
    img_idx = 1

    jds = JDataset(jcfg.dataset)
    params_j = jrunner.init_params(jax.random.PRNGKey(0), jcfg)
    # a positive density bias, so the background NeRF's samples carry weight
    # (at this width its initial density is negative everywhere)
    params_j["nerf"]["alpha"]["b"] = params_j["nerf"]["alpha"]["b"] + 1.0
    opt_j = joptim.init_adam_state(params_j)
    # the JAX body hands its gradients to the optimizer; capture them there
    monkeypatch.setattr(jstep, "tree_adam_step", lambda p, g, s, lr_fn, tr_fn: (g, s))
    body_j = jax.jit(jstep.build_step_body(jcfg, JRenderer(jcfg.model), blending=False))
    key = jax.random.PRNGKey(7)
    grads_j, _, metrics_j = body_j(params_j, opt_j, jds.scene, jds.ref_src_pairs,
                                   jnp.asarray(img_idx), key, sched)

    tds = TDataset(tcfg.dataset, "cpu")
    params_t = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    loss_fn = tstep.build_loss_fn(tcfg, TRenderer(tcfg.model))
    noise = jax_noise(key, BATCH, tds.H, tds.W, tcfg.model.udf_renderer.n_outside)
    total, metrics_t = loss_fn(params_t, tds.scene, img_idx, sched, noise=noise)

    # f32 on both sides; the sums run in another order (rtol 1e-4 covers it)
    assert set(metrics_t) == set(tstep.METRIC_KEYS)
    for name in tstep.METRIC_KEYS:
        np.testing.assert_allclose(float(metrics_t[name]), float(metrics_j[name]),
                                   rtol=METRIC_RTOL.get(sampling, {}).get(name, 1e-4),
                                   atol=1e-6, err_msg=name)
    assert float(metrics_t["loss"]) == pytest.approx(float(total.detach()))

    grads_t = tstep.param_grads(total, params_t)
    for path, gj in toptim.leaves(jax.tree_util.tree_map(np.asarray, grads_j)):
        gt = grads_t[path]
        gt = np.zeros_like(gj) if gt is None else gt.numpy()
        scale = max(float(np.abs(gj).max()), 1e-6)
        np.testing.assert_allclose(gt / scale, gj / scale, atol=grad_tol, err_msg=str(path))
    # the background NeRF trains where the renderer has outside samples
    nerf_grad = float(np.abs(grads_j["nerf"]["rgb"]["w"]).max())
    assert nerf_grad > 0.0 if renderer_cfg["n_outside"] else nerf_grad == 0.0

    # Adam on identical gradients, in f32 with the same operation order, held
    # to rtol 2.5e-7 (two f32 ulps): XLA's CPU code generator may contract
    # a·b + c into one FMA or reorder a product, so a few elements land one
    # ulp apart (2 of 999 in udf/lin0/v on the first step). The updated parameters are not compared after a step of
    # each framework's own gradients: the first update is ~lr·sign(g), and an
    # element whose gradient is near zero may flip its sign, moving by 2·lr.
    lr_fn = joptim.make_lr_fn(sched["lr_geo"], sched["lr_main"], sched["lr_main"])
    tr_fn = joptim.make_trainable_fn(jcfg.model.beta_network, 1.0, 1.0)
    grads_np = dict(toptim.leaves(jax.tree_util.tree_map(np.asarray, grads_j)))
    opt_t = toptim.init_adam_state(params_t)
    for n_step in (1, 2):
        params_j, opt_j = joptim.tree_adam_step(params_j, grads_j, opt_j, lr_fn, tr_fn)
        toptim.adam_step(params_t, {p: torch.tensor(g) for p, g in grads_np.items()}, opt_t,
                         toptim.make_lr_fn(sched["lr_geo"], sched["lr_main"], sched["lr_main"]),
                         toptim.make_trainable_fn(tcfg.model.beta_network, 1.0, 1.0))
        for tree_j, tree_t in ((params_j, params_t), (opt_j, opt_t)):
            for path, aj in toptim.leaves(jax.tree_util.tree_map(np.asarray, tree_j)):
                np.testing.assert_allclose(toptim.get_path(tree_t, path).detach().numpy(), aj,
                                           rtol=2.5e-7, atol=0,
                                           err_msg=f"step {n_step} {path}")


def blending_raw(scene_dir, exp_dir, sampler, end_iter=6):
    raw = raw_config(scene_dir, exp_dir, end_iter)
    raw["color_loss"] = {"color_base_weight": 0.01, "color_weight": 1.0,
                         "color_pixel_weight": 0.1, "color_patch_weight": 0.1, "h_patch_size": 2}
    raw["model"]["udf_renderer"] = {"n_samples": 16, "n_importance": 0, "n_outside": 8,
                                    "h_patch_size": 2, "warp_sampler": sampler,
                                    "blend_top_k": 8, "blend_chunk": 4}
    return raw


@pytest.fixture(scope="module")
def strip_scene_dir(tmp_path_factory):
    """Views of one TPU strip exactly (64 x 256): the Pallas sampler loses no
    position, so its mask is the in-image mask."""
    d = tmp_path_factory.mktemp("torch_step_ft") / "sphere"
    # the sphere fills the height of the frame, so a fair share of rays hits it
    generate_scene(str(d), kind="sphere", n_views=4, H=64, W=256, focal=180.0)
    return str(d)


def key_with_hits(scene, img_idx, batch, h, w, n_outside, at_least):
    """A JAX key whose pixel draws put at least ``at_least`` rays on the object."""
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        noise = jax_noise(key, batch, h, w, n_outside)
        hits = int((scene["masks"][img_idx][noise["py"].long(), noise["px"].long(), 0] > 0).sum())
        if hits >= at_least:
            return key, noise
    raise AssertionError("no key found")


def white_noise_images(shape):
    """8-bit white noise in place of the rendered views. The geometry
    gradient of a blended colour is a sum of colour differences between
    neighbouring samples; on the smooth shading of the sphere these are
    ~1e-3, no larger than the error of the TPU kernel's bf16 column weights,
    and its gradients then differ from the exact gathers' by 80% (measured;
    the loss by 1.5e-4). White noise makes the differences O(0.3), so that
    the two samplers can be compared. k/256 is exact in bf16."""
    return (np.random.RandomState(11).randint(0, 256, shape) / 256.0).astype(np.float32)


# Tolerances of one blending step. gather: f32 gathers on both sides and
# uniform samples, as in the stage-1 case (metrics rtol 1e-4); the surface is
# sharpened here (inv_s = e^6) and the scalar leaves (beta, gamma, variance)
# reach 1.1e-4 of their gradient on the rendered views and 9.4e-5 on white
# noise. strip: the Pallas kernel (interpret mode) rounds its column weights
# to bf16 (5e-3 on a colour), the port samples in f32; the blended losses are
# means of such colours (2.4e-4 measured) and the gradients carry their
# share of it (1.6e-2 measured on beta and gamma, 7e-3 and less elsewhere).
BLEND_STEP_TOL = {"gather": dict(metric_rtol=1e-4, grad=3e-4),
                  "strip": dict(metric_rtol=5e-3, grad=3e-2)}


@pytest.mark.parametrize("sampler", ["gather", "strip"])
def test_one_blending_step_matches_jax(strip_scene_dir, tmp_path, monkeypatch, sampler):
    tol = BLEND_STEP_TOL[sampler]
    raw = blending_raw(strip_scene_dir, str(tmp_path), sampler)
    jcfg, tcfg = jconfig.from_dict(raw), tconfig.from_dict(raw)
    sched = sched_at(tcfg, 5, is_finetune=True)
    assert sched["color_pixel_weight"] > 0 and sched["color_patch_weight"] > 0
    img_idx = 2

    jds = JDataset(jcfg.dataset)
    params_j = jrunner.init_params(jax.random.PRNGKey(0), jcfg)
    params_j["nerf"]["alpha"]["b"] = params_j["nerf"]["alpha"]["b"] + 1.0
    # a sharp surface (inv_s = e^6), so that the rays on the initial sphere
    # gather weight above 0.5 and their patches count in the loss
    params_j["variance"]["variance"] = params_j["variance"]["variance"] * 0.0 + 0.6
    opt_j = joptim.init_adam_state(params_j)
    monkeypatch.setattr(jstep, "tree_adam_step", lambda p, g, s, lr_fn, tr_fn: (g, s))
    body_j = jax.jit(jstep.build_step_body(jcfg, JRenderer(jcfg.model), blending=True))
    tds = TDataset(tcfg.dataset, "cpu")
    images = white_noise_images(tuple(tds.scene["images"].shape))
    jds.scene = dict(jds.scene, images=jnp.asarray(images))
    tds.scene["images"] = torch.tensor(images)
    key, noise = key_with_hits(tds.scene, img_idx, BATCH, tds.H, tds.W,
                               tcfg.model.udf_renderer.n_outside, at_least=6)
    grads_j, _, metrics_j = body_j(params_j, opt_j, jds.scene, jds.ref_src_pairs,
                                   jnp.asarray(img_idx), key, sched)
    monkeypatch.undo()

    params_t = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    renderer_t = TRenderer(tcfg.model)
    loss_fn = tstep.build_loss_fn(tcfg, renderer_t, blending=True)
    total, metrics_t = loss_fn(params_t, tds.scene, img_idx, sched, noise=noise)

    assert set(metrics_t) == set(tstep.METRIC_KEYS)
    for name in tstep.METRIC_KEYS:
        np.testing.assert_allclose(float(metrics_t[name]), float(metrics_j[name]),
                                   rtol=tol["metric_rtol"], atol=1e-6, err_msg=name)
    assert float(metrics_t["color_pixel_loss"]) > 0 and float(metrics_t["color_patch_loss"]) > 0
    cover = float(metrics_t["blend_strip_cover"])
    assert cover == 1.0 if sampler == "gather" else 0.0 < cover <= 1.0

    grads_t = tstep.param_grads(total, params_t)
    for path, gj in toptim.leaves(jax.tree_util.tree_map(np.asarray, grads_j)):
        gt = grads_t[path]
        gt = np.zeros_like(gj) if gt is None else gt.numpy()
        scale = max(float(np.abs(gj).max()), 1e-6)
        np.testing.assert_allclose(gt / scale, gj / scale, atol=tol["grad"], err_msg=str(path))
    # the blending logits (the colour net's last outputs) are trained
    assert float(np.abs(np.asarray(grads_j["color"]["main"]["lin2"]["b"])[3:]).max()) > 0.0

    # updated parameters: each framework's Adam on its own gradients. The
    # first update is ~lr * sign(g), so an element whose gradient is near
    # zero may flip its sign and move by 2 lr; all others agree to f32.
    lr_fn = joptim.make_lr_fn(sched["lr_geo"], sched["lr_main"], sched["lr_main"])
    tr_fn = joptim.make_trainable_fn(jcfg.model.beta_network, 1.0, 1.0)
    new_j, _ = joptim.tree_adam_step(params_j, grads_j, opt_j, lr_fn, tr_fn)
    opt_t = toptim.init_adam_state(params_t)
    body_t = tstep.build_step_body(tcfg, renderer_t, blending=True)
    metrics_b = body_t(params_t, opt_t, tds.scene, img_idx, sched, noise=noise)
    assert float(metrics_b["loss"]) == pytest.approx(float(total.detach()), rel=1e-6)
    lr = max(sched["lr_geo"], sched["lr_main"])
    n_all = n_off = 0
    for path, aj in toptim.leaves(jax.tree_util.tree_map(np.asarray, new_j)):
        at = toptim.get_path(params_t, path).detach().numpy()
        np.testing.assert_allclose(at, aj, atol=2.01 * lr, rtol=0, err_msg=str(path))
        n_all += aj.size
        n_off += int((np.abs(at - aj) > 1e-6 + 1e-5 * np.abs(aj)).sum())
    assert n_off / n_all < (0.01 if sampler == "gather" else 0.05), (n_off, n_all)


def test_patch_size_must_agree(scene_dir, tmp_path):
    raw = blending_raw(scene_dir, str(tmp_path), "gather")
    raw["color_loss"]["h_patch_size"] = 3
    tcfg = tconfig.from_dict(raw)
    with pytest.raises(ValueError, match="h_patch_size"):
        tstep.build_loss_fn(tcfg, TRenderer(tcfg.model), blending=True)
    tstep.build_loss_fn(tcfg, TRenderer(tcfg.model), blending=False)  # stage 1 does not care


@pytest.mark.parametrize("sampler", ["auto", "strip"])
def test_runner_finetune_from_stage1_checkpoint(scene_dir, tmp_path, sampler):
    """Stage 1 saves a checkpoint; a finetune runner loads it, restarts the
    schedule clock and trains blending iterations (on the CPU 'auto' is the
    gather sampler and 'strip' runs the plain version of K3)."""
    raw = blending_raw(scene_dir, str(tmp_path), sampler, end_iter=3)
    stage1 = dict(raw, color_loss={"h_patch_size": 2})
    r1 = TRunner(tconfig.from_dict(stage1), device="cpu", seed=3)
    r1.train()
    assert r1.iter_step == 3 and r1._latest_checkpoint().endswith("ckpt_000003.ckpt")
    # the step bodies built, one at a time or in a window
    bodies = lambda r: set(r._step_bodies) | {key[0] for key in r._window_fns}
    assert bodies(r1) == {False}  # stage 1 ran no blending step
    n_stage1 = 3

    raw["train"]["end_iter"] = 4
    ft = TRunner(tconfig.from_dict(raw), device="cpu", seed=4, is_continue=True,
                 is_finetune=True)
    assert ft.iter_step == 0  # the finetune restarts the clock
    for (path, a), (_, b) in zip(toptim.leaves(r1.params), toptim.leaves(ft.params)):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy(), err_msg=str(path))
    ft.train()
    assert ft.iter_step == 4 and bodies(ft) == {True}
    log_path = tmp_path / "step" / "logs" / "metrics.jsonl"
    rows = [json.loads(l) for l in log_path.read_text().splitlines()]
    assert len(rows) == n_stage1 + 4
    for row in rows[:n_stage1]:
        assert row["color_pixel_loss"] == 0.0 and row["color_patch_loss"] == 0.0
        assert row["blend_strip_cover"] == 1.0
    for row in rows[n_stage1:]:
        assert all(np.isfinite(row[k]) for k in tstep.METRIC_KEYS)
        assert row["color_pixel_loss"] > 0.0 and row["color_patch_loss"] > 0.0
        assert 0.0 < row["blend_strip_cover"] <= 1.0
        assert (row["blend_strip_cover"] == 1.0) == (sampler == "auto")


def test_runner_train_checkpoint_and_jax_import(scene_dir, tmp_path):
    raw = raw_config(scene_dir, str(tmp_path / "torch"))
    tcfg = tconfig.from_dict(raw)
    runner = TRunner(tcfg, device="cpu", seed=3)
    runner.train()
    assert runner.iter_step == 6
    log_path = tmp_path / "torch" / "step" / "logs" / "metrics.jsonl"
    lines = log_path.read_text().splitlines()
    assert len(lines) == 6 and all(np.isfinite(json.loads(l)["loss"]) for l in lines)
    ckpts = sorted((tmp_path / "torch" / "step" / "checkpoints").iterdir())
    assert [p.name for p in ckpts] == ["ckpt_000003.ckpt", "ckpt_000006.ckpt"]

    # round trip: a resumed runner holds the same state
    resumed = TRunner(tcfg, device="cpu", seed=99, is_continue=True)
    assert resumed.iter_step == 6
    for (path, a), (_, b) in zip(toptim.leaves(runner.params), toptim.leaves(resumed.params)):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy(), err_msg=str(path))
    assert torch.equal(resumed.generator.get_state(), runner.generator.get_state())

    # a JAX checkpoint loads into the port with identical parameters
    jcfg = jconfig.from_dict(raw_config(scene_dir, str(tmp_path / "jax")))
    jr = jrunner.Runner(jcfg, seed=5)
    jr.iter_step = 4
    jr.save_checkpoint()
    imported = TRunner(tcfg, device="cpu", seed=0)
    imported.load_checkpoint(jr._latest_checkpoint())
    assert imported.iter_step == 4
    for path, pj in toptim.leaves(jax.tree_util.tree_map(np.asarray, jr.params)):
        np.testing.assert_array_equal(toptim.get_path(imported.params, path).detach().numpy(),
                                      pj, err_msg=str(path))
    assert toptim.get_path(imported.params, ("udf", "lin0", "v")).shape == (27, 37)
    imported.end_iter = 6
    imported.train()
    assert imported.iter_step == 6


def test_cli_surface(monkeypatch):
    """The CLI keeps the JAX package's arguments and modes; --multihost
    joins the launcher's process group first (tests/test_torch_multihost.py)
    and raises without its environment; every mode, --vis_ray and
    --profile_dir included, asks for a CUDA device instead of falling back."""
    from neuraludf_tpu import cli as jcli
    from neuraludf_tpu_torch import cli as tcli

    jargs = {a.dest for a in jcli.build_parser()._actions}
    assert jargs == {a.dest for a in tcli.build_parser()._actions}
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tcli.main(["--mode", "train", "--multihost"])
    with pytest.raises(SystemExit, match="unknown mode"):
        tcli.main(["--mode", "render_everything"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = ["--case", "sphere", "--conf",
            os.path.join(os.path.dirname(__file__), "..", "confs", "synthetic_smoke.conf")]
    for args in (["--mode", "train"], ["--mode", "train", "--vis_ray"],
                 ["--mode", "train", "--profile_dir", "prof"], ["--mode", "validate_mesh"],
                 ["--mode", "extract_udf_mesh"], ["--mode", "validate_fields"],
                 ["--mode", "validate_image"], ["--mode", "validate_image_all"],
                 ["--mode", "save_hdf5"], ["--mode", "vis_one_ray"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(args + conf)
