"""The port's multi-scan training (``neuraludf_tpu_torch/parallel/multi_scan.py``
and its command line) on the CPU, at the small config of
``tests/test_torch_window.py``, over two scenes of one resolution and view
count (a sphere and a capsule):

- the multi-scan window (S = 2, W = 4) against the JAX package's
  ``build_multi_scan_window`` on conftest's virtual mesh, each scan on the
  draws of its JAX keys, for stage 1 and for blending;
- each scan of a ``MultiScanRunner`` against a single-scan ``Runner(seed=i)``
  fed scan i's image indices, bit for bit (graphed windows on a card run the
  same bodies; ``chip_smoke.py`` holds it there), in windows and one step
  at a time;
- a ``--sweep`` of two ``sparse_weight`` values through the command line,
  each scan equal to a single run with that override, with the closing
  meshes;
- checkpoints, resume from the newest common one (``crash_*`` ones are
  skipped), a per-scan checkpoint loaded by a plain ``Runner``, the report
  hooks and the per-scan validation renders;
- the overrides and scenes the runner refuses.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.data.dataset import Dataset as JDataset
from neuraludf_tpu.data.synthetic import generate_scene
from neuraludf_tpu.parallel import multi_scan as jms
from neuraludf_tpu.parallel.sharding import make_mesh
from neuraludf_tpu.render.renderer import UDFRenderer as JRenderer
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.parallel import train_multi_scan
from neuraludf_tpu_torch.parallel.multi_scan import (SWEEPABLE_TRAIN_FIELDS, MultiScanRunner,
                                                      build_multi_scan_window)
from neuraludf_tpu_torch.render.renderer import UDFRenderer as TRenderer
from neuraludf_tpu_torch.train import schedules
from neuraludf_tpu_torch.train import step as tstep
from neuraludf_tpu_torch.train.optim import init_adam_state, leaves
from neuraludf_tpu_torch.train.runner import Runner
from test_torch_step import blending_raw, jax_noise
from test_torch_window import small_raw

S, W = 2, 4


@pytest.fixture(scope="module")
def scan_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_multi_scan")
    dirs = []
    for kind in ("sphere", "capsule"):
        generate_scene(str(root / kind), kind=kind, n_views=4, H=40, W=48, focal=64.0)
        dirs.append(str(root / kind))
    return dirs


def hocon_text(raw: dict) -> str:
    """A configuration dict as the port's .conf reader takes it."""
    lines = []
    for key, val in raw.items():
        if isinstance(val, dict):
            lines += [f"{key} {{", hocon_text(val), "}"]
        elif isinstance(val, (list, tuple)):
            lines.append(f"{key} = [{', '.join(map(str, val))}]")
        else:
            lines.append(f"{key} = {val}")
    return "\n".join(lines)


def multi_cfg(raw, **train):
    raw = json.loads(json.dumps(raw))
    raw["train"].update(train)
    return tconfig.from_dict(raw)


def scan_indices(i, n_img, steps, first=0):
    """Scan i's views of steps [first, first + steps): its own permutation
    stream, np.random.RandomState(i), as the multi-scan runners take it."""
    rng = np.random.RandomState(i)
    perm = rng.permutation(n_img)
    out = []
    for step in range(first + steps):
        if step >= first:
            out.append(perm[step % n_img])
        if (step + 1) % n_img == 0:
            perm = rng.permutation(n_img)
    return torch.tensor(out)


def metric_rows(runner):
    with open(os.path.join(runner.base_exp_dir, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def single_run(cfg, scene_dir, seed, idxs, *, is_finetune=False, blending=False, ckpt=None,
               exp_dir=None):
    """A single-scan Runner(seed) through its windows of W, fed views idxs;
    returns the runner and its metric rows (dicts)."""
    cfg = dataclasses.replace(
        cfg, dataset=dataclasses.replace(cfg.dataset, data_dir=scene_dir),
        general=dataclasses.replace(cfg.general, base_exp_dir=exp_dir or cfg.general.base_exp_dir))
    r = Runner(cfg, device="cpu", seed=seed, is_finetune=is_finetune)
    if ckpt:
        r.load_checkpoint(ckpt)
    rows = []
    for w in range(0, len(idxs), W):
        scheds = [r._schedules_at(r.iter_step + j) for j in range(W)]
        sched_rows = torch.from_numpy(schedules.schedule_rows(scheds))
        mat = r._get_window_fn(blending, W)(r.params, r.opt_state, r.dataset.scene,
                                            idxs[w:w + W], r.generator, sched_rows)
        rows += [{"iter": r.iter_step + 1 + j, **dict(zip(tstep.METRIC_KEYS, mat[j].tolist()))}
                 for j in range(W)]
        r.iter_step += W
    return r, rows


def assert_same_scan(a, b):
    """Parameters, optimizer state and generator of two runners, bit for bit."""
    for tree_a, tree_b in ((a.params, b.params), (a.opt_state, b.opt_state)):
        for (path, x), (_, y) in zip(leaves(tree_a), leaves(tree_b)):
            assert torch.equal(x.detach(), y.detach()), path
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# Tolerances against the JAX window, over 4 steps of both scans, stage 1
# (uniform samples) and blending (the gather sampler on both sides): the
# window test's, rtol 1e-4 and atol 1e-6 (f32 on both sides, sums in
# another order), but for
# sparse_error is exp(-25000 udf) summed over the samples near the
# surface: the f32 rounding by which the two frameworks' fields part in
# the later steps of the window (~1e-7 in udf) moves it by 25000 times as
# much (3.0e-3 measured in stage 1, 7.4e-3 in the blending window: 3e-7 in
# udf; tests/test_torch_step.py holds it at 5e-3 after one step for the same
# reason). The step's loss reads it with sparse_weight 0 here.
TOL_JAX_WINDOW = dict(rtol=1e-4, atol=1e-6)
SPARSE_TOL = {"sparse_error": dict(rtol=1e-2)}


@pytest.mark.parametrize("mode", ["stage1", "blending"])
def test_multi_scan_window_matches_jax(scan_dirs, tmp_path, mode):
    """A window of 4 steps of 2 scans from JAX's stacked initialisation
    (seeds 0 and 1, converted), steps 8-11 of the schedule (the lr and
    cos_anneal_ratio change every step), each scan at each step on the draws
    of its key of JAX's window (keys [W, S, 2]): the metric rows [W, S, M]
    within TOL_JAX_WINDOW (SPARSE_TOL for sparse_error)."""
    first = 8
    blending = mode == "blending"
    if blending:
        raw = blending_raw(scan_dirs[0], str(tmp_path), "gather", end_iter=first + W)
        raw["train"].update(report_freq=W, save_freq=0, val_freq=0, val_mesh_freq=3000 * W)
    else:
        raw = small_raw(scan_dirs[0], str(tmp_path), end_iter=first + W, freq=W)
    jcfg, tcfg = jconfig.from_dict(raw), tconfig.from_dict(raw)
    params_j, opt_j = jms.stack_params(jcfg, S, seed=0)
    params_j["nerf"]["alpha"]["b"] = params_j["nerf"]["alpha"]["b"] + 1.0
    jds = [JDataset(dataclasses.replace(jcfg.dataset, data_dir=d)) for d in scan_dirs]

    c = tcfg.color_loss
    scheds = [schedules.compute_step_schedules(
        first + j, tcfg.train, c.color_base_weight, c.color_weight, c.color_pixel_weight,
        c.color_patch_weight, is_finetune=blending, reg_weights_schedule=False,
        same_lr=False, beta_trainable=True, variance_trainable=True) for j in range(W)]
    assert all(schedules.is_blending(s) == blending for s in scheds)
    rows = torch.from_numpy(np.stack([schedules.schedule_rows([s] * S) for s in scheds]))
    idxs = torch.tensor([[(first + j + i) % 4 for i in range(S)] for j in range(W)])
    keys = jax.random.split(jax.random.PRNGKey(5), W * S).reshape(W, S, 2)

    mesh = make_mesh(S)
    window_j = jms.build_multi_scan_window(jcfg, JRenderer(jcfg.model), mesh, blending=blending)
    stacked = {key: rows[..., n].numpy() for n, key in enumerate(schedules.SCHEDULE_KEYS)}
    with mesh:
        _, _, want = window_j(params_j, opt_j, jms.stack_scenes(jds),
                              jnp.stack([d.ref_src_pairs for d in jds]),
                              jnp.asarray(idxs.numpy(), jnp.int32), keys, stacked)
    want = np.stack([np.asarray(want[name]) for name in tstep.METRIC_KEYS], axis=-1)

    scenes = [tconfig_scene(tcfg, d) for d in scan_dirs]
    params = [convert.params_from_jax(jax.tree_util.tree_map(lambda x: np.asarray(x[i]),
                                                             params_j)) for i in range(S)]
    noise = [[jax_noise(keys[j, i], tcfg.train.batch_size, 40, 48,
                        tcfg.model.udf_renderer.n_outside) for i in range(S)] for j in range(W)]
    window = build_multi_scan_window(tcfg, TRenderer(tcfg.model), blending=blending, window=W,
                                     n_scans=S)
    got = window(params, [init_adam_state(p) for p in params], scenes, idxs, [None] * S, rows,
                 noise=noise).numpy()
    assert got.shape == (W, S, len(tstep.METRIC_KEYS))
    for m, name in enumerate(tstep.METRIC_KEYS):
        np.testing.assert_allclose(got[..., m], want[..., m], err_msg=name,
                                   **dict(TOL_JAX_WINDOW, **SPARSE_TOL.get(name, {})))
    if blending:
        pix = tstep.METRIC_KEYS.index("color_pixel_loss")
        assert (got[..., pix] > 0).all()
    # the two scans are different runs
    assert not np.allclose(got[:, 0], got[:, 1])


def tconfig_scene(cfg, scene_dir):
    from neuraludf_tpu_torch.data.dataset import Dataset

    return Dataset(dataclasses.replace(cfg.dataset, data_dir=scene_dir), "cpu").scene


@pytest.mark.parametrize("mode,n_scans", [
    pytest.param("windows", S, id="windows"),
    pytest.param("one_at_a_time", S, id="one_at_a_time"),
    pytest.param("windows", 1, id="windows-one_scan"),
    pytest.param("one_at_a_time", 1, id="one_at_a_time-one_scan"),
])
def test_scans_equal_single_runners_bit_for_bit(scan_dirs, tmp_path, mode, n_scans):
    """8 iterations of 2 scans (or of a campaign of one scan): in windows of
    4 (stage 1; on a card one graph replay an iteration of every scan), or
    one step at a time (a finetune with train.blend_scan_window off: the
    blending fallback). Scan i's metric rows, parameters, optimizer state
    and generator state equal those of a single-scan Runner(seed=i) through
    its window of 4, fed scan i's views, bit for bit."""
    blending = mode == "one_at_a_time"
    if blending:
        raw = blending_raw(scan_dirs[0], str(tmp_path / "single"), "gather", end_iter=2 * W)
        raw["train"].update(report_freq=W, save_freq=0, val_freq=0, val_mesh_freq=3000)
    else:
        raw = small_raw(scan_dirs[0], str(tmp_path / "single"), end_iter=2 * W, freq=W)
    cfg = multi_cfg(raw, blend_scan_window=not blending)
    ms = MultiScanRunner(cfg, scan_dirs[:n_scans], out_dir=str(tmp_path / "ms"), seed=0,
                         device="cpu", is_finetune=blending)
    ms.train()
    assert ms.iter_step == 2 * W
    assert ms._window_fns == {} if blending else set(ms._window_fns) == {(False, W, 1)}
    for i, d in enumerate(scan_dirs[:n_scans]):
        single, rows = single_run(cfg, d, i, scan_indices(i, 4, 2 * W), is_finetune=blending,
                                  blending=blending, exp_dir=str(tmp_path / f"single{i}"))
        assert metric_rows(ms.scans[i]) == rows
        assert_same_scan(ms.scans[i], single)
    if n_scans > 1:
        assert metric_rows(ms.scans[0])[-1]["loss"] != metric_rows(ms.scans[1])[-1]["loss"]
    if blending:
        assert all(r["color_pixel_loss"] > 0 for r in metric_rows(ms.scans[0]))


def test_sweep_from_the_command_line(scan_dirs, tmp_path):
    """``--sweep sparse_weight=0,0.5`` over the sphere: two scans, named
    after their values, each equal bit for bit to a single Runner(seed=i)
    whose configuration has that sparse_weight, fed scan i's views; each
    ends in its closing mesh."""
    raw = small_raw(os.path.join(os.path.dirname(scan_dirs[0]), "CASE_NAME"), str(tmp_path),
                    end_iter=W, freq=W)
    conf = tmp_path / "sweep.conf"
    conf.write_text(hocon_text(raw))
    out = str(tmp_path / "out")
    meshes = train_multi_scan.main(["--conf", str(conf), "--cases", "sphere", "--sweep",
                                    "sparse_weight=0,0.5", "--end_iter", str(W), "--device",
                                    "cpu", "--out_dir", out, "--final_mesh_resolution", "32"])
    cases = ["sphere_sparse_weight0", "sphere_sparse_weight0.5"]
    assert sorted(os.listdir(out)) == cases
    assert [os.path.basename(os.path.dirname(os.path.dirname(m))) for m in meshes] == cases
    assert all(os.path.getsize(m) > 0 for m in meshes)
    cfg = tconfig.load(str(conf), case="sphere", train__end_iter=W)
    finals = []
    for i, (case, value) in enumerate(zip(cases, (0.0, 0.5))):
        cfg_i = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, sparse_weight=value))
        single, rows = single_run(cfg_i, scan_dirs[0], i, scan_indices(i, 4, W),
                                  exp_dir=str(tmp_path / f"single{i}"))
        saved = convert.load_checkpoint(os.path.join(out, case, "checkpoints", "ckpt_000004.ckpt"))
        for (path, a), (_, b) in zip(leaves(saved["params"]), leaves(single.params)):
            assert torch.equal(a, b.detach()), (case, path)
        with open(os.path.join(out, case, "logs", "metrics.jsonl")) as f:
            assert [json.loads(line) for line in f] == rows
        finals.append(rows[-1]["loss"])
    assert finals[0] != finals[1]


def test_checkpoint_resume_and_crash_checkpoints(scan_dirs, tmp_path):
    """12 iterations straight against 8, then a resume: checkpoints every 4
    and a validation render every 8 per scan; before the resume scan 1
    loses its checkpoint of 8 and every scan gets a newer crash_*
    checkpoint, so the newest common checkpoint is 4; the resumed runner
    replays the image streams and ends where the uninterrupted one does, bit
    for bit. A plain Runner loads a scan's checkpoint; both runners report."""
    raw = small_raw(scan_dirs[0], str(tmp_path), end_iter=3 * W, freq=W)
    cfg = multi_cfg(raw, save_freq=W, val_freq=2 * W)
    hooks = []
    whole = MultiScanRunner(cfg, scan_dirs, out_dir=str(tmp_path / "whole"), device="cpu")
    whole.train(report_hook=lambda it, m: hooks.append((it, m)))
    assert [it for it, _ in hooks] == [4, 8, 12]
    assert hooks[-1][1]["loss"].shape == (S,) and np.isfinite(hooks[-1][1]["loss"]).all()
    for r in whole.scans:
        assert len(os.listdir(os.path.join(r.base_exp_dir, "validations_fine"))) == 1

    part_dir = str(tmp_path / "part")
    part = MultiScanRunner(multi_cfg(raw, save_freq=W, val_freq=2 * W, end_iter=2 * W),
                           scan_dirs, out_dir=part_dir, device="cpu")
    part.train()
    ckpts = [os.path.join(part_dir, os.path.basename(d), "checkpoints") for d in scan_dirs]
    assert all(sorted(os.listdir(c)) == ["ckpt_000004.ckpt", "ckpt_000008.ckpt"] for c in ckpts)
    part.iter_step = 2 * W + 4  # a crash at 12: saved for autopsy, never resumed from
    for r in part.scans:
        r.iter_step = part.iter_step
    part.save_checkpoints(prefix="crash")
    os.remove(os.path.join(ckpts[1], "ckpt_000008.ckpt"))
    resumed = MultiScanRunner(cfg, scan_dirs, out_dir=part_dir, device="cpu", is_continue=True)
    assert resumed.iter_step == W
    resumed.train()
    assert resumed.iter_step == 3 * W
    for a, b in zip(resumed.scans, whole.scans):
        assert_same_scan(a, b)
        assert metric_rows(a)[-2 * W:] == metric_rows(b)[-2 * W:]

    single_cfg = dataclasses.replace(
        cfg, general=dataclasses.replace(cfg.general, base_exp_dir=str(tmp_path / "plain")))
    plain = Runner(single_cfg, device="cpu")
    plain.load_checkpoint(os.path.join(whole.scans[0].base_exp_dir, "checkpoints",
                                       "ckpt_000012.ckpt"))
    assert plain.iter_step == 3 * W
    assert_same_scan(plain, whole.scans[0])
    # the plain runner continues past it, reporting as the JAX runner does
    plain.end_iter = 4 * W
    reports = []
    plain.train(report_hook=lambda it, m: reports.append((it, m["loss"])))
    assert [it for it, _ in reports] == [16] and np.isfinite(reports[0][1])


def test_sweep_and_scene_checks(scan_dirs, tmp_path):
    """A train override that does not reach the step through its schedule
    row, and scenes of another resolution, are refused."""
    cfg = multi_cfg(small_raw(scan_dirs[0], str(tmp_path)))
    assert "batch_size" not in SWEEPABLE_TRAIN_FIELDS
    with pytest.raises(ValueError, match="batch_size"):
        MultiScanRunner(cfg, [scan_dirs[0]] * 2, case_names=["a", "b"], device="cpu",
                        out_dir=str(tmp_path / "bad"), train_overrides=[{}, {"batch_size": 8}])
    other = str(tmp_path / "small_sphere")
    generate_scene(other, kind="sphere", n_views=4, H=32, W=48, focal=64.0)
    with pytest.raises(ValueError, match="resolution and view count"):
        MultiScanRunner(cfg, [scan_dirs[0], other], device="cpu", out_dir=str(tmp_path / "b"))
    with pytest.raises(SystemExit, match="exactly one"):
        train_multi_scan.main(["--conf", "x.conf", "--cases", "a", "b", "--sweep", "lr=1,2"])
    shutil.rmtree(other)
