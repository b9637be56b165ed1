"""The port's training window (``train/step.py`` ``build_train_window``) on
the CPU, at the small config of ``tests/test_torch_trajectory.py``.

On a CUDA device the window replays a captured graph of its step bodies
over static buffers; on the CPU the same bodies run eagerly on the same
buffers, so everything but the capture is held here (``chip_smoke.py``
holds the graph on the card):

- the window against the eager per-step loop, bit for bit, for stage 1 and
  for a blending window (the card's strip sampler, its plain version here),
  on one generator seed, which both consume alike;
- no step body inside a window makes a tensor from host data or reads a
  tensor on the host: either breaks a CUDA graph capture (a host copy is
  not allowed while a stream captures, a host read waits for the device);
- a window of 4 against the JAX package's ``build_train_window`` on the
  draws of its keys: the metric rows and the UDF at probe points;
- ``unroll = 2`` against ``unroll = 1``, and an ``unroll`` that does not
  divide the window (counterparts of ``tests/test_scan_unroll.py``);
- ``Runner.train`` across the step where blending switches on (a boundary
  window, stepped one at a time) against the same run in windows of one;
- a checkpoint loaded into a runner that has trained past it (its windows
  are dropped, as their graphs hold the replaced tensors) continues as the
  uninterrupted run does.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraludf_tpu import config as jconfig
from neuraludf_tpu.data.dataset import Dataset as JDataset
from neuraludf_tpu.nets import fields as jf
from neuraludf_tpu.render.renderer import UDFRenderer as JRenderer
from neuraludf_tpu.train import optim as joptim
from neuraludf_tpu.train import runner as jrunner
from neuraludf_tpu.train import step as jstep
from neuraludf_tpu_torch import config as tconfig
from neuraludf_tpu_torch import convert
from neuraludf_tpu_torch.nets import fields as tf
from neuraludf_tpu_torch.train import schedules
from neuraludf_tpu_torch.train import step as tstep
from neuraludf_tpu_torch.train.optim import init_adam_state, leaves
from neuraludf_tpu_torch.train.runner import Runner
from test_torch_step import SAMPLING, blending_raw, jax_noise, raw_config, scene_dir  # noqa: F401
from test_torch_trajectory import SCHEDULE, TOL_TRAJECTORY, probe_points

N_STEPS = 8


def small_raw(scene_dir, exp_dir, *, blending=False, end_iter=N_STEPS, freq=N_STEPS):
    """The trajectory test's config (uniform samples), or its blending
    twin with the strip sampler; every periodic frequency ``freq`` (the
    window), nothing rendered or saved."""
    raw = (blending_raw(scene_dir, exp_dir, "strip", end_iter) if blending
           else raw_config(scene_dir, exp_dir, end_iter))
    if not blending:
        raw["model"]["udf_renderer"] = dict(SAMPLING["uniform_samples"][0])
    raw["train"].update(SCHEDULE, report_freq=freq, save_freq=0, val_freq=0,
                        val_mesh_freq=3000 * freq)
    return raw


def window_inputs(runner, k, first=0):
    scheds = [runner._schedules_at(first + j) for j in range(k)]
    rows = torch.from_numpy(schedules.schedule_rows(scheds))
    idxs = (torch.arange(k) + first) % runner.dataset.n_images
    return scheds, rows, idxs


def state_of(runner):
    return [t.detach().clone() for tree in (runner.params, runner.opt_state)
            for _, t in leaves(tree)]


def assert_same_state(a, b):
    for x, y in zip(state_of(a), state_of(b)):
        assert torch.equal(x, y)


def metric_log(runner):
    path = runner.base_exp_dir + "/logs/metrics.jsonl"
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("blending", [False, True], ids=["stage1", "blending"])
def test_window_equals_eager_loop_bit_for_bit(scene_dir, tmp_path, blending):  # noqa: F811
    """8 steps through the window and through the eager body, from one
    initialisation and one generator seed: the same metric rows, parameters,
    optimizer state and generator state, bit for bit (the same operations on
    the same values in the same order)."""
    cfg = tconfig.from_dict(small_raw(scene_dir, str(tmp_path), blending=blending))
    win, eager = (Runner(cfg, device="cpu", seed=3, is_finetune=blending) for _ in range(2))
    scheds, rows, idxs = window_inputs(win, N_STEPS)
    assert all(schedules.is_blending(s) == blending for s in scheds)
    # the lr and cos_anneal_ratio change in every step: a value left out of
    # the schedule row would show
    assert len({s.lr_main for s in scheds}) == len({s.cos_anneal_ratio for s in scheds}) == N_STEPS

    got = win._get_window_fn(blending, N_STEPS)(win.params, win.opt_state, win.dataset.scene,
                                                idxs, win.generator, rows)
    body = eager.step_body(scheds[0])
    want = []
    for j in range(N_STEPS):
        m = body(eager.params, eager.opt_state, eager.dataset.scene, idxs[j], rows[j],
                 eager.generator)
        want.append(torch.stack([m[k] for k in tstep.METRIC_KEYS]))
    assert torch.equal(got, torch.stack(want))
    assert_same_state(win, eager)
    assert torch.equal(win.generator.get_state(), eager.generator.get_state())
    if blending:
        pix = tstep.METRIC_KEYS.index("color_pixel_loss")
        assert bool((got[:, pix] > 0).all())
    assert bool(torch.isfinite(got).all())


# Operators that make a tensor from host data (lift_fresh: torch.tensor or
# as_tensor of numbers or arrays) or read a tensor's value on the host
# (item / _local_scalar_dense: float(), a tensor in an ``if``, indexing by
# a tensor scalar, torch.cumprod's backward test for zeros; nonzero). They
# are found with the profiler, which changes nothing in how the operators
# run: a Python dispatch mode would (torch's backward formulas take their
# host-free branches under one). One is let through: the CPU's LAPACK
# solve inside ``torch.linalg.inv_ex`` (the blending step's camera
# inverses) reads a value on the host; the CUDA version does not, and the
# finetune window's capture on the card holds it (chip_smoke.py [window]).
HOST_TRAFFIC = {"aten::lift_fresh", "aten::item", "aten::_local_scalar_dense", "aten::nonzero"}
CPU_ONLY = "aten::linalg_inv_ex"


def host_traffic(fn) -> list:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    seen = []
    for e in prof.events():
        parents, p = [], e.cpu_parent
        while p is not None:
            parents.append(p.name)
            p = p.cpu_parent
        if e.name in HOST_TRAFFIC and CPU_ONLY not in parents:
            seen.append(e.name)
    return seen


@pytest.mark.parametrize("blending", [False, True], ids=["stage1", "blending"])
def test_window_body_makes_no_host_tensor_or_read(scene_dir, tmp_path, blending):  # noqa: F811
    """After its first unit (the warm-up, which may make the cached
    constants), a window's step bodies, forward, backward and Adam, neither
    copy host data to the device nor read the device on the host."""
    cfg = tconfig.from_dict(small_raw(scene_dir, str(tmp_path), blending=blending, end_iter=2))
    runner = Runner(cfg, device="cpu", seed=0, is_finetune=blending)
    _, rows, idxs = window_inputs(runner, 2)
    window_fn = runner._get_window_fn(blending, 2)
    window_fn(runner.params, runner.opt_state, runner.dataset.scene, idxs, runner.generator, rows)
    assert host_traffic(lambda: window_fn._unit(runner.params, runner.opt_state,
                                                runner.dataset.scene)) == []
    # what it must see: a host tensor, a host read, torch.cumprod's backward
    x = torch.rand(2, 3, requires_grad=True)
    seen = host_traffic(lambda: (torch.as_tensor(0.5) + float(torch.ones(())),
                                 torch.autograd.grad(torch.cumprod(x, -1).sum(), x)))
    assert seen.count("aten::lift_fresh") == 1 and seen.count("aten::_local_scalar_dense") == 2


def test_window_matches_jax_window(scene_dir, tmp_path):  # noqa: F811
    """A window of 4 from one converted JAX initialisation, steps 8-11 of
    the schedule (across warm_up_end = 10: the lr and cos_anneal_ratio
    change every step), each step on the draws of its key of JAX's window
    (``jax.random.split(base_key, 4)``): the metric rows within the one-step
    tolerance of tests/test_torch_step.py (rtol 1e-4, atol 1e-6: f32 on both
    sides, sums in another order) and the UDF at the probe points after the
    window within the trajectory test's uniform-sample tolerance."""
    k, first = 4, 8
    raw = small_raw(scene_dir, str(tmp_path), end_iter=first + k, freq=k)
    jcfg, tcfg = jconfig.from_dict(raw), tconfig.from_dict(raw)
    params_j = jrunner.init_params(jax.random.PRNGKey(0), jcfg)
    params_j["nerf"]["alpha"]["b"] = params_j["nerf"]["alpha"]["b"] + 1.0
    runner = Runner(tcfg, device="cpu", seed=0)
    runner.params = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    runner.opt_state = init_adam_state(runner.params)
    scheds, rows, idxs = window_inputs(runner, k, first)
    base_key = jax.random.PRNGKey(5)
    keys = jax.random.split(base_key, k)
    noise = [jax_noise(keys[j], tcfg.train.batch_size, runner.dataset.H, runner.dataset.W,
                       tcfg.model.udf_renderer.n_outside) for j in range(k)]
    got = runner._get_window_fn(False, k)(runner.params, runner.opt_state, runner.dataset.scene,
                                          idxs, None, rows, noise=noise).numpy()

    jds = JDataset(jcfg.dataset)
    window_j = jstep.build_train_window(jcfg, JRenderer(jcfg.model), blending=False, window=k)
    stacked = {key: rows[:, i].numpy() for i, key in enumerate(schedules.SCHEDULE_KEYS)}
    params_j, _, want = window_j(params_j, joptim.init_adam_state(params_j), jds.scene,
                                 jds.ref_src_pairs, jnp.asarray(idxs.numpy(), jnp.int32),
                                 base_key, stacked)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-6)

    pts = probe_points()
    with torch.no_grad():
        u_t = tf.distance_field_apply(runner.params["udf"], torch.tensor(pts),
                                      tcfg.model.udf_network)[:, 0].numpy()
    u_j = np.asarray(jf.distance_field_apply(params_j["udf"], jnp.asarray(pts),
                                             jcfg.model.udf_network)[:, 0])
    span = float(u_j.max() - u_j.min())
    np.testing.assert_allclose(u_t / span, u_j / span, rtol=0,
                               atol=TOL_TRAJECTORY["uniform_samples"]["udf"])


def test_unroll_two_equals_unroll_one(scene_dir, tmp_path):  # noqa: F811
    """unroll = 2 (two step bodies a graph on the card) is a scheduling
    choice: on the CPU the same operations run in the same order, so the
    rows and the state agree bit for bit (JAX's unrolled scan only to
    rtol 2e-4, tests/test_scan_unroll.py)."""
    cfg = tconfig.from_dict(small_raw(scene_dir, str(tmp_path), end_iter=4, freq=4))
    runs = []
    for unroll in (1, 2):
        runner = Runner(cfg, device="cpu", seed=1)
        _, rows, idxs = window_inputs(runner, 4)
        window_fn = tstep.build_train_window(cfg, runner.renderer, blending=False, window=4,
                                             unroll=unroll)
        runs.append((window_fn(runner.params, runner.opt_state, runner.dataset.scene, idxs,
                               runner.generator, rows), runner))
    (rows1, r1), (rows2, r2) = runs
    assert torch.equal(rows1, rows2)
    assert_same_state(r1, r2)


def test_unroll_must_divide_window(scene_dir, tmp_path):  # noqa: F811
    cfg = tconfig.from_dict(small_raw(scene_dir, str(tmp_path)))
    renderer = Runner(cfg, device="cpu").renderer
    with pytest.raises(ValueError, match="must divide"):
        tstep.build_train_window(cfg, renderer, blending=False, window=4, unroll=3)
    tstep.build_train_window(cfg, renderer, blending=False, window=4, unroll=4)


def test_blending_switch_in_a_window_steps_one_at_a_time(scene_dir, tmp_path):  # noqa: F811
    """Stage 1 with blending weights: blending switches on at iteration
    10,001 (the colour ramp of 10k-20k). From 9,998, windows of 4: the first
    crosses the switch and steps one iteration at a time with each step's
    body, the second is a full blending window. The same run in windows of
    one gives the same metric rows, bit for bit."""
    logs = []
    for freq in (4, 1):
        raw = blending_raw(scene_dir, str(tmp_path / f"w{freq}"), "auto", end_iter=10_006)
        raw["train"].update(report_freq=freq, save_freq=0, val_freq=0, val_mesh_freq=12_000)
        runner = Runner(tconfig.from_dict(raw), device="cpu", seed=2)
        runner.iter_step = 9_998
        runner.train()
        assert runner.iter_step == 10_006
        bodies = set(runner._step_bodies) | {key[:2] for key in runner._window_fns}
        logs.append((metric_log(runner), bodies))
    (rows4, bodies4), (rows1, bodies1) = logs
    assert bodies4 == {False, True, (True, 4)}  # eager steps of both bodies, one window
    assert bodies1 == {(False, 1), (True, 1)}
    assert [r["iter"] for r in rows4] == list(range(9_999, 10_007))
    assert rows4 == rows1
    pix = [r["color_pixel_loss"] for r in rows4]
    assert pix[:3] == [0.0, 0.0, 0.0] and all(p > 0 for p in pix[3:])


def test_checkpoint_load_continues_as_uninterrupted(scene_dir, tmp_path):  # noqa: F811
    """12 steps in windows of 4, checkpoints every 4. A second runner trains
    8, then loads the checkpoint of step 4, which replaces its parameters
    and optimizer state: its windows are dropped (on a card their graphs
    hold the replaced tensors) and the 8 steps to 12 give the uninterrupted
    run's rows and state, bit for bit."""
    raw = small_raw(scene_dir, str(tmp_path / "a"), end_iter=12, freq=4)
    raw["train"]["save_freq"] = 4
    whole = Runner(tconfig.from_dict(raw), device="cpu", seed=4)
    whole.train()

    raw["general"]["base_exp_dir"] = str(tmp_path / "b")
    again = Runner(tconfig.from_dict(raw), device="cpu", seed=4)
    again.end_iter = 8
    again.train()
    window_fn = again._window_fns[(False, 4, 1)]
    again.load_checkpoint(again._ckpt_dir() + "/ckpt_000004.ckpt")
    assert again.iter_step == 4 and again._window_fns == {}
    again.end_iter = 12
    again.train()
    assert again._window_fns[(False, 4, 1)] is not window_fn
    assert metric_log(again)[-8:] == metric_log(whole)[-8:]
    assert_same_state(again, whole)
