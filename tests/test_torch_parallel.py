"""Ray data parallelism in the port (``neuraludf_tpu_torch/parallel/sharding.py``)
on the CPU: two processes over gloo, each rendering half of every batch.

- one ray-parallel step of two ranks against the port's single step on the
  same state and draws, for stage 1, blending (pixel and SSIM patch losses:
  the patch loss's top-k is taken over the whole batch) and a batch drawn
  3/4 from the mask: the loss to rtol 1e-5 and the parameters to rtol
  1e-4, atol 1e-6, the tolerances the JAX package holds its own DP step to
  (``tests/test_parallel.py``); both ranks hold the same parameters, bit for
  bit;
- one rank over gloo (its gathers and all-reduce copies) against the single
  step, bit for bit, stage 1 and blending;
- the stage-1 step against the JAX package's ``build_parallel_train_step``
  on the draws of its key;
- ``shard_grid_query``: each rank fills its slice of the points and the
  slices are all-gathered;
- the importance draw (``data.dataset.draw_pixels`` / ``mask_pixels``)
  against the JAX package's ``_draw_pixels`` on the same uniform numbers,
  and its property (3/4 of the batch in the mask, ``tests/test_parallel.py``).

The ranks are this file run as a script (``--worker``), each with its own
deadline: a group that does not finish in ``DEADLINE_S`` is killed and the
test fails.
"""

import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from neuraludf_tpu import config as jconfig  # noqa: E402
from neuraludf_tpu.data import dataset as jdataset  # noqa: E402
from neuraludf_tpu.data.dataset import Dataset as JDataset  # noqa: E402
from neuraludf_tpu.parallel.sharding import build_parallel_train_step as j_dp_step  # noqa: E402
from neuraludf_tpu.parallel.sharding import make_mesh  # noqa: E402
from neuraludf_tpu.render.renderer import UDFRenderer as JRenderer  # noqa: E402
from neuraludf_tpu.train import optim as joptim  # noqa: E402
from neuraludf_tpu.train import runner as jrunner  # noqa: E402
from neuraludf_tpu_torch import config as tconfig  # noqa: E402
from neuraludf_tpu_torch import convert  # noqa: E402
from neuraludf_tpu_torch.data import dataset as tdataset  # noqa: E402
from neuraludf_tpu_torch.data.dataset import Dataset as TDataset  # noqa: E402
from neuraludf_tpu_torch.nets import fields  # noqa: E402
from neuraludf_tpu_torch.render.renderer import UDFRenderer as TRenderer  # noqa: E402
from neuraludf_tpu_torch.train import step as tstep  # noqa: E402
from neuraludf_tpu_torch.train.optim import init_adam_state, leaves  # noqa: E402

DEADLINE_S = 240  # a spawned group's limit (two ranks of a small step take ~10 s)
WORLD = 2
N_GRID = 1001  # points of the grid query (not a multiple of the world size)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(spec_path: str, world: int = WORLD) -> None:
    """Runs this file's worker on spec_path as ranks 0..world-1 of a gloo
    group on localhost; kills them and fails when the group outlives its
    deadline or a rank fails."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", spec_path],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=DEADLINE_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the rank group did not finish in {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def worker(spec_path: str) -> None:
    """One rank: the ray-parallel step on the spec's state, view, schedule
    and draws, and the sharded grid query; writes what it got beside the
    spec."""
    import torch.distributed as dist

    from neuraludf_tpu_torch.parallel import multihost
    from neuraludf_tpu_torch.parallel.sharding import build_parallel_train_step, shard_grid_query

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    multihost.initialize("cpu")
    rank = dist.get_rank()
    cfg = tconfig.from_dict(spec["raw"])
    scene = TDataset(cfg.dataset, "cpu").scene
    params = convert.to_torch(spec["params"], requires_grad=True)
    opt_state = init_adam_state(params)
    step = build_parallel_train_step(cfg, TRenderer(cfg.model), blending=spec["blending"])
    noise = {k: torch.from_numpy(v) for k, v in spec["noise"].items()}
    metrics = step(params, opt_state, scene, spec["img_idx"], spec["sched"], noise=noise)
    ucfg = cfg.model.udf_network
    query = shard_grid_query(lambda p, pts: fields.distance_value(p, pts, ucfg)[:, 0])
    with torch.no_grad():
        grid = query(params["udf"], torch.from_numpy(spec["grid_points"]))
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": convert.to_numpy(params), "grid": grid.numpy()}
    if spec.get("single"):  # the single step in this process: its thread count
        params = convert.to_torch(spec["params"], requires_grad=True)
        body = tstep.build_step_body(cfg, TRenderer(cfg.model), blending=spec["blending"])
        metrics = body(params, init_adam_state(params), scene, spec["img_idx"], spec["sched"],
                       noise=noise)
        out["single"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                         "params": convert.to_numpy(params)}
    with open(spec_path + f".rank{rank}", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from neuraludf_tpu.data.synthetic import generate_scene

    d = tmp_path_factory.mktemp("torch_parallel") / "sphere"
    generate_scene(str(d), kind="sphere", n_views=4, H=40, W=48, focal=64.0)
    return str(d)


def case_raw(scene_dir, exp_dir, case):
    from test_torch_step import blending_raw, raw_config

    if case == "blending":
        # the gather sampler: the strip sampler's top-k rounds differ in
        # nothing that a ray split could change, and gather is exact
        return blending_raw(scene_dir, exp_dir, "gather")
    return raw_config(scene_dir, exp_dir)


def dp_against_single(scene_dir, tmp_path, case, params_np, noise, sched, img_idx=1,
                      world=WORLD):
    """The ranks' results, and the single port step's, on the same inputs."""
    raw = case_raw(scene_dir, str(tmp_path / "exp"), case)
    blending = case == "blending"
    spec = {"raw": raw, "blending": blending, "params": params_np, "sched": sched,
            "img_idx": img_idx, "noise": {k: v.numpy() for k, v in noise.items()},
            "single": world == 1,
            "grid_points": np.random.RandomState(3).uniform(-1, 1, (N_GRID, 3)).astype(np.float32)}
    spec_path = str(tmp_path / "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    run_ranks(spec_path, world)
    ranks = []
    for r in range(world):
        with open(spec_path + f".rank{r}", "rb") as f:
            ranks.append(pickle.load(f))

    cfg = tconfig.from_dict(raw)
    scene = TDataset(cfg.dataset, "cpu").scene
    params = convert.to_torch(params_np, requires_grad=True)
    body = tstep.build_step_body(cfg, TRenderer(cfg.model), blending=blending)
    metrics = body(params, init_adam_state(params), scene, img_idx, sched, noise=noise)
    return ranks, metrics, params, cfg, spec


def sched_at(raw, step, is_finetune):
    from test_torch_step import sched_at as _sched_at

    return _sched_at(tconfig.from_dict(raw), step, is_finetune)


def dp_case(scene_dir, tmp_path, case, world=WORLD):
    """The ray-parallel step of ``world`` ranks and the single step on one
    seeded state and draw of ``case``, and that start state."""
    raw = case_raw(scene_dir, str(tmp_path / "exp"), case)
    cfg = tconfig.from_dict(raw)
    gen = torch.Generator().manual_seed(7)
    params = jrunner.init_params(jax.random.PRNGKey(0), jconfig.from_dict(raw))
    params["nerf"]["alpha"]["b"] = params["nerf"]["alpha"]["b"] + 1.0
    params_np = jax.tree_util.tree_map(np.asarray, params)
    scene = TDataset(cfg.dataset, "cpu").scene
    noise = tstep.draw_noise(cfg, scene, gen, importance_sample=case == "importance")
    sched = sched_at(raw, 5, is_finetune=case == "blending")
    return dp_against_single(scene_dir, tmp_path, case, params_np, noise, sched,
                             world=world) + (params_np,)


@pytest.mark.parametrize("case", ["stage1", "blending", "importance"])
def test_dp_step_matches_single_step(scene_dir, tmp_path, case):
    """Two ranks of the ray-parallel step against the single step: loss rtol
    1e-5, parameters rtol 1e-4 / atol 1e-6, the same parameters on both
    ranks bit for bit, the grid query's slices joined."""
    ranks, metrics, single, cfg, spec, params_np = dp_case(scene_dir, tmp_path, case)

    for name in tstep.METRIC_KEYS:
        np.testing.assert_allclose(ranks[0]["metrics"][name], float(metrics[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    if case == "blending":
        assert ranks[0]["metrics"]["color_patch_loss"] > 0
        assert ranks[0]["metrics"]["color_pixel_loss"] > 0
    for (path, a), (_, b) in zip(leaves(ranks[0]["params"]), leaves(ranks[1]["params"])):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    for (path, a), (_, b) in zip(leaves(ranks[0]["params"]), leaves(convert.to_numpy(single))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=str(path))
    # the parameters moved: an update was made
    moved = [np.abs(a - b).max() for (_, a), (_, b) in zip(leaves(ranks[0]["params"]),
                                                          leaves(params_np))]
    assert max(moved) > 0

    with torch.no_grad():
        want = fields.distance_value(single["udf"], torch.from_numpy(spec["grid_points"]),
                                     cfg.model.udf_network)[:, 0].numpy()
    # the same points, products of another row count: f32 rounding only
    for r in ranks:
        assert r["grid"].shape == (N_GRID,)
        np.testing.assert_allclose(r["grid"], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["stage1", "blending"])
def test_dp_step_of_one_rank_is_the_single_step(scene_dir, tmp_path, case):
    """One rank of the ray-parallel step over gloo (the gathers and the flat
    all-reduce run, over one process they copy) against the single step in
    the same process (a CPU reduction's order follows the thread count):
    metrics and parameters bit for bit."""
    ranks = dp_case(scene_dir, tmp_path, case, world=1)[0]
    assert ranks[0]["metrics"] == ranks[0]["single"]["metrics"]
    for (path, a), (_, b) in zip(leaves(ranks[0]["params"]), leaves(ranks[0]["single"]["params"])):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_dp_step_matches_jax_dp_step(scene_dir, tmp_path):
    """The two-rank stage-1 step against the JAX package's ray-DP step on
    two devices of conftest's mesh, from one converted initialisation, on
    the draws of JAX's key: the metrics within the one-step tolerance of
    tests/test_torch_step.py (rtol 1e-4, atol 1e-6) and the parameters
    within 2.01 lr (the first Adam update is ~lr sign(g): an element whose
    gradient is near zero may flip), all but under 1% of them to f32."""
    raw = case_raw(scene_dir, str(tmp_path / "exp"), "stage1")
    # uniform samples: the up-sampling rounds are ill-conditioned on rays
    # that miss the sphere (tests/test_torch_step.py, SAMPLING)
    raw["model"]["udf_renderer"] = {"n_samples": 16, "n_importance": 0, "n_outside": 8}
    jcfg = jconfig.from_dict(raw)
    params_j = jrunner.init_params(jax.random.PRNGKey(0), jcfg)
    params_j["nerf"]["alpha"]["b"] = params_j["nerf"]["alpha"]["b"] + 1.0
    params_np = jax.tree_util.tree_map(np.asarray, params_j)
    sched = sched_at(raw, 5, is_finetune=False)
    key = jax.random.PRNGKey(7)
    from test_torch_step import BATCH, jax_noise

    noise = jax_noise(key, BATCH, 40, 48, 8)

    mesh = make_mesh(WORLD)
    jds = JDataset(jcfg.dataset)
    step_j = j_dp_step(jcfg, JRenderer(jcfg.model), mesh, blending=False)
    with mesh:
        new_j, _, metrics_j = step_j(params_j, joptim.init_adam_state(params_j), jds.scene,
                                     jds.ref_src_pairs, jnp.asarray(1), key, sched)

    spec = {"raw": raw, "blending": False, "params": params_np, "sched": sched, "img_idx": 1,
            "noise": {k: v.numpy() for k, v in noise.items()},
            "grid_points": np.zeros((WORLD, 3), np.float32)}
    spec_path = str(tmp_path / "spec_jax.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    run_ranks(spec_path)
    with open(spec_path + ".rank0", "rb") as f:
        got = pickle.load(f)
    assert set(metrics_j) == {"loss", "psnr", "variance", "beta", "gradient_error"}
    for name in metrics_j:  # the JAX DP step reports five
        np.testing.assert_allclose(got["metrics"][name], float(metrics_j[name]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    lr = max(sched["lr_geo"], sched["lr_main"])
    n_all = n_off = 0
    for path, aj in leaves(jax.tree_util.tree_map(np.asarray, new_j)):
        at = got["params"]
        for key_ in path:
            at = at[key_]
        np.testing.assert_allclose(at, aj, atol=2.01 * lr, rtol=0, err_msg=str(path))
        n_all += aj.size
        n_off += int((np.abs(at - aj) > 1e-6 + 1e-5 * np.abs(aj)).sum())
    assert n_off / n_all < 0.01, (n_off, n_all)


def test_importance_draw_matches_jax(scene_dir):
    """The port's importance draw on JAX's uniform numbers gives JAX's
    pixels, and 3/4 of the batch lies in the mask (the property of
    tests/test_parallel.py)."""
    jcfg = jconfig.from_dict(case_raw(scene_dir, "unused", "stage1"))
    jds = JDataset(jcfg.dataset)
    tds = TDataset(tconfig.from_dict(case_raw(scene_dir, "unused", "stage1")).dataset, "cpu")
    batch, idx, H, W = 64, 2, 40, 48
    key = jax.random.PRNGKey(0)
    px_j, py_j = jdataset._draw_pixels(jds.scene, idx, key, batch, True)
    kx, ky, km = jax.random.split(key, 3)
    n_uni = batch // 4
    px_u = torch.tensor(np.asarray(jax.random.randint(kx, (n_uni,), 0, W)))
    py_u = torch.tensor(np.asarray(jax.random.randint(ky, (n_uni,), 0, H)))
    u = torch.tensor(np.asarray(jax.random.uniform(km, (batch - n_uni,))))
    out = tdataset.sample_random_rays(tds.scene, idx, batch, px=px_u, py=py_u, u_mask=u)
    want = jdataset.sample_random_rays(jds.scene, idx, key, batch, importance_sample=True)
    np.testing.assert_array_equal(out["rays"][:, 6:].numpy(), np.asarray(want["rays"][:, 6:]))
    mx, my = tdataset.mask_pixels(tds.scene["masks"][idx], u)
    np.testing.assert_array_equal(mx.numpy(), np.asarray(px_j)[n_uni:])
    np.testing.assert_array_equal(my.numpy(), np.asarray(py_j)[n_uni:])

    gen = torch.Generator().manual_seed(0)
    drawn = tdataset.sample_random_rays(tds.scene, 0, batch, generator=gen,
                                        importance_sample=True)
    mask_frac = float((drawn["rays"][:, 9] > 0.5).float().mean())
    assert mask_frac >= 0.7, mask_frac
    uniform = tdataset.sample_random_rays(tds.scene, 0, batch, generator=gen)
    assert uniform["rays"].shape == drawn["rays"].shape


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
