"""Several processes, one card each (counterpart of
``neuraludf_tpu/parallel/multihost.py``).

One process a card is torch's counterpart of the JAX package's per-host
local mesh. ``initialize`` joins the process group that ``torchrun`` (or any
launcher that sets its environment) describes, over NCCL on the cards or
gloo on the CPU:

* **ray-DP** (``parallel.sharding``): every process runs the same step on
  its share of the rays and the gradients are all-reduced;
* **multi-scan** (``parallel.train_multi_scan --multihost``): the scans are
  split round robin over the processes (``shard_scans``), each trains its
  share on its own card with no traffic between processes, and every
  process waits at ``barrier`` for the others before it leaves.

    torchrun --nproc_per_node 2 -m neuraludf_tpu_torch.parallel.multihost --self-test

runs one ray-DP step of a tiny configuration in every process, against the
single step, then a ray-DP window (on the cards a CUDA graph holding the
collectives) against the single window from the same state and draws, and
prints a line with the losses and a digest of the updated parameters, which
every process must agree on (``--device cpu``: over gloo on the CPU;
``--conf confs/synthetic_smoke.conf``: that configuration's networks, tier
and batch, at the DTU width, instead of the tiny one).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

# what torchrun sets for every process; LOCAL_RANK (the card) defaults to RANK
ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
SELF_TEST_WINDOW = 4  # ray-DP steps of the self-test's window (two warm-up, the capture)


def initialize(device: str = "cuda") -> torch.device:
    """Joins the process group of the launcher's environment (``ENV``, and
    ``LOCAL_RANK``) and returns this process's device: ``cuda:LOCAL_RANK``
    over NCCL, or the CPU over gloo for ``device="cpu"``. Raises unless
    every variable of ``ENV`` is set."""
    missing = [name for name in ENV if not os.environ.get(name)]
    if missing:
        raise ValueError(f"multihost.initialize: {' and '.join(missing)} not set; the launcher's "
                         f"environment {', '.join(ENV)} must be set together (torchrun sets it)")
    if device == "cpu":
        dist.init_process_group("gloo", init_method="env://")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("multihost.initialize: no CUDA device; pass device='cpu' to run over "
                           "gloo on the CPU")
    dev = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', os.environ['RANK']))}")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="env://", device_id=dev)
    return dev


def shard_scans(data_dirs: Sequence[str], process_id: int, num_processes: int) -> List[str]:
    """Round-robin share of the scan list for one process: the shares differ
    in length by at most one, and a process is left without scans only when
    there are fewer scans than processes (it must still wait at
    ``barrier``)."""
    return list(data_dirs)[process_id::num_processes]


def barrier() -> None:
    """Blocks until every process of the group reaches it."""
    dist.barrier()


def _setup(batch_size: int, device: torch.device, conf: str = ""):
    """The configuration of ``conf`` (its networks, tier and batch), or a
    small one with every part of the DTU one (background NeRF, up-sampling,
    the skip) of ``batch_size`` rays; and a 4-view random scene on
    ``device``, the same in every process (the JAX package's
    ``utils.testing``)."""
    from ..config import from_dict, load
    from ..data.synthetic import look_at_pose

    cfg = load(conf) if conf else from_dict({
        "train": {"batch_size": batch_size, "warm_up_end": 10, "anneal_end": 20, "end_iter": 100},
        "model": {
            "nerf": {"D": 2, "W": 32, "multires": 4, "multires_view": 2, "skips": [0]},
            "udf_network": {"d_out": 33, "d_hidden": 32, "n_layers": 4, "skip_in": [2],
                            "multires": 4, "fused_precision": "highest"},
            "rendering_network": {"d_feature": 32, "d_hidden": 32, "n_layers": 2},
            "udf_renderer": {"n_samples": 16, "n_importance": 10, "n_outside": 4,
                             "up_sample_steps": 5},
        },
    })
    n_views, H, W = 4, 32, 40
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 48.0
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0
    poses = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        poses.append(look_at_pose(2.2 * np.array([np.sin(ang), 0.2, -np.cos(ang)], np.float32)))
    intr = np.stack([K] * n_views)
    images = np.random.RandomState(1).rand(n_views, H, W, 3).astype(np.float32)
    pairs = np.stack([np.roll(np.arange(n_views), -i - 1)[:n_views - 1] for i in range(n_views)])
    scene = {key: torch.as_tensor(val, device=device) for key, val in (
        ("images", images), ("masks", np.ones_like(images)), ("intrinsics", intr),
        ("intrinsics_inv", np.linalg.inv(intr).astype(np.float32)),
        ("poses", np.stack(poses).astype(np.float32)), ("ref_src_pairs", pairs.astype(np.int64)))}
    return cfg, scene


def _clone(tree):
    """A copy of a nested dict of tensors, each leaf as trainable as its
    original."""
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone().requires_grad_(
        v.requires_grad) for k, v in tree.items()}


def _digest(params) -> float:
    from ..train.optim import leaves

    return sum(float(p.detach().abs().sum(dtype=torch.float64)) for _, p in leaves(params))


def _self_test(device: str, conf: str = "") -> None:
    """One ray-DP step on the group, held against the single step on the
    same state and draws (loss to rtol 1e-5), then a ray-DP window of
    SELF_TEST_WINDOW steps (on a card one CUDA graph, its collectives
    inside) against the single window from the same state and generator
    state: the window's losses to rtol 1e-4 and the parameters' digest to
    rtol 1e-6 (the gradient is the same sum in another order, and Adam
    moves a parameter by at most about its learning rate a step); prints
    the losses, the digests and the largest parameter difference. Every
    process must print the same line."""
    from ..render.renderer import UDFRenderer
    from ..train.optim import init_adam_state, leaves
    from ..train.runner import init_params
    from ..train.schedules import compute_step_schedules, schedule_rows
    from ..train.step import build_step_body, build_train_window, draw_noise
    from .sharding import build_parallel_train_step, build_parallel_train_window

    dev = initialize(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg, scene = _setup(8 * world, dev, conf)
    renderer = UDFRenderer(cfg.model)
    state = {}
    for name in ("dp", "single"):
        params = init_params(torch.Generator().manual_seed(0), cfg, dev)
        state[name] = (params, init_adam_state(params))
    scheds = [compute_step_schedules(1 + j, cfg.train, 0.01, 1.0, 0.0, 0.0, is_finetune=False,
                                     reg_weights_schedule=False, same_lr=False,
                                     beta_trainable=True, variance_trainable=True)
              for j in range(1 + SELF_TEST_WINDOW)]
    rows = torch.from_numpy(schedule_rows(scheds)).to(dev)
    generator = torch.Generator(device=dev).manual_seed(2)
    noise = draw_noise(cfg, scene, generator)
    loss = float(build_parallel_train_step(cfg, renderer)(*state["dp"], scene, 0, rows[0],
                                                          noise=noise)["loss"])
    single = float(build_step_body(cfg, renderer)(*state["single"], scene, 0, rows[0],
                                                  noise=noise)["loss"])
    if not (np.isfinite(loss) and abs(loss - single) <= 1e-5 * abs(single)):
        raise AssertionError(f"the ray-DP step's loss {loss} is not the single step's {single}")
    # the single window starts from the ray-DP state and generator state
    params, opt_state = (_clone(tree) for tree in state["dp"])
    single_gen = torch.Generator(device=dev)
    single_gen.set_state(generator.get_state())
    window = build_parallel_train_window(cfg, renderer, window=SELF_TEST_WINDOW)
    idxs = torch.arange(SELF_TEST_WINDOW, device=dev) % scene["images"].shape[0]
    got = window(*state["dp"], scene, idxs, generator, rows[1:])[:, 0].cpu()
    # NCCL keeps a communicator while a graph that holds its collectives
    # lives: the window goes first, or destroying the group never returns
    del window
    want = build_train_window(cfg, renderer, blending=False, window=SELF_TEST_WINDOW)(
        params, opt_state, scene, idxs, single_gen, rows[1:])[:, 0].cpu()
    digest, single_digest = _digest(state["dp"][0]), _digest(params)
    diff = max(float((a.detach() - b.detach()).abs().max())
               for (_, a), (_, b) in zip(leaves(state["dp"][0]), leaves(params)))
    line = (f"process={rank} loss={loss:.9g} single={single:.9g} window_loss={float(got[-1]):.9g} "
            f"single_window_loss={float(want[-1]):.9g} digest={digest:.9g} "
            f"single_digest={single_digest:.9g} max_param_diff={diff:.3g} world={world} "
            f"device={dev}")
    if not (torch.isfinite(got).all() and torch.allclose(got, want, rtol=1e-4, atol=0)
            and abs(digest - single_digest) <= 1e-6 * single_digest):
        raise AssertionError(f"the ray-DP window is not the single window: {line}")
    print(f"MULTIHOST_OK {line}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.destroy_process_group()


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--self-test", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--conf", default="", help="the self-test's configuration (networks, tier, "
                   "batch); a tiny one unless given")
    args = p.parse_args()
    if args.self_test:
        _self_test(args.device, args.conf)
