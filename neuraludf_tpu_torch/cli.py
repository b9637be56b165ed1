"""Command-line entry point (counterpart of ``neuraludf_tpu/cli.py``).

    python -m neuraludf_tpu_torch.cli --conf confs/synthetic_smoke.conf \
        --case sphere --mode train

The argument surface is the JAX package's. Every mode runs on
``cuda:<--gpu>``. Modes: train (ending in a MeshUDF extraction at
``--final_mesh_resolution``; ``--vis_ray`` adds the periodic ray
statistics, ``--profile_dir`` writes a ``torch.profiler`` trace of the
training there), validate_mesh, extract_udf_mesh (alias validate_udf_mesh),
validate_fields, validate_image* (views 0, 10, ..., 70 at resolution level
1, colour and ground truth to ``novel_view/``), save_hdf5 and vis_one_ray.
The modes other than train read the newest checkpoint with ``--is_continue``.
``--multihost`` is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os

log = logging.getLogger(__name__)

MODES = ("train", "validate_mesh", "extract_udf_mesh", "validate_udf_mesh", "validate_fields",
         "validate_image", "save_hdf5", "vis_one_ray")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--conf", type=str, default="./confs/base.conf")
    p.add_argument("--mode", type=str, default="train")
    p.add_argument("--model_type", type=str, default="")
    p.add_argument("--threshold", type=float, default=0.005)
    p.add_argument("--is_continue", default=False, action="store_true")
    p.add_argument("--is_finetune", default=False, action="store_true")
    p.add_argument("--reg_weights_schedule", default=False, action="store_true")
    p.add_argument("--vis_ray", default=False, action="store_true")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--final_mesh_resolution", type=int, default=512,
                   help="post-training extract_udf_mesh resolution")
    p.add_argument("--mc_algorithm", type=str, default="tets", choices=["tets", "lewiner"])
    p.add_argument("--case", type=str, default="")
    p.add_argument("--learning_rate", type=float, default=0)
    p.add_argument("--learning_rate_geo", type=float, default=0)
    p.add_argument("--sparse_weight", type=float, default=0)
    p.add_argument("--end_iter", type=int, default=0, help="override train.end_iter")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the training to this directory")
    p.add_argument("--multihost", default=False, action="store_true", help="not ported yet")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="[%(filename)s:%(lineno)s - %(funcName)s()] %(message)s")
    args = build_parser().parse_args(argv)
    if args.mode not in MODES and not args.mode.startswith("validate_image"):
        raise SystemExit(f"unknown mode {args.mode}")
    if args.multihost:
        raise NotImplementedError("--multihost is not ported yet (ROADMAP: slice 5, item 11)")

    from . import config as config_mod
    from .train.runner import Runner, default_device

    overrides = {}
    if args.learning_rate > 0:
        overrides["train__learning_rate"] = args.learning_rate
    if args.learning_rate_geo > 0:
        overrides["train__learning_rate_geo"] = args.learning_rate_geo
    if args.sparse_weight > 0:
        overrides["train__sparse_weight"] = args.sparse_weight
    if args.end_iter > 0:
        overrides["train__end_iter"] = args.end_iter
    if args.model_type:
        overrides["general__model_type"] = args.model_type
    cfg = config_mod.load(args.conf, case=args.case, **overrides)

    runner = Runner(cfg, args.mode, is_continue=args.is_continue, is_finetune=args.is_finetune,
                    reg_weights_schedule=args.reg_weights_schedule, vis_ray=args.vis_ray,
                    seed=args.seed, device=default_device(args.gpu))
    if args.mode == "train":
        trace = (profile_trace(args.profile_dir, runner.device) if args.profile_dir
                 else contextlib.nullcontext())
        with trace:
            runner.train()
        runner.extract_udf_mesh(resolution=args.final_mesh_resolution, world_space=True,
                                dist_threshold_ratio=5.0, algorithm=args.mc_algorithm)
    elif args.mode == "validate_mesh":
        runner.validate_mesh(world_space=False, resolution=args.resolution,
                             threshold=args.threshold)
    elif args.mode in ("extract_udf_mesh", "validate_udf_mesh"):
        runner.extract_udf_mesh(resolution=args.resolution, world_space=True,
                                dist_threshold_ratio=5.0, algorithm=args.mc_algorithm)
    elif args.mode.startswith("validate_image"):
        for idx in range(0, 80, 10):
            if idx < runner.dataset.n_images:
                runner.validate(idx, resolution_level=1, only_color=True)
    elif args.mode == "validate_fields":
        runner.validate_fields(resolution=args.resolution)
    elif args.mode == "save_hdf5":
        runner.save_hdf5(resolution=args.resolution)
    else:  # vis_one_ray
        runner.visualize_one_ray(img_idx=min(48, runner.dataset.n_images - 1),
                                 px=runner.dataset.W // 2, py=runner.dataset.H // 2)


@contextlib.contextmanager
def profile_trace(log_dir: str, device):
    """A ``torch.profiler`` trace of the enclosed work (host and, on a CUDA
    device, the card), written to ``<log_dir>/trace.json`` in the Chrome
    trace format when the work ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


if __name__ == "__main__":
    main()
