"""Command-line entry point (counterpart of ``neuraludf_tpu/cli.py``).

    python -m neuraludf_tpu_torch.cli --conf confs/synthetic_smoke.conf \
        --case sphere --mode train

The argument surface is the JAX package's. Every mode runs on
``cuda:<--gpu>``. Modes: train (ending in a MeshUDF extraction at
``--final_mesh_resolution``), validate_mesh, extract_udf_mesh (alias
validate_udf_mesh) and validate_fields; the rest are not ported yet and
raise. The extraction modes read the newest checkpoint with
``--is_continue``.
"""

from __future__ import annotations

import argparse
import logging

log = logging.getLogger(__name__)

MODES = ("train", "validate_mesh", "extract_udf_mesh", "validate_udf_mesh", "validate_fields")
NOT_PORTED = {
    "validate_image": "slice 4, item 10",
    "save_hdf5": "slice 4, item 10",
    "vis_one_ray": "slice 4, item 10",
}


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
    p.add_argument("--profile_dir", type=str, default="", help="not ported yet")
    p.add_argument("--multihost", default=False, action="store_true", help="not ported yet")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="[%(filename)s:%(lineno)s - %(funcName)s()] %(message)s")
    args = build_parser().parse_args(argv)
    if args.mode in NOT_PORTED:
        raise NotImplementedError(f"--mode {args.mode} is not ported yet "
                                  f"(ROADMAP: {NOT_PORTED[args.mode]})")
    if args.mode not in MODES:
        raise SystemExit(f"unknown mode {args.mode}")
    if args.vis_ray:
        raise NotImplementedError("--vis_ray is not ported yet (ROADMAP: slice 4, item 10)")
    if args.multihost:
        raise NotImplementedError("--multihost is not ported yet (ROADMAP: slice 5, item 11)")
    if args.profile_dir:
        raise NotImplementedError("--profile_dir is not ported yet (ROADMAP: slice 1, open item 6)")

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

    runner = Runner(cfg, is_continue=args.is_continue, is_finetune=args.is_finetune,
                    reg_weights_schedule=args.reg_weights_schedule, seed=args.seed,
                    device=default_device(args.gpu))
    if args.mode == "train":
        runner.train()
        runner.extract_udf_mesh(resolution=args.final_mesh_resolution, world_space=True,
                                dist_threshold_ratio=5.0, algorithm=args.mc_algorithm)
    elif args.mode == "validate_mesh":
        runner.validate_mesh(world_space=False, resolution=args.resolution,
                             threshold=args.threshold)
    elif args.mode in ("extract_udf_mesh", "validate_udf_mesh"):
        runner.extract_udf_mesh(resolution=args.resolution, world_space=True,
                                dist_threshold_ratio=5.0, algorithm=args.mc_algorithm)
    else:
        runner.validate_fields(resolution=args.resolution)


if __name__ == "__main__":
    main()
