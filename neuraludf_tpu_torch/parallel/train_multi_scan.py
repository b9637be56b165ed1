"""Multi-scan training from the command line (counterpart of
``scripts/train_multi_scan.py``).

    python -m neuraludf_tpu_torch.parallel.train_multi_scan \
        --conf confs/udf_dtu_blending.conf --cases scan24 scan37 scan40 scan55 \
        --end_iter 300000

Every scan trains with its own parameters, all of them in one CUDA graph on
``--device`` (``parallel.multi_scan.MultiScanRunner``): windowed training,
per-scan checkpoints in the single-scan format (``--is_continue`` resumes
every scan from their newest common checkpoint), per-scan validation renders
and meshes, and a closing MeshUDF mesh of every scan at
``--final_mesh_resolution``. The scans must share their resolution and view
count; the configuration's ``CASE_NAME`` names each scan's data directory.

``--sweep field=v1,v2,...`` trains ONE case once for each value, each with
that override of ``train.<field>`` (a field that reaches the step through
its schedule row), as cases ``<case>_<field><v>``.

``--multihost`` joins the process group of ``torchrun``'s environment
(``parallel.multihost``): each process trains its round-robin share of the
cases on ``cuda:LOCAL_RANK`` and waits for the others at the end:

    torchrun --nproc_per_node 4 -m neuraludf_tpu_torch.parallel.train_multi_scan \
        --multihost --conf ... --cases ...
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional, Tuple


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--conf", type=str, required=True)
    p.add_argument("--cases", type=str, nargs="+", required=True)
    p.add_argument("--end_iter", type=int, default=0, help="override train.end_iter")
    p.add_argument("--report_freq", type=int, default=0, help="override train.report_freq")
    p.add_argument("--out_dir", type=str, default="./exp/multi_scan")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--is_continue", action="store_true",
                   help="resume every scan from its newest common checkpoint")
    p.add_argument("--is_finetune", action="store_true")
    p.add_argument("--reg_weights_schedule", action="store_true")
    p.add_argument("--final_mesh_resolution", type=int, default=512)
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's process group and train this process's round-robin "
                        "share of --cases on cuda:LOCAL_RANK")
    p.add_argument("--sweep", type=str, default=None,
                   help="'field=v1,v2,...' over ONE case (e.g. sparse_weight=0.001,0.01): the "
                        "case once for each value, each with that train override")
    p.add_argument("--device", type=str, default="cuda:0",
                   help="the device of every scan (cuda:0 unless given; cpu for the CPU); "
                        "with --multihost cuda:LOCAL_RANK, or cpu over gloo")
    return p


def parse_sweep(sweep: str, case: str) -> Tuple[List[dict], List[str]]:
    """'field=v1,v2,...' -> the train overrides and case names of the sweep."""
    field, _, vals = sweep.partition("=")
    values = [float(v) for v in vals.split(",") if v]
    if not field or len(values) < 2:
        raise SystemExit(f"--sweep takes field=v1,v2,... with at least two values: {sweep!r}")
    return [{field: v} for v in values], [f"{case}_{field}{v:g}" for v in values]


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Trains, saves and meshes; returns the closing meshes' paths."""
    logging.basicConfig(level=logging.INFO,
                        format="[%(filename)s:%(lineno)s - %(funcName)s()] %(message)s")
    args = build_parser().parse_args(argv)
    if args.sweep and len(args.cases) != 1:
        raise SystemExit("--sweep takes exactly one --cases")

    import torch

    from .. import config as config_mod
    from . import multihost
    from .multi_scan import MultiScanRunner

    device = torch.device(args.device)
    if args.multihost:
        device = multihost.initialize("cpu" if device.type == "cpu" else "cuda")
        import torch.distributed as dist

        args.cases = multihost.shard_scans(args.cases, dist.get_rank(), dist.get_world_size())
    try:
        if not args.cases:
            # fewer scans than processes: nothing to train here, but the
            # process stays in the group until the others finish
            logging.info("no scans for this process; waiting at the barrier")
            return []
        overrides = {}
        if args.end_iter > 0:
            overrides["train__end_iter"] = args.end_iter
        if args.report_freq > 0:
            overrides["train__report_freq"] = args.report_freq
        # the configuration's CASE_NAME resolves per scan
        cfg = config_mod.load(args.conf, case=args.cases[0], **overrides)
        data_dirs = [config_mod.load(args.conf, case=case).dataset.data_dir
                     for case in args.cases]
        train_overrides = None
        if args.sweep:
            train_overrides, args.cases = parse_sweep(args.sweep, args.cases[0])
            data_dirs = data_dirs * len(args.cases)
            logging.info("sweeping %s on %s", args.sweep, data_dirs[0])
        logging.info("training %d scans on %s", len(args.cases), device)
        runner = MultiScanRunner(cfg, data_dirs, case_names=args.cases, out_dir=args.out_dir,
                                 seed=args.seed, is_continue=args.is_continue,
                                 is_finetune=args.is_finetune,
                                 reg_weights_schedule=args.reg_weights_schedule,
                                 train_overrides=train_overrides, device=device)
        runner.train()
        runner.save_checkpoints()
        meshes = runner.final_meshes(resolution=args.final_mesh_resolution)
        for case, mesh in zip(args.cases, meshes):
            logging.info("%s: %s", case, mesh)
        return meshes
    finally:
        if args.multihost:
            multihost.barrier()


if __name__ == "__main__":
    main()
