"""What the garment finetune does to a young garment field, on the card.

By default stage 1 ends before the recipe's ``fix_geo_end`` (500), so the
finetune starts from the initial geometry. Trains the garment recipe's
stage 1 (``scripts/torch_benchmark_garment.py``'s scene and
configurations) on a small garment scene, then runs the garment
finetune from that checkpoint for each length of FT_STEPS (each from the
same checkpoint, its schedules cut to its length) and, at CONTROL_STEPS,
again with the sparse term off and with both the sparse and the
near-surface eikonal terms off. After each run: the field's smallest value
on the extraction's grid, how many grid points lie within one voxel of
zero, the extraction's faces, and the first and last ten steps' mean loss
and ``udf_min`` (the smallest distance a training ray sampled). One JSON
line a run on stdout.

    python scripts/torch_garment_lift.py --stage1 150
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_benchmark_garment as garment  # noqa: E402
from torch_protocol import train_stage  # noqa: E402

VIEWS, H, W = 8, 300, 400  # chip_smoke.py's [garment] scene
RESOLUTION = 128
FT_STEPS, CONTROL_STEPS = (25, 50, 100), 50
CONTROLS = {"sparse_off": {"sparse_weight": 0.0},
            "sparse_and_igr_ns_off": {"sparse_weight": 0.0, "igr_ns_weight": 0.0}}


def field_row(runner, tag: str) -> dict:
    """The field of ``runner`` on the extraction's grid, its faces, and its
    run's first and last ten logged steps."""
    from neuraludf_tpu_torch.mesh.grid import fill_on_device
    from neuraludf_tpu_torch.mesh.ply import load_ply

    voxel = 2.0 / (RESOLUTION - 1)
    u = fill_on_device(runner.params["udf"], runner.cfg.model.udf_network, [-1] * 3, [1] * 3,
                       RESOLUTION)
    ply = runner.extract_udf_mesh(world_space=False, resolution=RESOLUTION,
                                  dist_threshold_ratio=5.0)
    log = os.path.join(runner.cfg.general.base_exp_dir, runner.cfg.general.expname, "logs",
                       "metrics.jsonl")
    with open(log) as f:
        rows = [json.loads(line) for line in f][-runner.iter_step:]
    mean = lambda k, part: sum(r[k] for r in part) / len(part)
    return {"run": tag, "steps": runner.iter_step, "min_udf_grid": float(u.min()),
            "grid_points_within_a_voxel": int((u < voxel).sum()),
            "faces": int(len(load_ply(ply)[1])),
            **{f"{k}_first_last_10": [mean(k, rows[:10]), mean(k, rows[-10:])]
               for k in ("loss", "udf_min")}}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage1", type=int, default=150)
    ap.add_argument("--device", default="cuda", help="cuda[:i] (default) or cpu")
    ap.add_argument("--out", default=os.path.join(ROOT, "exp", "garment_lift"))
    args = ap.parse_args(argv)

    from neuraludf_tpu_torch.train.runner import Runner, resolve_device

    device = resolve_device(args.device)
    scene = os.path.join(args.out, "scene")
    garment.build_scene(scene, VIEWS, H, W)
    cfg = garment.stage1_config(os.path.join(args.out, "stage1"), scene, iters=args.stage1)
    runner = Runner(cfg, seed=0, reg_weights_schedule=True, device=device)
    ckpt = train_stage(runner)[0]
    rows = [field_row(runner, "stage1")]
    print(json.dumps(rows[-1]), flush=True)
    runs = [(n, "recipe", {}) for n in FT_STEPS]
    runs += [(CONTROL_STEPS, name, extra) for name, extra in CONTROLS.items()]
    for n, name, extra in runs:
        ft = garment.finetune_config(cfg, n)
        ft = dataclasses.replace(
            ft, general=dataclasses.replace(
                ft.general, base_exp_dir=os.path.join(args.out, f"ft{n}_{name}")),
            train=dataclasses.replace(ft.train, **extra))
        ft_runner = Runner(ft, seed=0, is_finetune=True, reg_weights_schedule=False,
                           device=device)
        ft_runner.load_checkpoint(ckpt)
        train_stage(ft_runner)
        rows.append(field_row(ft_runner, f"finetune_{name}"))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
