#!/usr/bin/env python3
"""A reduced sphere run of the port, for comparing training statistics.

    python3 scripts/torch_sphere_probe.py --steps 3000 --device cuda \
        --out exp/sphere_probe.json

Trains ``Runner`` on a reduced configuration (``probe_config``: a 4×128
distance MLP with a skip at layer 2, K1/K2 at tier "highest" on the card,
128 rays, 32 + 16 samples, 16 outside,
the schedule of ``confs/synthetic_smoke.conf``) on a 16-view 120×160 sphere
scene (focal 180: the 600×800 scene at a fifth of its size), with the
runner's own random draws, and prints the means of the loss, β, the
variance, the PSNR and the least UDF over windows of ``--window`` steps, as
one JSON line (also written to ``--out``). ``tests/test_torch_trajectory.py``
holds the same configuration in both packages on the CPU, with JAX's draws.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = ("loss", "beta", "variance", "psnr", "udf_min")
SCENE = dict(kind="sphere", n_views=16, H=120, W=160, focal=180.0)


def probe_config(scene_dir: str, exp_dir: str, steps: int) -> dict:
    """The reduced configuration, as the raw dict both packages' config
    loaders take."""
    return {
        "general": {"base_exp_dir": exp_dir, "expname": "probe"},
        "dataset": {"data_dir": scene_dir, "dataset_name": "general"},
        "train": {"learning_rate": 5e-4, "learning_rate_geo": 1e-4, "end_iter": steps,
                  "batch_size": 128, "warm_up_end": 100, "anneal_end": 500, "fix_geo_end": 50,
                  "save_freq": 0, "val_freq": 0, "val_mesh_freq": 0, "report_freq": 100},
        "model": {
            "nerf": {"D": 4, "W": 64, "multires": 6, "multires_view": 4, "skips": [2]},
            # f32 on the card (the "default" and "high" kernels take 256-wide nets)
            "udf_network": {"d_out": 65, "d_hidden": 128, "n_layers": 4, "skip_in": [2],
                            "multires": 6, "fused_precision": "highest"},
            "rendering_network": {"d_feature": 64, "d_hidden": 64, "n_layers": 2},
            "udf_renderer": {"n_samples": 32, "n_importance": 16, "n_outside": 16,
                             "up_sample_steps": 4},
        },
    }


def window_means(rows, window: int) -> dict:
    """stat -> list of its means over consecutive windows of rows."""
    return {k: [float(np.mean([r[k] for r in rows[i:i + window]]))
                for i in range(0, len(rows), window)] for k in STATS}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--window", type=int, default=300)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(ROOT, "exp", "sphere_probe.json"))
    args = p.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    from neuraludf_tpu_torch import config
    from neuraludf_tpu_torch.data.synthetic import generate_scene
    from neuraludf_tpu_torch.train.runner import Runner

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("torch_sphere_probe: no CUDA device", file=sys.stderr)
        return 1
    scene = os.path.join(ROOT, "build", "sphere_probe", "sphere")
    if not os.path.isfile(os.path.join(scene, "cameras.npz")):
        generate_scene(scene, **SCENE)
    exp = os.path.join(ROOT, "build", "sphere_probe", f"exp_{args.device.replace(':', '')}")
    runner = Runner(config.from_dict(probe_config(scene, exp, args.steps)), device=args.device,
                    seed=0)
    runner.train()
    with open(os.path.join(exp, "probe", "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f][-args.steps:]
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True
                           ).stdout.strip() if args.device.startswith("cuda") else "cpu")
    line = json.dumps({"steps": args.steps, "window": args.window, "device": card,
                       "means": window_means(rows, args.window)})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
