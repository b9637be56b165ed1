#!/usr/bin/env python3
"""Quality run of the PyTorch port on the synthetic sphere, on one CUDA card.

    python3 scripts/torch_sphere_quality.py --iters 30000 --resolution 256 \
        --stage 2500 --budget_s 1700

1. generates the sphere scene (16 views, 600x800) under
   ``data/synthetic/sphere`` unless it is there;
2. trains through the port's CLI, as a user would:
   ``python -m neuraludf_tpu_torch.cli --mode train --conf
   confs/synthetic_smoke.conf --case sphere --final_mesh_resolution R
   --end_iter N --is_continue``, which ends in the MeshUDF extraction at R³.
   It does so in stages of ``--stage`` iterations, each resuming from the
   last one's checkpoint, and starts a stage only while the time spent and
   the longest stage so far fit in ``--budget_s``; so it stops at the last
   stage that fits, at most ``--iters``;
3. scores the closing mesh against 200,000 points of the sphere with the
   port's ``eval_mesh`` (unit scale: sampled every half voxel, 1/(R-1);
   distances over 0.1 dropped; F-score at 0.005 and 0.01), and with the
   vertex-and-face-centre Chamfer of ``scripts/ab_quality.py``, the
   protocol of RESULTS.md's sphere row; and scores a mesh of the exact
   sphere, classic marching cubes of |x| - 0.5 at R³, both ways: the floor
   of each protocol at R³.

``--fused_precision`` (default | high | highest) and ``--fused_core``
(auto | on | off) train at another tier of the fused distance kernels: the
script writes a copy of the configuration with
``model.udf_network.fused_precision`` / ``fused_core`` set (the counterpart
of the JAX package's ``NEURALUDF_FUSED_PRECISION`` override) and an
experiment directory of its own, ``exp/udf/synthetic_<tag>/sphere``, so
that runs at several tiers can share a card:

    python3 scripts/torch_sphere_quality.py --iters 2500 --stage 2500 \
        --fused_precision high --out exp/quality/high.json

``--seed N`` passes ``--seed N`` to the CLI (the initialisation and the
draws of the run) and, unless it is 0, trains into an experiment directory
of its own (tag ``seed<N>``), so that several seeds can share a card.

After training it also reads the field of the newest checkpoint along 256
fixed directions at radii 0 to 1.2 (``radial``: the minimum, median and
maximum UDF at each radius; the sphere's radius is 0.5) and keeps the last
iteration's metrics.

The closing mesh is copied into ``--mesh_dir`` (beside ``--out`` unless
given). With ``--no_score`` the card only trains; ``--score_only
<mesh.ply>`` then scores that copy on any machine, without a card. Prints
one JSON line, and writes it to ``--out`` too. Imports nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAMFER = {"max_dist": 0.1, "thresh1": 0.005, "thresh2": 0.01}


def vertex_and_centre_chamfer(verts, faces, gt) -> float:
    """Mean of both directions' nearest distances between the mesh's
    vertices and face centres and the GT points (scripts/ab_quality.py)."""
    from scipy.spatial import cKDTree

    pred = np.concatenate([verts, verts[faces].mean(axis=1)])
    d_p = cKDTree(gt).query(pred, k=1, workers=-1)[0]
    d_g = cKDTree(pred).query(gt, k=1, workers=-1)[0]
    return float(0.5 * (d_p.mean() + d_g.mean()))


def score(path, gt, density: float) -> dict:
    import dataclasses

    from neuraludf_tpu_torch.eval.chamfer import eval_mesh
    from neuraludf_tpu_torch.mesh.ply import load_ply

    verts, faces = load_ply(path)
    r = eval_mesh(path, gt.astype(np.float64), downsample_density=density, **CHAMFER)
    return {"verts": len(verts), "faces": len(faces), "eval_mesh": dataclasses.asdict(r),
            "vertex_and_centre_chamfer": vertex_and_centre_chamfer(verts, faces, gt[:100_000])}


def exact_sphere_mesh(path, resolution: int) -> str:
    from neuraludf_tpu_torch.data.synthetic import SPHERE_RADIUS
    from neuraludf_tpu_torch.mesh.mc import marching_cubes_classic
    from neuraludf_tpu_torch.mesh.ply import export_ply

    xs = np.linspace(-1, 1, resolution, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    verts, faces = marching_cubes_classic(np.linalg.norm(g, axis=-1) - SPHERE_RADIUS, 0.0)
    return export_ply(path, verts * (2.0 / (resolution - 1)) - 1.0, faces)


def tier_conf(base: str, precision: str, core: str, seed: int = 0) -> tuple:
    """(path, tag) of a copy of ``base`` whose udf_network runs the fused
    kernels at ``precision`` / ``core`` and that trains into an experiment
    directory of its own (also for a seed other than 0); ``base`` itself
    when none of them is given."""
    if not precision and not core and not seed:
        return base, ""
    tag = "_".join(t for t in (precision, f"core_{core}" if core else "",
                               f"seed{seed}" if seed else "") if t)
    text = open(base).read()
    keys = "".join(f"\n    {k} = {v}" for k, v in (("fused_precision", precision),
                                                       ("fused_core", core)) if v)
    text, n = re.subn(r"udf_network\s*\{", lambda m: m.group(0) + keys, text, count=1)
    text, m = re.subn(r"base_exp_dir\s*=\s*\./exp/udf/synthetic/",
                      f"base_exp_dir = ./exp/udf/synthetic_{tag}/", text, count=1)
    if (keys and n != 1) or m != 1:
        raise ValueError(f"{base}: no udf_network block or base_exp_dir to set")
    path = os.path.join("exp", "confs", f"synthetic_smoke_{tag}.conf")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path, tag


def radial_profile(conf: str, ckpt: str, radii=np.linspace(0.0, 1.2, 25), n_dirs: int = 256):
    """min / median / max UDF of the trained field over n_dirs fixed
    directions at each radius (plain path, on the CPU)."""
    import torch

    from neuraludf_tpu_torch import config, convert
    from neuraludf_tpu_torch.nets import fields

    cfg = config.load(conf, case="sphere").model.udf_network
    params = convert.load_checkpoint(ckpt, "cpu")["params"]["udf"]
    d = np.random.RandomState(0).randn(n_dirs, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (radii[:, None, None] * d[None]).reshape(-1, 3).astype(np.float32)
    with torch.no_grad():
        u = fields.distance_value(params, torch.from_numpy(pts), cfg).numpy().reshape(len(radii), -1)
    return {f"{r:.2f}": [float(u[i].min()), float(np.median(u[i])), float(u[i].max())]
            for i, r in enumerate(radii)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=30000)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--stage", type=int, default=2500)
    p.add_argument("--budget_s", type=float, default=1700.0)
    p.add_argument("--out", default=os.path.join(ROOT, "exp", "torch_sphere_quality.json"))
    p.add_argument("--no_score", action="store_true")
    p.add_argument("--score_only", default="")
    p.add_argument("--mesh_dir", default="", help="where the closing mesh is copied")
    p.add_argument("--fused_precision", default="", choices=["", "default", "high", "highest"])
    p.add_argument("--fused_core", default="", choices=["", "auto", "on", "off"])
    p.add_argument("--seed", type=int, default=0, help="the CLI's --seed")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)  # the configuration's paths are relative to the checkout

    import torch

    from neuraludf_tpu_torch import cli
    from neuraludf_tpu_torch.data.synthetic import generate_scene, gt_surface_points

    mesh_dir = args.mesh_dir or os.path.dirname(os.path.abspath(args.out))
    os.makedirs(mesh_dir, exist_ok=True)

    def scores(mesh: str) -> dict:
        t_score = time.time()
        gt = gt_surface_points("sphere")
        floor = exact_sphere_mesh(os.path.join(mesh_dir, f"exact_sphere_res{args.resolution}.ply"),
                                  args.resolution)
        density = 1.0 / (args.resolution - 1)
        return {"mesh": score(mesh, gt, density), "exact_sphere": score(floor, gt, density),
                "protocol": dict(CHAMFER, downsample_density=density),
                "score_s": time.time() - t_score}

    def emit(row: dict) -> int:
        line = json.dumps(row)
        with open(args.out, "w") as f:
            f.write(line + "\n")
        print(line, flush=True)
        return 0

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.score_only:
        return emit({"mesh_path": args.score_only, **scores(args.score_only)})
    if not torch.cuda.is_available():
        print("torch_sphere_quality: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    scene = os.path.join("data", "synthetic", "sphere")
    if not os.path.isfile(os.path.join(scene, "cameras.npz")):
        generate_scene(scene, kind="sphere", n_views=16, H=600, W=800)

    conf, tag = tier_conf("confs/synthetic_smoke.conf", args.fused_precision, args.fused_core,
                          args.seed)
    base = ["--conf", conf, "--case", "sphere", "--is_continue", "--seed", str(args.seed)]
    t0, longest, done, stages = time.time(), 0.0, 0, []
    while done < args.iters and time.time() - t0 + 1.1 * longest < args.budget_s:
        t_stage = time.time()
        done = min(done + args.stage, args.iters)
        cli.main(base + ["--mode", "train", "--final_mesh_resolution", str(args.resolution),
                         "--end_iter", str(done)])
        stages.append(time.time() - t_stage)
        longest = max(stages)
        print(f"stage to {done} iterations: {stages[-1]:.1f} s", flush=True)
    exp = os.path.join("exp", "udf", f"synthetic_{tag}" if tag else "synthetic", "sphere",
                       "udf_synthetic")
    mesh = shutil.copy(os.path.join(exp, "udf_meshes", f"udf_res{args.resolution}_step{done}.ply"),
                       os.path.join(mesh_dir, f"udf_res{args.resolution}_step{done}"
                                    f"{'_' + tag if tag else ''}.ply"))
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        last = json.loads(f.readlines()[-1])
    ckpt = os.path.join(exp, "checkpoints", sorted(os.listdir(os.path.join(exp, "checkpoints")))[-1])
    row = {"iters": done, "resolution": args.resolution, "stages_s": stages, "card": card,
           "conf": conf, "seed": args.seed, "fused_precision": args.fused_precision or "conf",
           "fused_core": args.fused_core or "conf", "mesh_path": mesh, "last_metrics": last,
           "radial_ckpt": os.path.basename(ckpt), "radial": radial_profile(conf, ckpt)}
    return emit(row if args.no_score else {**row, **scores(mesh)})


if __name__ == "__main__":
    sys.exit(main())
