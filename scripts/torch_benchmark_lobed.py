"""Full-protocol quality benchmark on the `lobed` synthetic scene, on the
PyTorch port (counterpart of ``scripts/benchmark_lobed.py``, same flags,
defaults, protocol and results line).

A textured multi-lobe OPEN shell with exact analytic ground truth, 49
DTU-like views at 1600x1200, trained with the stage-1 recipe
(``confs/synthetic_smoke.conf``, the DTU widths), optionally finetuned with
the reference's stage-2 blending recipe, and scored with the DTU offline
protocol:

    extract 512^3 MeshUDF -> mask-visibility clean -> visual-hull clean ->
    small-component removal -> lattice sampling + greedy downsample ->
    truncated Chamfer + precision/recall/F-score at 1mm/2mm.

The world is scaled x200 (``MM_SCALE``) for the scores, so DTU's millimetre
thresholds carry over.

    python scripts/torch_benchmark_lobed.py --tag stage1_50k --iters 50000

runs on the CUDA card (``--device cpu`` for the CPU; without a card and
without that flag it raises). ``--fused`` and ``--precision`` set the
distance field's ``fused_core`` and ``fused_precision``; ``--mc_backend``
picks the extraction's cube triangulation. Beyond the JAX script's flags:
``--device``, ``--exp_root`` (default ``<repo>/exp``) and ``--scene``
(default ``<repo>/data/synthetic/lobed``, generated there at 49 views
1600x1200 if absent). Writes ``<exp_root>/benchmark_lobed/<tag>/`` and one
JSON line to ``<exp_root>/benchmark_lobed/results.jsonl``. The scene build, the
two training stages, the cleaning and the scoring are functions of their
own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_protocol import render_evidence, train_stage  # noqa: E402

MM_SCALE = 200.0  # unit world -> "mm" for the DTU-protocol numbers
OBS_RES = 0.01  # voxel of the observability mask, unit world
CONF = os.path.join(ROOT, "confs", "synthetic_smoke.conf")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--iters", type=int, default=50_000)
    ap.add_argument("--ft_iters", type=int, default=0,
                    help="finetune-stage iterations (patch-blending losses, the reference's "
                         "stage-2 recipe: pixel 0.1 + patch 0.1, h_patch_size 5)")
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=512)
    ap.add_argument("--fused", default="auto", help="udf_network.fused_core")
    ap.add_argument("--precision", default="default", help="udf_network.fused_precision")
    # the reference's open-surface recipe: sparse_weight 0.001 suppresses
    # phantom zero-membranes across the opening
    ap.add_argument("--sparse_weight", type=float, default=0.001)
    ap.add_argument("--blend_top_k", type=int, default=0,
                    help="override udf_renderer.blend_top_k for the ft stage (0 = keep config)")
    ap.add_argument("--mc_backend", default="tets", choices=("tets", "lewiner"),
                    help="cube triangulation of the extraction")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse the newest checkpoint under the tag dir")
    ap.add_argument("--init_ckpt", default=None,
                    help="with --skip_train: load this stage-1 checkpoint instead")
    ap.add_argument("--device", default="cuda", help="cuda[:i] (default) or cpu")
    ap.add_argument("--exp_root", default=os.path.join(ROOT, "exp"))
    ap.add_argument("--scene", default=None,
                    help="scene dir (default <repo>/data/synthetic/lobed)")
    return ap


def build_scene(scene_dir: str, n_views: int = 49, H: int = 1200, W: int = 1600) -> float:
    """The lobed scene (focal 2000 at 1600 wide, scaled with W), generated
    once; returns the seconds it took (0 if it was there)."""
    from neuraludf_tpu_torch.data.synthetic import generate_scene

    if os.path.exists(os.path.join(scene_dir, "cameras.npz")):
        return 0.0
    print(f"generating {n_views}-view {W}x{H} lobed scene ...")
    t0 = time.time()
    generate_scene(scene_dir, kind="lobed", n_views=n_views, H=H, W=W, focal=2000.0 * W / 1600)
    return time.time() - t0


def stage1_config(exp_dir: str, scene_dir: str, *, iters: int, batch_size: int = 512,
                  sparse_weight: float = 0.001, fused: str = "auto",
                  precision: str = "default"):
    """The stage-1 recipe: the DTU widths of ``confs/synthetic_smoke.conf``."""
    from neuraludf_tpu_torch import config as config_mod

    cfg = config_mod.load(CONF, case="lobed")
    return dataclasses.replace(
        cfg,
        general=dataclasses.replace(cfg.general, base_exp_dir=exp_dir),
        dataset=dataclasses.replace(cfg.dataset, data_dir=scene_dir),
        train=dataclasses.replace(
            cfg.train, end_iter=iters, batch_size=batch_size, sparse_weight=sparse_weight,
            save_freq=25_000, val_freq=10**9, val_mesh_freq=10**9, report_freq=1000),
        model=dataclasses.replace(cfg.model, udf_network=dataclasses.replace(
            cfg.model.udf_network, fused_core=fused, fused_precision=precision)),
    )


def finetune_config(cfg, ft_iters: int, blend_top_k: int = 0):
    """The reference's DTU finetune (udf_dtu_blending_ft.conf): lr 1e-4 both
    groups, warm-up 5k, fix_geo 500, anneal 25k, pixel 0.1 + patch 0.1 SSIM
    blending at h_patch_size 5, each schedule cut to the run's length."""
    from neuraludf_tpu_torch.config import ColorLossConfig

    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(
            cfg.train, end_iter=ft_iters, learning_rate=1e-4, learning_rate_geo=1e-4,
            fix_geo_end=500, warm_up_end=min(5000, ft_iters // 10),
            anneal_end=min(25_000, ft_iters // 2)),
        color_loss=ColorLossConfig(
            color_base_weight=0.01, color_weight=1.0, color_pixel_weight=0.1,
            color_patch_weight=0.1, pixel_loss_type="l1", patch_loss_type="ssim",
            h_patch_size=5),
        model=dataclasses.replace(cfg.model, udf_renderer=dataclasses.replace(
            cfg.model.udf_renderer, h_patch_size=5,
            **({"blend_top_k": blend_top_k} if blend_top_k else {}))),
    )


def clean(raw_ply: str, scene_dir: str):
    """The DTU cleaning pipeline (mask visibility, visual hull, components
    under 500 faces): (the final mesh, the seconds)."""
    from neuraludf_tpu_torch.eval.clean_mesh import (clean_mesh_faces_by_mask,
                                                     clean_mesh_faces_by_visualhull,
                                                     clean_outliers)

    t0 = time.time()
    mesh_mask = clean_mesh_faces_by_mask(raw_ply, raw_ply.replace(".ply", "_cleanmask.ply"),
                                         scene_dir, minimal_vis=2, mask_dilated_size=11)
    mesh_hull = clean_mesh_faces_by_visualhull(mesh_mask,
                                               raw_ply.replace(".ply", "_cleanhull.ply"),
                                               scene_dir, mask_dilated_size=11, border=20)
    final = clean_outliers(mesh_hull, raw_ply.replace(".ply", "_final.ply"), faces_num=500,
                           keep_largest=False)
    return final, time.time() - t0


def score(final_ply: str, vis_out_dir, *, n_gt: int = 400_000, obs_res: float = OBS_RES):
    """The DTU protocol in mm: the mesh scaled by MM_SCALE, 400k analytic
    surface points, d->GT filtered through the lobed rig's observability
    mask. Returns (EvalResult, vertices of the final mesh)."""
    import numpy as np

    from neuraludf_tpu_torch.data.synthetic import gt_surface_points, lobed_observability_mask
    from neuraludf_tpu_torch.eval.chamfer import eval_mesh
    from neuraludf_tpu_torch.mesh.ply import export_ply, load_ply

    verts, faces = load_ply(final_ply)
    mm_ply = final_ply.replace(".ply", "_mm.ply")
    export_ply(mm_ply, verts * MM_SCALE, faces)
    gt_mm = gt_surface_points("lobed", n=n_gt).astype(np.float64) * MM_SCALE
    obs, bb, res = lobed_observability_mask(res=obs_res)
    r = eval_mesh(mm_ply, gt_mm, downsample_density=0.2, max_dist=20.0,
                  obs_mask=(obs, bb * MM_SCALE, res * MM_SCALE), vis_out_dir=vis_out_dir,
                  scan=0)
    return r, int(len(verts))


def result_row(args, r, n_verts: int, train_s: float, extract_s: float, clean_s: float,
               val_s: float) -> dict:
    """The JAX script's results line."""
    return {
        "tag": args.tag,
        "iters": args.iters,
        "ft_iters": args.ft_iters,
        "blend_top_k": args.blend_top_k or None,
        "mc_backend": args.mc_backend,
        "batch_size": args.batch_size,
        "fused": args.fused,
        "precision": args.precision,
        "resolution": args.resolution,
        "chamfer_mm": round(r.chamfer, 4),
        "mean_d2gt_mm": round(r.mean_d2s, 4),
        "mean_gt2d_mm": round(r.mean_s2d, 4),
        "fscore_1mm": round(r.fscore_1, 4),
        "precision_1mm": round(r.precision_1, 4),
        "recall_1mm": round(r.recall_1, 4),
        "fscore_2mm": round(r.fscore_2, 4),
        "n_verts_final": n_verts,
        "train_s": round(train_s, 1),
        "it_per_s": round(args.iters / train_s, 1) if train_s else None,
        "extract_s": round(extract_s, 1),
        "clean_s": round(clean_s, 1),
        "val_s": round(val_s, 1),
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s")

    from neuraludf_tpu_torch.train.runner import Runner, resolve_device

    scene_dir = args.scene or os.path.join(ROOT, "data", "synthetic", "lobed")
    device = resolve_device(args.device)
    build_scene(scene_dir)
    out_dir = os.path.join(args.exp_root, "benchmark_lobed")
    exp_dir = os.path.join(out_dir, args.tag)
    cfg = stage1_config(exp_dir, scene_dir, iters=args.iters, batch_size=args.batch_size,
                        sparse_weight=args.sparse_weight, fused=args.fused,
                        precision=args.precision)
    runner = Runner(cfg, seed=0, reg_weights_schedule=args.sparse_weight > 0, device=device)

    train_s = 0.0
    if args.skip_train:
        stage1_ck = args.init_ckpt or runner._latest_checkpoint()
        if not stage1_ck:
            raise FileNotFoundError(f"--skip_train but no checkpoint under {exp_dir}")
        runner.load_checkpoint(stage1_ck)
    else:
        stage1_ck, train_s = train_stage(runner)

    if args.ft_iters:
        ft_runner = Runner(finetune_config(cfg, args.ft_iters, args.blend_top_k), seed=0,
                           is_finetune=True, reg_weights_schedule=args.sparse_weight > 0,
                           device=device)
        ft_runner.load_checkpoint(stage1_ck)
        train_s += train_stage(ft_runner)[1]
        runner = ft_runner

    val_s = render_evidence(runner)
    t0 = time.time()
    raw_ply = runner.extract_udf_mesh(world_space=False, resolution=args.resolution,
                                      dist_threshold_ratio=5.0, algorithm=args.mc_backend)
    extract_s = time.time() - t0
    final_ply, clean_s = clean(raw_ply, scene_dir)
    r, n_verts = score(final_ply, os.path.join(exp_dir, "eval_vis"))

    row = result_row(args, r, n_verts, train_s, extract_s, clean_s, val_s)
    with open(os.path.join(out_dir, "results.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
