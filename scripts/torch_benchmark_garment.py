"""Full-protocol DeepFashion3D-style quality benchmark on the `garment`
synthetic scene, on the PyTorch port (counterpart of
``scripts/benchmark_garment.py``, same flags, defaults, protocol and
results line).

A draped open skirt (a zero-thickness sheet, open at both ends, seven
irregular folds) rendered at 49 views, 1600x1200, fov ~60, black
background; trained with the reference's garment recipe
(``confs/udf_garment_blending.conf``: ``mix`` up-sampling with 64 + 80
samples, no background NeRF, igr 0.001 + igr_ns 0.01, sparse_weight 0.001
on the half-schedule gate of ``reg_weights_schedule``, variance init 0.3);
optionally followed by the garment finetune
(``confs/udf_garment_blending_ft.conf``: lr 5e-5 both groups, same_lr, the
pixel and patch weights 0) and scored with the DF3D protocol (downsample
0.002, max_dist 0.1, P/R/F at 0.001/0.002 in normalised units, no mask, no
plane, no cleaning), plus a secondary score after visual-hull cleaning.

    python scripts/torch_benchmark_garment.py --tag garment_50k --iters 50000

runs on the CUDA card (``--device cpu`` for the CPU, in place of the JAX
script's ``--cpu``; without a card and without that flag it raises).
``--resume`` continues stage 1 from the newest checkpoint under the tag's
directory; ``--fused`` and ``--precision`` set the distance field's
``fused_core`` and ``fused_precision``. Beyond the JAX script's flags:
``--exp_root`` (default ``<repo>/exp``). Writes
``<exp_root>/benchmark_garment/<tag>/`` and one JSON line to
``<exp_root>/benchmark_garment/results.jsonl``. The scene build, the two
training stages and the scoring are functions of their own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_protocol import render_evidence, train_stage  # noqa: E402

CONF = os.path.join(ROOT, "confs", "udf_garment_blending.conf")
FT_CONF = os.path.join(ROOT, "confs", "udf_garment_blending_ft.conf")
DF3D = {"downsample_density": 0.002, "max_dist": 0.1, "thresh1": 0.001, "thresh2": 0.002}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--iters", type=int, default=50_000)
    ap.add_argument("--ft_iters", type=int, default=0,
                    help="garment ft stage (udf_garment_blending_ft.conf: lr 5e-5 both "
                         "groups, same_lr)")
    ap.add_argument("--sparse_weight", type=float, default=None,
                    help="override train.sparse_weight for both stages (the reference's "
                         "per-scan -s knob)")
    ap.add_argument("--ft_blend", action="store_true",
                    help="pixel/patch blending losses in the ft stage (0.1/0.1, "
                         "h_patch_size 5: the DTU ft recipe; the shipped garment ft keeps "
                         "them 0)")
    ap.add_argument("--ft_init_ckpt", default=None,
                    help="skip stage 1 entirely and finetune from this checkpoint")
    ap.add_argument("--freeze_variance", action="store_true",
                    help="pin the variance scalar at its checkpoint value (train."
                         "freeze_variance)")
    ap.add_argument("--sparse_depth_gate", type=float, default=0.0,
                    help="ft-stage udf_renderer.sparse_depth_gate (0 = reference behaviour)")
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=512)
    ap.add_argument("--fused", default="auto", help="udf_network.fused_core")
    ap.add_argument("--precision", default="default", help="udf_network.fused_precision")
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="continue stage 1 from the newest checkpoint under the tag's dir")
    ap.add_argument("--init_ckpt", default=None)
    ap.add_argument("--views", type=int, default=49)
    ap.add_argument("--H", type=int, default=1200)
    ap.add_argument("--W", type=int, default=1600)
    ap.add_argument("--scene", default=None,
                    help="override scene dir (default <repo>/data/synthetic/garment)")
    ap.add_argument("--device", default="cuda", help="cuda[:i] (default) or cpu")
    ap.add_argument("--exp_root", default=os.path.join(ROOT, "exp"))
    return ap


def build_scene(scene_dir: str, n_views: int = 49, H: int = 1200, W: int = 1600) -> float:
    """The garment scene at fov 60 (focal W / (2 tan 30°)), like the DF3D
    renderings, generated once; returns the seconds it took (0 if it was
    there)."""
    from neuraludf_tpu_torch.data.synthetic import generate_scene

    if os.path.exists(os.path.join(scene_dir, "cameras.npz")):
        return 0.0
    print(f"generating {n_views}-view {W}x{H} garment scene ...")
    t0 = time.time()
    generate_scene(scene_dir, kind="garment", n_views=n_views, H=H, W=W, focal=W / 1.1547)
    return time.time() - t0


def stage1_config(exp_dir: str, scene_dir: str, *, iters: int, batch_size: int = 512,
                  sparse_weight=None, freeze_variance: bool = False, fused: str = "auto",
                  precision: str = "default"):
    """The shipped garment recipe (``confs/udf_garment_blending.conf``) on
    ``scene_dir``."""
    from neuraludf_tpu_torch import config as config_mod

    cfg = config_mod.load(CONF, case="garment")
    return dataclasses.replace(
        cfg,
        general=dataclasses.replace(cfg.general, base_exp_dir=exp_dir),
        dataset=dataclasses.replace(cfg.dataset, data_dir=scene_dir,
                                    render_cameras_name="cameras.npz",
                                    object_cameras_name="cameras.npz"),
        train=dataclasses.replace(
            cfg.train, end_iter=iters, batch_size=batch_size, save_freq=25_000,
            val_freq=10**9, val_mesh_freq=10**9, report_freq=1000,
            **({"sparse_weight": sparse_weight} if sparse_weight is not None else {}),
            freeze_variance=freeze_variance),
        model=dataclasses.replace(cfg.model, udf_network=dataclasses.replace(
            cfg.model.udf_network, fused_core=fused, fused_precision=precision)),
    )


def finetune_config(cfg, ft_iters: int, ft_blend: bool = False, sparse_depth_gate: float = 0.0):
    """The garment finetune: the learning rates and ``same_lr`` of
    ``confs/udf_garment_blending_ft.conf`` (lr 5e-5 both groups), warm-up
    and anneal cut to the run's length, the colour and regulariser weights
    of stage 1 (pixel and patch stay 0 unless ``ft_blend``)."""
    from neuraludf_tpu_torch import config as config_mod

    ft = config_mod.load(FT_CONF, case="garment").train
    color, model = cfg.color_loss, cfg.model
    if ft_blend:  # the DTU finetune's blending (udf_dtu_blending_ft.conf)
        color = dataclasses.replace(color, color_pixel_weight=0.1, color_patch_weight=0.1,
                                    h_patch_size=5)
        model = dataclasses.replace(model, udf_renderer=dataclasses.replace(
            model.udf_renderer, h_patch_size=5))
    if sparse_depth_gate:
        model = dataclasses.replace(model, udf_renderer=dataclasses.replace(
            model.udf_renderer, sparse_depth_gate=sparse_depth_gate))
    return dataclasses.replace(
        cfg, color_loss=color, model=model,
        train=dataclasses.replace(
            cfg.train, end_iter=ft_iters, learning_rate=ft.learning_rate,
            learning_rate_geo=ft.learning_rate_geo, same_lr=ft.same_lr,
            warm_up_end=min(5000, ft_iters // 10), anneal_end=min(25_000, ft_iters // 2)))


def score(raw_ply: str, scene_dir: str, vis_out_dir, *, n_gt: int = 400_000):
    """The DF3D protocol on the raw mesh against 400k analytic surface
    points, and the same after visual-hull cleaning (the scene's scale_mat
    is the identity, so the masks project directly); the second is None if
    the cleaning or its scoring failed."""
    import numpy as np

    from neuraludf_tpu_torch.data.synthetic import gt_surface_points
    from neuraludf_tpu_torch.eval.chamfer import eval_mesh
    from neuraludf_tpu_torch.eval.clean_mesh import clean_mesh_faces_by_visualhull

    gt = gt_surface_points("garment", n=n_gt).astype(np.float64)
    r = eval_mesh(raw_ply, gt, vis_out_dir=vis_out_dir, scan=0, **DF3D)
    rc = None
    try:
        cleaned_ply = raw_ply.replace(".ply", "_vhull.ply")
        clean_mesh_faces_by_visualhull(raw_ply, cleaned_ply, scene_dir, mask_dilated_size=11,
                                       border=0)
        rc = eval_mesh(cleaned_ply, gt, vis_out_dir=None, scan=0, **DF3D)
    except Exception:
        print(f"visual-hull-cleaned scoring failed:\n{traceback.format_exc()}")
    return r, rc


def result_row(args, r, rc, n_verts: int, train_s: float, extract_s: float,
               val_s: float) -> dict:
    """The JAX script's results line."""
    return {
        "tag": args.tag,
        "iters": args.iters,
        "ft_iters": args.ft_iters,
        "sparse_weight": args.sparse_weight,
        "ft_blend": args.ft_blend,
        "freeze_variance": args.freeze_variance,
        "sparse_depth_gate": args.sparse_depth_gate or None,
        "batch_size": args.batch_size,
        "resolution": args.resolution,
        "chamfer_e-3": round(r.chamfer * 1e3, 4),
        "mean_d2gt_e-3": round(r.mean_d2s * 1e3, 4),
        "mean_gt2d_e-3": round(r.mean_s2d * 1e3, 4),
        "fscore_1mm": round(r.fscore_1, 4),
        "precision_1mm": round(r.precision_1, 4),
        "recall_1mm": round(r.recall_1, 4),
        "fscore_2mm": round(r.fscore_2, 4),
        "chamfer_vhull_e-3": round(rc.chamfer * 1e3, 4) if rc else None,
        "fscore_1mm_vhull": round(rc.fscore_1, 4) if rc else None,
        "n_verts": n_verts,
        "train_s": round(train_s, 1),
        "it_per_s": round((args.iters + args.ft_iters) / train_s, 1) if train_s else None,
        "extract_s": round(extract_s, 1),
        "val_s": round(val_s, 1),
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s")

    from neuraludf_tpu_torch.mesh.ply import load_ply
    from neuraludf_tpu_torch.train.runner import Runner, resolve_device

    scene_dir = args.scene or os.path.join(ROOT, "data", "synthetic", "garment")
    device = resolve_device(args.device)
    build_scene(scene_dir, args.views, args.H, args.W)
    out_dir = os.path.join(args.exp_root, "benchmark_garment")
    exp_dir = os.path.join(out_dir, args.tag)
    cfg = stage1_config(exp_dir, scene_dir, iters=args.iters, batch_size=args.batch_size,
                        sparse_weight=args.sparse_weight,
                        freeze_variance=args.freeze_variance, fused=args.fused,
                        precision=args.precision)
    runner = Runner(cfg, seed=0, reg_weights_schedule=True, is_continue=args.resume,
                    device=device)

    train_s = 0.0
    if args.ft_init_ckpt:
        stage1_ck = args.ft_init_ckpt
        if not args.ft_iters:  # extract and score only: the checkpoint goes into this runner
            runner.load_checkpoint(stage1_ck)
    elif args.skip_train:
        stage1_ck = args.init_ckpt or runner._latest_checkpoint()
        if not stage1_ck:
            raise FileNotFoundError(f"--skip_train but no checkpoint under {exp_dir}")
        runner.load_checkpoint(stage1_ck)
    else:
        stage1_ck, train_s = train_stage(runner)

    if args.ft_iters:
        # the reference's ft launcher passes no --reg_weights_schedule: sparse
        # and igr_ns apply at full weight from the finetune's first step
        ft_runner = Runner(finetune_config(cfg, args.ft_iters, args.ft_blend,
                                           args.sparse_depth_gate),
                           seed=0, is_finetune=True, reg_weights_schedule=False, device=device)
        ft_runner.load_checkpoint(stage1_ck)
        train_s += train_stage(ft_runner)[1]
        runner = ft_runner

    val_s = render_evidence(runner, vis_ray=True)
    t0 = time.time()
    raw_ply = runner.extract_udf_mesh(world_space=False, resolution=args.resolution,
                                      dist_threshold_ratio=5.0)
    extract_s = time.time() - t0
    r, rc = score(raw_ply, scene_dir, os.path.join(exp_dir, "eval_vis"))

    verts, _ = load_ply(raw_ply)
    row = result_row(args, r, rc, int(len(verts)), train_s, extract_s, val_s)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
