"""DeepFashion3D evaluation from the command line (counterpart of
``scripts/eval_deepfashion.py``): the DTU protocol's skeleton without the
observability mask and the ground plane, in normalised units (the mesh
sampled every 0.002, distances over 0.1 dropped, precision and recall at
0.001 and 0.002). The Chamfer distance and F-scores are printed and written
to ``eval_result.txt`` beside the mesh (or to ``--log``).

    python -m neuraludf_tpu_torch.eval.eval_deepfashion --data mesh.ply \
        --gt garment_gt.ply [--scan 0] [--vis_out_dir out]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..mesh.ply import load_ply
from .chamfer import EvalResult, eval_mesh

THRESHOLDS = (0.001, 0.002)  # "1mm" and "2mm" of the normalised garment


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--gt", type=str, required=True, help="GT point cloud .ply")
    p.add_argument("--scan", type=int, default=0)
    p.add_argument("--vis_out_dir", type=str, default=None)
    p.add_argument("--downsample_density", type=float, default=0.002)
    p.add_argument("--max_dist", type=float, default=0.1)
    p.add_argument("--log", type=str, default=None)
    return p


def eval_df3d(mesh_path: str, gt_points: np.ndarray, *, downsample_density: float = 0.002,
              max_dist: float = 0.1, vis_out_dir=None, scan: int = 0) -> EvalResult:
    """The DF3D protocol's scores of a mesh against the ground-truth points."""
    return eval_mesh(mesh_path, gt_points.astype(np.float64),
                     downsample_density=downsample_density, max_dist=max_dist,
                     thresh1=THRESHOLDS[0], thresh2=THRESHOLDS[1],
                     vis_out_dir=vis_out_dir, scan=scan)


def main(argv=None):
    args = build_parser().parse_args(argv)
    gt_points, _ = load_ply(args.gt)
    r = eval_df3d(args.data, gt_points, downsample_density=args.downsample_density,
                  max_dist=args.max_dist, vis_out_dir=args.vis_out_dir, scan=args.scan)
    print(f"over_all: {r.chamfer}; mean_d2gt: {r.mean_d2s}; mean_gt2d: {r.mean_s2d}.")
    print(f"fscore_1mm: {r.fscore_1}  fscore_2mm: {r.fscore_2}")
    log = args.log or os.path.join(os.path.dirname(args.data), "eval_result.txt")
    with open(log, "w+") as f:
        f.write(f"over_all {np.round(r.chamfer, 5)} mean_d2gt {np.round(r.mean_d2s, 5)} "
                f"mean_gt2d {np.round(r.mean_s2d, 5)}\n")


if __name__ == "__main__":
    main()
