"""DTU evaluation from the command line (counterpart of
``scripts/eval_dtu.py``): the Chamfer distance, precision, recall and
F-score of a mesh against the ground-truth points, printed and written to
``eval_result.txt`` beside the mesh (or to ``--log``).

    python -m neuraludf_tpu_torch.eval.eval_dtu --data mesh.ply \
        --gt stl118_total.ply --scan 118 --dataset_dir <MVS_Data> [--vis_out_dir out]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..mesh.ply import load_ply
from .chamfer import eval_mesh, load_dtu_obs_mask


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--gt", type=str, required=True)
    p.add_argument("--scan", type=int, default=1)
    p.add_argument("--dataset_dir", type=str, default=None,
                   help="DTU MVS_Data dir with ObsMask/*.mat; omit to skip filtering")
    p.add_argument("--vis_out_dir", type=str, default=None)
    p.add_argument("--downsample_density", type=float, default=0.2)
    p.add_argument("--patch_size", type=float, default=60)
    p.add_argument("--max_dist", type=float, default=20)
    p.add_argument("--log", type=str, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    gt_points, _ = load_ply(args.gt)
    obs_mask = plane = None
    if args.dataset_dir:
        obs_mask, plane = load_dtu_obs_mask(args.dataset_dir, args.scan)

    r = eval_mesh(args.data, gt_points.astype(np.float64),
                  downsample_density=args.downsample_density, max_dist=args.max_dist,
                  obs_mask=obs_mask, ground_plane=plane, patch_size=args.patch_size,
                  vis_out_dir=args.vis_out_dir, scan=args.scan)
    print(f"over_all: {r.chamfer}; mean_d2gt: {r.mean_d2s}; mean_gt2d: {r.mean_s2d}.")
    print(f"precision_1mm: {r.precision_1};  recall_1mm: {r.recall_1};  fscore_1mm: {r.fscore_1}")
    print(f"precision_2mm: {r.precision_2};  recall_2mm: {r.recall_2};  fscore_2mm: {r.fscore_2}")

    log = args.log or os.path.join(os.path.dirname(args.data), "eval_result.txt")
    with open(log, "w+") as f:
        f.write(
            f"over_all {np.round(r.chamfer, 3)} mean_d2gt {np.round(r.mean_d2s, 3)} "
            f"mean_gt2d {np.round(r.mean_s2d, 3)}\n"
            f"precision_1mm {np.round(r.precision_1, 3)} recall_1mm {np.round(r.recall_1, 3)} "
            f"fscore_1mm {np.round(r.fscore_1, 3)}\n"
            f"precision_2mm {np.round(r.precision_2, 3)} recall_2mm {np.round(r.recall_2, 3)} "
            f"fscore_2mm {np.round(r.fscore_2, 3)}\n"
            f"[{os.path.splitext(os.path.basename(args.data))[0]}]\n"
        )


if __name__ == "__main__":
    main()
