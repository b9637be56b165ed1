"""DTU mesh cleaning from the command line (counterpart of
``scripts/clean_dtu_mesh.py``): drop the faces seen inside fewer than
``--minimal_vis`` dilated masks, then those outside the visual hull, and
with ``--keep_largest`` every component but the largest.

    python -m neuraludf_tpu_torch.eval.clean_dtu_mesh --mesh m.ply \
        --data_dir <DTU>/scan118 [--out_dir out] [--keep_largest]
"""

from __future__ import annotations

import argparse
import os

from .clean_mesh import clean_mesh_faces_by_mask, clean_mesh_faces_by_visualhull, clean_outliers


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", type=str, required=True)
    p.add_argument("--data_dir", type=str, required=True, help="scan dir with cameras.npz + mask/")
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--scan", type=int, default=0)
    p.add_argument("--mask_kernel_size", type=int, default=11)
    p.add_argument("--minimal_vis", type=int, default=2)
    p.add_argument("--keep_largest", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    out_dir = args.out_dir or os.path.dirname(args.mesh)
    os.makedirs(out_dir, exist_ok=True)
    clean_file = os.path.join(out_dir, f"clean_{args.scan:03d}.ply")
    hull_file = os.path.join(out_dir, f"visualhull_{args.scan:03d}.ply")

    clean_mesh_faces_by_mask(args.mesh, clean_file, args.data_dir,
                             minimal_vis=args.minimal_vis, mask_dilated_size=args.mask_kernel_size)
    clean_mesh_faces_by_visualhull(clean_file, hull_file, args.data_dir,
                                   mask_dilated_size=args.mask_kernel_size + 20)
    if args.keep_largest:
        clean_outliers(hull_file, hull_file, keep_largest=True)
    print("wrote", clean_file, "and", hull_file)


if __name__ == "__main__":
    main()
