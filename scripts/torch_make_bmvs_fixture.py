"""Writes the BlendedMVS-layout test scene ``tests/data/bmvs_sphere/``.

    python scripts/torch_make_bmvs_fixture.py [--out tests/data/bmvs_sphere]

The port's synthetic sphere (``data/synthetic.generate_scene``) at
BlendedMVS's 576x768, 8 views, each image and mask written with OpenCV's
JPEG encoder at its defaults (quality 95, 4:2:0 chroma) into
``blended_images/*.jpg`` and ``masks/*.jpg``, beside ``cameras.npz``. The
``manifest.json`` holds ``generate_scene``'s arguments and, for every JPEG,
the shape and the sha256 of the array ``cv2.imread`` decodes from it (C
order, uint8, BGR), which the port's ``data/jpeg.read_jpeg`` must return on
any machine, and that array's largest level difference to the rendered
pixels the encoder was given. Needs OpenCV, which the port itself does
not; the output is the same on every run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_VIEWS, H, W = 8, 576, 768
FOCAL = 900.0 * W / 800  # the sphere scene's field of view at 800 wide


def array_sha256(arr) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def make_fixture(out_dir: str) -> dict:
    """Writes the scene; returns the manifest."""
    import cv2
    import numpy as np

    from neuraludf_tpu_torch.data.png import read_png
    from neuraludf_tpu_torch.data.synthetic import generate_scene

    scene = {"kind": "sphere", "n_views": N_VIEWS, "H": H, "W": W, "focal": FOCAL}
    with tempfile.TemporaryDirectory() as src:
        generate_scene(src, **scene)
        if os.path.isdir(out_dir):
            shutil.rmtree(out_dir)
        files = {}
        for sub_in, sub_out in (("image", "blended_images"), ("mask", "masks")):
            os.makedirs(os.path.join(out_dir, sub_out))
            for i in range(N_VIEWS):
                rel = f"{sub_out}/{i:03d}.jpg"
                path = os.path.join(out_dir, rel)
                source = read_png(os.path.join(src, sub_in, f"{i:03d}.png"))
                if not cv2.imwrite(path, source):
                    raise OSError(f"cv2.imwrite failed for {path}")
                ref = cv2.imread(path)
                files[rel] = {"shape": list(ref.shape), "sha256": array_sha256(ref),
                              "source_max_level_diff": int(np.abs(
                                  ref.astype(np.int64) - source.astype(np.int64)).max())}
        shutil.copy(os.path.join(src, "cameras.npz"), os.path.join(out_dir, "cameras.npz"))
    manifest = {
        "scene": scene,  # generate_scene's arguments
        "encoder": f"cv2.imwrite defaults (quality 95, 4:2:0), OpenCV {cv2.__version__}",
        "decoded_by": "cv2.imread (IMREAD_COLOR): sha256 of the uint8 BGR array, C order",
        "files": files,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return manifest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data", "bmvs_sphere"))
    args = ap.parse_args(argv)
    manifest = make_fixture(args.out)
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(args.out) for n in ns)
    print(f"{args.out}: {len(manifest['files'])} JPEGs, {size} bytes")


if __name__ == "__main__":
    main()
