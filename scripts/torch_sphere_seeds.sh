#!/bin/sh
# Trains the synthetic sphere at N seeds at once on one CUDA card, through
# the port's multi-scan command line (python -m
# neuraludf_tpu_torch.parallel.train_multi_scan: scan i is seed i, all of
# them in one CUDA graph), and scores each closing 256^3 mesh as
# scripts/torch_sphere_quality.py does (--score_only, one process a seed, with
# the radial profile of the scan's last checkpoint).
#
#   sh scripts/torch_sphere_seeds.sh ITERS N OUTDIR
#
# The scene is data/synthetic/sphere; scan i reads it through the link
# data/synthetic/sphere_s<i>. The runs go under exp/sphere_seeds/sphere_s<i>/.
# Writes OUTDIR/train.log, and for each seed OUTDIR/sphere_s<i>.json (the
# score), .log and .metrics.json (its last iteration's metrics); prints the
# JSON lines at the end. Exits non-zero if the training or a score failed.
set -u
iters=$1
n=$2
out=$3
mkdir -p "$out"
cd "$(dirname "$0")/.."
python3 -c "
import os
from neuraludf_tpu_torch.data.synthetic import generate_scene
from neuraludf_tpu_torch.mesh import build as mesh_build
from neuraludf_tpu_torch.ops import build
build.compile_sources(['fused_distance', 'strip_sample'])
mesh_build.ensure_built()
if not os.path.isfile('data/synthetic/sphere/cameras.npz'):
    generate_scene('data/synthetic/sphere', kind='sphere', n_views=16, H=600, W=800)
" || exit 1
cases=""
i=0
while [ "$i" -lt "$n" ]; do
  ln -sfn sphere "data/synthetic/sphere_s$i"
  cases="$cases sphere_s$i"
  i=$((i + 1))
done
start=$(date +%s)
python3 -m neuraludf_tpu_torch.parallel.train_multi_scan --conf confs/synthetic_smoke.conf \
    --cases $cases --end_iter "$iters" --final_mesh_resolution 256 --out_dir exp/sphere_seeds \
    > "$out/train.log" 2>&1 || { tail -n 40 "$out/train.log"; exit 1; }
echo "training and meshes: $(( $(date +%s) - start )) s"
pids=""
for c in $cases; do
  d=exp/sphere_seeds/$c
  tail -n 1 "$d/logs/metrics.jsonl" > "$out/$c.metrics.json"
  ckpt=$(ls "$d"/checkpoints/ckpt_*.ckpt | tail -n 1)
  OMP_NUM_THREADS=1 python3 scripts/torch_sphere_quality.py --resolution 256 \
      --score_only "$d/udf_meshes/udf_res256_step$iters.ply" --radial_ckpt "$ckpt" \
      --mesh_dir "$d/score" \
      --out "$out/$c.json" > "$out/$c.log" 2>&1 &
  pids="$pids $!"
done
rc=0
for p in $pids; do wait "$p" || rc=1; done
echo "scoring: $(( $(date +%s) - start )) s since the training started"
for c in $cases; do
  echo "== $c"
  cat "$out/$c.metrics.json"
  cat "$out/$c.json" 2>/dev/null || tail -n 20 "$out/$c.log"
done
exit $rc
