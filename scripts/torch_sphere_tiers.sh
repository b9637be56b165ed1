#!/bin/sh
# Trains the synthetic sphere through the port's CLI at several tiers of the
# fused distance kernels, all at once on one CUDA card, and scores each
# closing 256^3 mesh (scripts/torch_sphere_quality.py, one process a tier,
# each in its own experiment directory).
#
#   sh scripts/torch_sphere_tiers.sh ITERS OUTDIR RUN...
#
# RUN is TIER or TIER@SEED. TIER is default, high or highest
# (model.udf_network.fused_precision) or off (fused_core = off: the plain
# autograd path); SEED (0 unless given) is the CLI's --seed. Each run writes
# OUTDIR/<run>.json (the script's JSON line) and OUTDIR/<run>.log; the
# meshes stay under exp/quality/<run>/. The JSON lines are printed at the
# end. Exits non-zero if any run failed. Seeds 0-3 at tier default:
#
#   sh scripts/torch_sphere_tiers.sh 2500 OUTDIR default@0 default@1 default@2 default@3
set -u
iters=$1
out=$2
shift 2
mkdir -p "$out"
cd "$(dirname "$0")/.."
# the scene and the kernels' libraries once, before the tiers race for them
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
pids=""
for run in "$@"; do
  tier=${run%@*}
  seed=0
  case $run in *@*) seed=${run#*@} ;; esac
  if [ "$tier" = off ]; then flag="--fused_core off"; else flag="--fused_precision $tier"; fi
  OMP_NUM_THREADS=2 python3 scripts/torch_sphere_quality.py --iters "$iters" --stage "$iters" \
      --budget_s 1e9 $flag --seed "$seed" --out "$out/$run.json" --mesh_dir "exp/quality/$run" \
      > "$out/$run.log" 2>&1 &
  pids="$pids $!"
done
rc=0
for p in $pids; do wait "$p" || rc=1; done
for run in "$@"; do
  echo "== $run"
  cat "$out/$run.json" 2>/dev/null || tail -n 20 "$out/$run.log"
done
exit $rc
