#!/bin/sh
# Trains the synthetic sphere through the port's CLI at several tiers of the
# fused distance kernels, all at once on one CUDA card, and scores each
# closing 256^3 mesh (scripts/torch_sphere_quality.py, one process a tier,
# each in its own experiment directory).
#
#   sh scripts/torch_sphere_tiers.sh ITERS OUTDIR TIER...
#
# TIER is default, high or highest (model.udf_network.fused_precision) or
# off (fused_core = off: the plain autograd path). Each tier writes
# OUTDIR/<tier>.json (the script's JSON line) and OUTDIR/<tier>.log; the
# meshes stay under exp/quality/<tier>/. The JSON lines are printed at the
# end. Exits non-zero if any tier failed.
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
for tier in "$@"; do
  if [ "$tier" = off ]; then flag="--fused_core off"; else flag="--fused_precision $tier"; fi
  OMP_NUM_THREADS=2 python3 scripts/torch_sphere_quality.py --iters "$iters" --stage "$iters" \
      --budget_s 1e9 $flag --out "$out/$tier.json" --mesh_dir "exp/quality/$tier" \
      > "$out/$tier.log" 2>&1 &
  pids="$pids $!"
done
rc=0
for p in $pids; do wait "$p" || rc=1; done
for tier in "$@"; do
  echo "== $tier"
  cat "$out/$tier.json" 2>/dev/null || tail -n 20 "$out/$tier.log"
done
exit $rc
