#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build ``neuraludf_tpu_torch/csrc/fused_distance.cu`` and
   ``csrc/strip_sample.cu`` for sm_90a, both nvcc processes started together;
3. kernels K1 (fused distance forward) and K2 (its second-order backward)
   at the main path's width (58,368 points, the 8x256 net of
   ``confs/synthetic_smoke.conf``, its ``abs`` head), each tier ("default",
   "high", "highest"), against the explicit plain version at the same tier
   and the autograd plain version, "high" also against "highest", and K2
   twice on the same inputs for bit-equal W̄ and b̄; then the same for the
   ``square`` and ``sdf`` heads at 4,096 points, and for the ``abs`` head at
   5,000 points (not a multiple of the 128-row tile) and at 300 (one partly
   empty tile of K1); on a net of one hidden layer and on one of two with a
   skip into the second, "high" by RMS against its explicit version; and
   "highest" on a 128-wide net, which the sweeps refuse, through the f32
   GEMMs;
4. the synthetic sphere scene (16 views, 600x800) with the port's generator;
5. one training loss and its gradients on a small batch through the kernels
   (tiers "highest" and "high") against the plain autograd path;
6. the stage-1 main path: ``Runner.train`` on ``confs/synthetic_smoke.conf``
   at full width for a few windows of 50 iterations, each (after two eager
   warm-up steps and the capture of the first) the replays of one CUDA graph
   of the step body, launch counts of K1 and K2 read around it (a replay
   adds the launches its capture made); its last checkpoint is what the
   finetune starts from;
7. kernel K3 (the warp sampler) at the finetune's shape (8 views of the
   scene, 600x800; positions [8, 2048, 976]: clustered in-image positions
   and a block of out-of-image, exact-border, huge and NaN ones) against its
   plain version and against the one PyTorch call that computes the same
   function, ``F.grid_sample(padding_mode="border")``;
8. one blending loss and its gradients on a small batch with
   ``warp_sampler="strip"`` through K3 against the same through K3's plain
   version;
9. the finetune main path: a second ``Runner`` on
   ``confs/udf_dtu_blending_ft.conf`` (``is_finetune``) loads the stage-1
   checkpoint and trains 100 steps at full width; K1, K2 and K3 must each
   launch once a step, the pixel and patch losses must be nonzero;
9a. ``[window]``: from the stage-1 checkpoint, 50 iterations of each
   training path through the graph-replayed window and twice through the
   eager step body, three runners on one start state and generator state:
   the graphed run's launch counts (K1 = K2 = 50, K3 = 50 in the finetune),
   its metric rows, parameters and generator state against the eager run's
   (``TOL_WINDOW``); then 5 repeats of 20 steps each, graphed against eager,
   ended by a synchronize (median and spread of ms a step), the device-busy
   share and kernel count of a replayed step (torch.profiler), and the
   memory the graph's pool takes;
9b. ``[high]``, ``[highest]``: both training paths again at
   ``fused_precision = "high"`` and ``"highest"``, one window of 50 steps
   each from the stage-1 checkpoint, at full width, with the same launch
   counts, and each kernel's route counter once a step (on the main-path
   net ``high`` takes the bf16x3 sweeps, ``highest`` the 3xTF32 ones); then
   ``[tiers]``: the graphed stage-1 step at ``default``, ``high`` and
   ``highest``, 5 x 20 steps each in turns;
10. ``[mesh]`` on the stage-1 runner's field (its 200-step state): the
    MeshUDF grid at 64³ on the card against the same on the CPU; the CLI's
    closing extraction (``extract_udf_mesh`` at 512³, world space, distance
    threshold ratio 5) with the CUDA-event time and peak memory of the grid
    fill and the host-clock time of each stage; ``validate_mesh`` at 256³;
    an incremental extraction at 256³ against its full fill; the Chamfer
    distance of the 512³ mesh to the sphere's surface (a record, no bound);
11. ``[validate]`` on the stage-1 runner's field: K1 at a validation
    chunk's 466,944 points (forward, each tier) against its plain versions;
    one 4,096-ray chunk of view 5, pixel-blended, through the kernels (K1 at
    each tier, K3) against the plain path, and K3 at that chunk's own
    positions [8, 16384, 8] against its plain version and F.grid_sample; the
    main path ``Runner.validate`` at resolution level 4 (30,000 rays, one
    window of 8 chunks: K1 and K3 must launch once a chunk, K2 never), its
    PSNR, written images and peak memory; the CLI's
    ``validate_image`` at level 1 (per view 480,000 rays in 120 chunks,
    timed); ``validate_novel_image``, ``visualize_one_ray`` and ``save_hdf5``
    once each; 50 more training steps with ``val_freq`` 50, which must write
    their validation image;
11a. ``[multi_scan]``: ``MultiScanRunner.train`` of 4 stage-1 scans of the
    sphere (seeds 0-3) for one graphed window of 50 iterations, then of 2
    finetune scans resumed from the stage-1 checkpoint, K3 in each (K1 = K2
    = 50 S, K3 = 50 S in the finetune); each scan's metric rows, parameters,
    optimizer state and generator against a single-scan Runner(seed + i)
    through its graphed window on scan i's views, bit for bit; then 5 x 20
    timed multi-scan iterations at S = 1, 2, 4, 8 (the scans as branches on
    side streams of one graph): ms an iteration against S x the single
    graphed step of ``[window]``, scan-steps/s, S x the kernel time of one
    scan's iteration (from the profile at S = 1) over the timed iteration,
    the kernels' summed and covered time under the profiler (which slows
    the branches), the graph pool's memory;
11b. ``[dp]``: a process group of one card over NCCL; 20 steps of the
    ray-parallel window (``parallel.sharding``: the all-gathers of the
    per-ray outputs and the all-reduce inside the captured graph, over one
    process copies) from the stage-1 checkpoint against the single-scan
    graphed window from the same state, bit for bit (K1 = K2 = 20), and both
    timed in turns;
11c. ``[garment]``: the DeepFashion3D recipe (``confs/udf_garment_blending.conf``:
    512 rays, 64 + 80 samples by "mix" up-sampling, no background NeRF,
    ``reg_weights_schedule``) at full width through
    ``scripts/torch_benchmark_garment.py``'s functions on an 8-view 300x400
    garment: K1/K2 at "default" on the garment step's 73,728 rows against
    their plain versions; 150 graphed stage-1 steps and 50 steps of the
    garment finetune (``is_finetune``; its pixel and patch weights are 0, so
    K3 reads 0), K1 = K2 = one a step, finite and falling losses; 5 x 20
    graphed garment steps against the DTU stage-1 step in turns, the
    replayed step's kernels and busy share; the protocol's extraction at
    128³ of the stage-1 and the finetuned field, and the DF3D score of the
    stage-1 one (a record, no bound);
11d. ``[bmvs]``: the committed BlendedMVS-layout scene (``tests/data/bmvs_sphere``,
    8 views 576x768, cv2-written JPEGs): every file decoded by
    ``data/jpeg.read_jpeg`` on the host to the sha256 its manifest holds of
    ``cv2.imread``'s array, the decode timed; ``Dataset(dataset_name="bmvs")``
    on the card and one graphed window of 50 stage-1 steps at the DTU widths,
    K1 = K2 = one a step;
12. CUDA-event times of K1, K2 (each tier), K3, their plain versions and
    K3's library call, at the training shapes and at the validation chunk's; the profile
    of one validation chunk; the profile of a steady eager step of each
    path.

It prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. It imports
nothing of the JAX package. Build outputs (the CUDA kernels, the
marching-cubes engine), the scene and the meshes go under ``build/``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"
CONF = ROOT / "confs" / "synthetic_smoke.conf"
FT_CONF = ROOT / "confs" / "udf_dtu_blending_ft.conf"

N_POINTS = 512 * 114  # rays x (64 + 50 up-sampled) samples of one training step
N_OTHER_HEADS = 4096  # points for the heads the main path does not use
N_RAGGED = (5000, 300)  # point counts that end in a partly empty row tile, and a single tile
N_WINDOWS = 4  # training windows on the stage-1 main path (50 iterations each)
FT_STEPS = 100  # steps of the finetune main path
# the finetune's schedule lengths (50,000 steps as published) cut like its
# depth, by 500: warm-up 5000 -> 10, anneal 25000 -> 50, fix_geo 500 -> 1
FT_SCHEDULE = {"train__warm_up_end": 10, "train__anneal_end": 50, "train__fix_geo_end": 1}
K3_SHAPE = (8, 2048, 976)  # views, rays x chunks (512 x 4), chunk x (121 + 1) positions
K3_FLOPS_PER_POSITION = 29  # 8 for the weights, 7 per channel for the blend
REPS = 10  # kernel launches per timing

# Published peaks of one H100 SXM (dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth.
PEAK_FLOPS = {"default": 989e12, "high": 989e12, "highest": 67e12}
TIERS = ("default", "high", "highest")
PEAK_BYTES = 3.35e12
# The routes of tier "highest" (fused_distance.highest_route), priced by
# their own work: the 3xTF32 sweeps make three tf32 tensor-core passes of
# every product (495 TFLOP/s dense), the f32 GEMMs one pass on the CUDA
# cores. PEAK_FLOPS["highest"] stays the f32 price of the function (and of
# K3 and the grid fill).
ROUTE_PEAK = {"tf32x3": (3, 495e12), "gemm": (1, 67e12)}

# Tolerances, as max |kernel - reference| / max |reference| per output.
# "highest" against the explicit version: f32 products, summed in another
# order; on the 3xTF32 route each operand is split into tf32 hi and lo (2^-22
# relative together) and the tensor cores' truncating sums are flushed into
# f32 every two k8 steps (measured ~1.5e-6 on the card, the f32 route's ~1e-6).
# "default" against the explicit version at the same tier:
# both round every matmul operand, and the sigma(100a) and q that the reverse
# sweep reads back, to bf16; but an activation that differs by an f32 ulp (the
# kernels use the fast exp, log and divide) may round to the neighbouring bf16
# value (2^-8 relative), and the second-order terms amplify that. Against the
# f32 autograd version, "default" carries bf16's whole error.
# "high" (bf16x3) against the explicit version at the same tier: both split
# the same operands at the same places, but the f32 sums run in another
# order. The forward products split both operands, and a value moved by an
# ulp to the other side of a bf16 boundary moves its lo the other way: udf
# and feature agree to ~1e-5. The reverse products cast the cotangent itself
# to bf16 (JAX's transpose of _dot3), so there an ulp can move a cotangent by
# 2^-8, sigma(100 a) carries a's ulps 25-fold into the next cotangent, and
# the flips cascade over the layers: one ulp on x moves the explicit version
# itself by 2.8e-3 of the range in grad, 2.7e-3 in x̄ (measured on the CPU,
# 4,096 points of the main-path net), and the kernel (the bf16x3 sweeps)
# lies 3.6e-3 from it in grad, 2.6e-3 in x̄ at 58,368 points and 4.0e-3 in
# grad at 466,944 (measured on the card). Against "highest" (the f32
# kernel) and the f32 autograd version: the bf16 cotangents' whole error,
# measured up to 4.9e-3 (x̄, square head).
TOL = {
    ("highest", "explicit"): 1e-4,
    ("highest", "autograd"): 1e-4,
    ("high", "explicit"): 1.5e-2,
    ("high", "autograd"): 1.5e-2,
    ("high", "highest"): 1.5e-2,
    ("default", "explicit"): 2e-2,
    ("default", "autograd"): 1e-1,
}
# "high"'s roundings, where they do not cascade: a net of one hidden layer
# (the 256-wide embedding layer and the head), every output's RMS
# difference over its RMS. One ulp on x moves the explicit version by at
# most 5.8e-5 there (measured on the CPU), while "high" and "highest" differ
# by 8e-4 to 2e-3 in grad, x̄, W̄ and b̄ (the bf16 cotangents): the kernel
# must be within TOL_HIGH_ROUNDING of the explicit version (measured 2.4e-5
# at most, W̄: the bf16x3 sweeps leave their sums in the tensor cores'
# truncating accumulator, unflushed), and the "highest" kernel at least 3x
# that away from it in those four (measured 9.6e-4 at least, grad).
TOL_HIGH_ROUNDING = 1e-4
# the same on two hidden layers, the second a skip layer (alpha = 1/sqrt(2)
# applied before the split, K2's panels of alpha e): one ulp on x moves the
# explicit version by up to 1.5e-4 there (W̄; measured on the CPU, 16,384
# points), and the "highest" one lies 1.1e-3 to 2.3e-3 from it in grad, x̄,
# W̄ and b̄; the kernel must be within twice the first (measured 1.07e-4 at
# most on the card, x̄), and "highest" at least 3x that away (measured
# 1.29e-3 at least, grad).
TOL_HIGH_ROUNDING_SKIP = 3e-4
TOL_STEP = 1e-3  # small-batch loss and gradients, kernels ("highest") vs plain
# the same at "high": its bf16 cotangents move the udf gradients (K2's W̄,
# b̄), measured 1.7e-2 of a leaf's largest entry (the loss 1.8e-5)
TOL_STEP_HIGH = 5e-2
TIER_STEPS = 50  # one window of each training path at tiers "high" and "highest"
# K3, max |kernel - reference| over the colours whose mask is true. Against
# the plain version: the same f32 formula on the same absolute positions;
# nvcc contracts the four products into FMAs. Against F.grid_sample: it takes
# normalised positions (2x/(W-1) - 1) and un-normalises them, which moves a
# position by ~1e-4 px at x ~ 800, and the sphere's silhouette has a contrast
# of ~1 per pixel.
TOL_K3 = {"plain": 1e-5, "library": 5e-4}
# Small-batch blending loss and gradients, K3 vs its plain version (whose
# colours differ by ~2e-7). With the L1 patch loss the gradients follow to
# f32 rounding. The SSIM loss computes a patch's variance as E[x^2] - mu^2; on
# the sphere's smooth shading the variance is ~1e-5 of values ~0.5, and that
# cancellation turns the 2e-7 into 3e-3 of a colour-net leaf's gradient
# (measured; the pixel-blending term alone agrees to 2e-7).
TOL_STEP_BLENDING = {"ssim": 1e-2, "l1": TOL_STEP}
# The window phase: WINDOW_STEPS iterations of each training path through
# the graph-replayed window and through the eager step body (twice), three
# runners from one checkpoint and generator state, on the same schedule
# rows and views. Graph and eager launch the same kernels on the same
# inputs in the same order. Where the eager loop repeats itself bit for bit
# (K1 and K2 are deterministic, K2 bit-equal over two calls above; K3 is a
# forward-only gather; cuBLAS and PyTorch's reductions are deterministic on
# one card; measured: every row and parameter, both paths), the graphed run
# must equal it bit for bit: every metric row, every parameter, and the
# generator's state after. Otherwise the loop is chaotic (an ulp grows to a
# different run after ~200 steps, PERF.md §6), and the graphed run is held
# as tests/test_torch_trajectory.py holds the port to JAX: its loss and
# parameters (relative to each leaf's largest entry) no further from the
# eager run than TOL_WINDOW or 10x the eager run's own spread. A schedule
# value baked into the graph (the lr and cos_anneal_ratio change every step
# here) moves the loss by 1e-3 or more within a few steps.
WINDOW_STEPS = 50
TOL_WINDOW = 1e-5
TIMED_REPEATS, TIMED_STEPS = 5, 20  # step timing: repeats of 20 iterations each
# The mesh phase. The CLI's closing extraction is at 512³
# (--final_mesh_resolution); validate_mesh and the incremental check at the
# runner's default 256³; the card-against-CPU grid at 64³.
MESH_RES, MESH_CHECK_RES, MESH_PARITY_RES = 512, 256, 64
# Grid on the card against the CPU, both true f32 (TF32 off): udf absolute,
# normals absolute where both are nonzero, and the band (udf < 2 voxel) may
# differ only within 1e-6 of its edge.
TOL_GRID = {"udf": 1e-5, "normals": 1e-4, "band_edge": 1e-6}
# The validation phase. A validation chunk is batch_size x 8 = 4,096 rays,
# so K1 sees 4,096 x 114 points (forward only); with more than 8 views the
# render is pixel-blended and K3 samples 8 views at 4,096 rays x 4 chunks of
# 8 samples, one pixel position each.
N_VAL_POINTS = 4096 * 114
K3_VAL_SHAPE = (8, 4096 * 4, 8)
VAL_IDX = 5  # the view of the chunk checks and of Runner.validate
VAL_FREQ = 50  # the short training run that crosses val_freq
# A 4,096-ray chunk through the kernels against the plain path (fused_core
# off, strip_sample_plain), same parameters and draws: (max, mean) of
# |kernel - plain| per output. Tier "highest": K1 is the plain version's f32
# arithmetic summed in another order (~2e-6 relative, PERF.md §6), and the
# render downstream is the same code; only the pixel colour may differ more,
# where the top-32 pick of the blend flips between two near-equal weights.
# Tier "default": K1's bf16 operands move udf and its gradient by up to
# ~1.3e-2 of their range (PERF.md §6), the alphas and normals with them: a
# render of a slightly different field. Its worst pixel is held at about 3x
# the worst error read on the card (colour 7.2e-3, pixel colour 1.1e-2,
# normal 3.8e-2, depth 3.0e-2; PERF.md §6), its mean at about 20x. A wrong
# layout or permutation moves every pixel by ~0.1 or more.
TOL_VAL = {"highest": {"color": (1e-3, 1e-5), "color_pixel": (5e-2, 1e-4),
                       "normal": (1e-3, 1e-5), "depth": (1e-3, 1e-5)},
           "default": {"color": (2.5e-2, 5e-3), "color_pixel": (3.5e-2, 1e-2),
                       "normal": (1.2e-1, 1e-2), "depth": (1e-1, 1e-2)}}
# Chamfer of the 512³ mesh to 200,000 points of the sphere, unit scale: the
# mesh sampled every 0.002 (half a 512³ voxel), distances over 0.1 dropped,
# precision and recall at 0.005 and 0.01.
CHAMFER = {"downsample_density": 0.002, "max_dist": 0.1, "thresh1": 0.005, "thresh2": 0.01}
# The multi-scan phase: MS_SCANS stage-1 scans (seeds 0..3) and MS_FT_SCANS
# finetune scans from the stage-1 checkpoint, MS_STEPS iterations each (one
# window: two eager warm-up units, the capture of one unit of every scan's
# body, replays), every scan against a single-scan Runner(seed + i) through
# its graphed window on scan i's views, bit for bit (the same kernels on the
# same inputs in the same order, as in [window]); then the timed sweep over
# MS_SWEEP scans a graph, TIMED_REPEATS x TIMED_STEPS iterations each.
MS_SCANS, MS_FT_SCANS, MS_STEPS = 4, 2, 50
MS_SWEEP = (1, 2, 4, 8)
PROFILE_STEPS = 4  # multi-scan iterations under the profiler (S x 5,466 kernels each)
# The ray-DP phase: DP_STEPS steps of the ray-parallel window over a
# process group of one card (NCCL), against the single-scan graphed window
# from the same state, bit for bit (over one process the all-gathers and
# the all-reduce copy).
DP_STEPS = 20
# The garment phase: the DeepFashion3D recipe (confs/udf_garment_blending.conf:
# 512 rays, 64 + 80 samples by "mix" up-sampling, no background NeRF, the
# 8x256 UDF net) through scripts/torch_benchmark_garment.py's configurations,
# scene and score on a small garment scene; GARMENT_STEPS stage-1 iterations
# in windows of 50, past the recipe's fix_geo_end (500: until then the
# geometry keeps its initial values), then GARMENT_FT_STEPS of the garment
# finetune (confs/udf_garment_blending_ft.conf's learning rates, is_finetune;
# its pixel and patch weights are 0, so K3 does not run there), K1/K2 once a
# step; K1/K2 at "default" at the garment step's own row count; 5 x 20 timed
# graphed steps; each field's distance grid at GARMENT_MESH_RES (each
# stage's geometry must have moved by a grid voxel somewhere), the
# extraction of both fields (each must have a surface) and the DF3D score
# of the finetuned one, as the protocol scores it. (A finetune from a stage
# 1 that ends before fix_geo_end lifts the initial field off zero:
# scripts/torch_garment_lift.py.)
GARMENT_VIEWS, GARMENT_H, GARMENT_W = 8, 300, 400
GARMENT_STEPS, GARMENT_FT_STEPS = 700, 50
N_GARMENT_POINTS = 512 * (64 + 80)
GARMENT_MESH_RES = 128
# The BlendedMVS phase: the committed JPEG scene (scripts/torch_make_bmvs_fixture.py),
# each file decoded by the port to the array its manifest hashes, then one
# graphed window of BMVS_STEPS stage-1 steps at the DTU widths on it.
BMVS_DIR = ROOT / "tests" / "data" / "bmvs_sphere"
BMVS_STEPS = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b) -> tuple:
    a, b = a.detach().float(), b.detach().float()
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("non-finite kernel output")
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-30)


def cuda_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_flops(ucfg, n: int, tier: str = "default") -> dict:
    """Operations K1 and K2 must do over n points at ``tier``: 2 per
    multiply-add of their matrix products at the true (unpadded) widths,
    times the passes the tier makes of each product. "high" (bf16x3) makes
    three of an activation or tangent times W, two of a cotangent times W^T
    and two of the weight cotangent (its cotangent side is one bf16 value).

    One pass of the MLP is sum_l d_in * d_out. K1 is the forward pass and
    the gradient sweep; K2 the primal and tangent forward passes, the
    gamma and abar sweeps, and the weight cotangents in^T abar and
    t_in^T gamma. Where the head's cotangent is gamma = c e0, or only the
    udf column of its tangent is read (phi'' != 0 for 'square' alone), the
    head needs one column, not d_out. Elementwise work is not counted."""
    from neuraludf_tpu_torch.nets import fields

    dims, d0 = fields.distance_dims(ucfg)
    widths = [(dims[l], dims[l + 1] - d0 if (l + 1) in ucfg.skip_in else dims[l + 1])
              for l in range(ucfg.n_layers + 1)]
    full = sum(k * m for k, m in widths)
    head_in, head_out = widths[-1]
    one_col = full - head_in * head_out + head_in  # a pass whose head needs column 0
    no_col = full - head_in * head_out  # a pass whose head is not read
    tangent = one_col if ucfg.udf_type == "square" else no_col
    fwd, rev, wgt = (3, 2, 2) if tier == "high" else (1, 1, 1)
    k1 = fwd * full + rev * one_col
    k2 = fwd * (full + tangent) + rev * (one_col + full) + wgt * (full + one_col)
    return {"K1": 2.0 * n * k1, "K2": 2.0 * n * k2}


def check_kernels(ucfg, dev, n_points: int = N_POINTS, backward: bool = True,
                  tiers=("highest", "high", "default")):
    """K1 and K2 (K1 alone without ``backward``) against both plain
    versions, each of ``tiers``, with the head of ucfg.udf_type; returns
    the errors and the inputs."""
    from neuraludf_tpu_torch.nets import fields
    from neuraludf_tpu_torch.ops import fused_distance as fd

    gen = torch.Generator().manual_seed(0)
    params = fields.init_distance_field(gen, ucfg)
    for p in params.values():  # leave the geometric init's zero blocks
        for k in p:
            p[k] = (p[k] + 0.01 * torch.randn(p[k].shape, generator=gen)).to(dev)
    lay = fd.layout_for(ucfg)
    ws, bs = fd.effective_weights(params, ucfg)
    wflat, bflat = fd.pack(ws, bs, lay)
    x = (torch.rand((n_points, 3), generator=gen) * 2.0 - 1.0).to(dev)
    ubar = torch.randn((n_points, 1), generator=gen).to(dev)
    fbar = torch.randn((n_points, ucfg.d_out - 1), generator=gen).to(dev)
    gbar = torch.randn((n_points, 3), generator=gen).to(dev)

    # the autograd plain version, in f32 (TF32 is off)
    flat = lambda ts: torch.cat([t.reshape(-1) for t in ts])
    ref_bwd = None
    if backward:
        xg = x.clone().requires_grad_(True)
        wg = [w.detach().clone().requires_grad_(True) for w in ws]
        bg = [b.detach().clone().requires_grad_(True) for b in bs]
        ref_out = fd.plain_autograd(xg, wg, bg, ucfg)
        ref_grads = torch.autograd.grad(ref_out, [xg] + wg + bg,
                                        grad_outputs=(ubar, fbar, gbar))
        ref_bwd = (ref_grads[0], flat(ref_grads[1:1 + len(ws)]), flat(ref_grads[1 + len(ws):]))
        ref_out = tuple(t.detach() for t in ref_out)
    else:  # the forward alone: no graph outlives the gradient
        with torch.no_grad():
            ref_out = fd.plain_autograd(x, list(ws), list(bs), ucfg)

    def true_layout(bwd):
        """(x̄, W̄, b̄) with the padding dropped: the padded columns' outputs
        are softplus100(0) != 0, so W̄'s padded rows hold values nobody reads."""
        ws_bar, bs_bar = fd.unpack(bwd[1], bwd[2], lay)
        return bwd[0], flat(ws_bar), flat(bs_bar)

    names_fwd, names_bwd = ("udf", "feat", "grad"), ("xbar", "wbar", "bbar")
    errors, kernel_out = {}, {}
    for tier in tiers:
        k_fwd = fd.fused_forward(x, wflat, bflat, lay, tier)
        torch.cuda.synchronize()
        k_bwd = e_bwd = None
        if backward:
            raw_bwd = fd.fused_backward(x, wflat, bflat, lay, tier, ubar, fbar, gbar)
            torch.cuda.synchronize()
            again = fd.fused_backward(x, wflat, bflat, lay, tier, ubar, fbar, gbar)
            if not all(torch.equal(a, b) for a, b in zip(raw_bwd, again)):
                raise AssertionError(f"K2 ({tier}) is not bit-reproducible from run to run")
            k_bwd = true_layout(raw_bwd)
        kernel_out[tier] = (k_fwd, k_bwd)
        with torch.no_grad():
            e_fwd = fd.explicit_forward(x, wflat, bflat, lay, tier)
            if backward:
                e_bwd = true_layout(fd.explicit_backward(x, wflat, bflat, lay, tier,
                                                         ubar, fbar, gbar))
        for ref_name, rf, rb in (("explicit", e_fwd, e_bwd), ("autograd", ref_out, ref_bwd)):
            tol = TOL[(tier, ref_name)]
            for kname, outs, refs, names in (("K1", k_fwd, rf, names_fwd),
                                              ("K2", k_bwd, rb, names_bwd)):
                if outs is None:
                    continue
                for name, a, b in zip(names, outs, refs):
                    err, rel = rel_err(a, b)
                    errors[(kname, tier, ref_name, name)] = (err, rel)
                    log(f"  {kname} {lay.head:6s} {tier:8s} vs {ref_name:8s} {name:5s} "
                        f"max_abs_err={err:.3e} rel={rel:.3e} tol={tol:.0e}")
    # "high" against the f32 kernel on the same inputs
    for kname, i, names in (("K1", 0, names_fwd), ("K2", 1, names_bwd)):
        if not {"high", "highest"} <= set(kernel_out) or kernel_out["high"][i] is None:
            continue
        for name, a, b in zip(names, kernel_out["high"][i], kernel_out["highest"][i]):
            err, rel = rel_err(a, b)
            errors[(kname, "high", "highest", name)] = (err, rel)
            log(f"  {kname} {lay.head:6s} high     vs highest  {name:5s} max_abs_err={err:.3e} "
                f"rel={rel:.3e} tol={TOL[('high', 'highest')]:.0e}")
    bad = [(k, v) for k, v in errors.items() if v[1] > TOL[(k[1], k[2])]]
    if bad:
        raise AssertionError(f"kernel outputs outside tolerance: {bad}")
    inputs = dict(x=x, wflat=wflat, bflat=bflat, lay=lay, ubar=ubar, fbar=fbar, gbar=gbar,
                  n_weights=sum(t.numel() for t in ws + bs))
    return errors, inputs


def rms_rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt().clamp_min(1e-30))


# the shallow nets of check_high_rounding: name -> (net overrides, tolerance,
# the tiers check_kernels holds to both plain versions there). The skip net
# runs "high" and "highest" alone: at "default" one of its 58,368 points lies
# 2.2e-4 from the abs head's zero level, where bf16 flips the sign of the raw
# distance and so of the gradient, in the kernel and its explicit version
# alike (1.3e-3 apart), 0.67 of the largest entry from f32 autograd.
HIGH_ROUNDING_NETS = {
    "one hidden layer": (dict(n_layers=1, skip_in=()), TOL_HIGH_ROUNDING,
                         ("highest", "high", "default")),
    "skip net": (dict(n_layers=2, skip_in=(1,)), TOL_HIGH_ROUNDING_SKIP, ("highest", "high")),
}


def check_high_rounding(ucfg, dev, n_points: int = N_POINTS) -> dict:
    """Tier "high" of K1 and K2 on shallow nets at full width (where a
    rounding flip cascades little: one hidden layer, and two with a skip
    into the second, which runs the skip layer's own split of alpha [h; e]
    and K2's e panels) against the explicit version at "high": the kernel
    rounds what the TPU's _dot3 rounds, where it does."""
    from neuraludf_tpu_torch.ops import fused_distance as fd

    names = ("udf", "feat", "grad", "xbar", "wbar", "bbar")
    out = {}
    for net_name, (kw, tol, tiers) in HIGH_ROUNDING_NETS.items():
        _, kin = check_kernels(dataclasses.replace(ucfg, **kw), dev, n_points, tiers=tiers)
        x, wflat, bflat, lay = kin["x"], kin["wflat"], kin["bflat"], kin["lay"]
        cot = (kin["ubar"], kin["fbar"], kin["gbar"])
        run = {tier: list(fd.fused_forward(x, wflat, bflat, lay, tier))
               + list(fd.fused_backward(x, wflat, bflat, lay, tier, *cot))
               for tier in ("high", "highest")}
        with torch.no_grad():
            ref = list(fd.explicit_forward(x, wflat, bflat, lay, "high")) + list(
                fd.explicit_backward(x, wflat, bflat, lay, "high", *cot))
        err = {}
        for i, name in enumerate(names):
            err[name] = (rms_rel(run["high"][i], ref[i]), rms_rel(run["highest"][i], ref[i]))
            log(f"  {net_name}, N={n_points}: {name:5s} RMS rel. difference to the explicit "
                f"version at high: kernel high {err[name][0]:.2e} (tol {tol:.1e}), "
                f"kernel highest {err[name][1]:.2e}")
        bad = [n for n, (h, f) in err.items()
               if h > tol or (n not in ("udf", "feat") and f < 3 * tol)]
        if bad:
            raise AssertionError(f"tier 'high' on the {net_name} does not round as the explicit "
                                 f"version does: {bad}")
        out[net_name] = err
    return out


def check_refused_net(ucfg, dev, n_points: int = N_POINTS) -> dict:
    """K1 and K2 at tier "highest" on a net the sweeps refuse (128-wide
    hidden layers) go through the f32 CUDA-core GEMMs, against both plain
    versions (TOL)."""
    from neuraludf_tpu_torch.ops import fused_distance as fd

    narrow = dataclasses.replace(ucfg, d_hidden=128)
    route = fd.highest_route(fd.layout_for(narrow))
    kernels = (fd.fused_forward, fd.fused_backward)
    before = [{r: c.launches for r, c in k.routes.items()} for k in kernels]
    log(f"[kernels] K1/K2 at tier 'highest' on a {narrow.n_layers}x{narrow.d_hidden} net at "
        f"N={n_points}: route {route}")
    errors, _ = check_kernels(narrow, dev, n_points, tiers=("highest",))
    ran = [{r: c.launches - b[r] for r, c in k.routes.items()} for k, b in zip(kernels, before)]
    if route != "gemm" or any(n != (1 if r == "gemm" else 0) for r, n in ran[0].items()) or any(
            n != (2 if r == "gemm" else 0) for r, n in ran[1].items()):
        raise AssertionError(f"the refused net did not go through the f32 GEMMs alone: {ran}")
    return errors


def check_small_step(cfg, dataset, dev):
    """One loss and its gradients on a 64-ray batch: the kernels (tiers
    'highest' and 'high') against the plain autograd path, same params and
    draws."""
    from neuraludf_tpu_torch.ops import fused_distance as fd
    from neuraludf_tpu_torch.render.renderer import UDFRenderer
    from neuraludf_tpu_torch.train import step as tstep
    from neuraludf_tpu_torch.train.runner import init_params

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=64))
    sched = {"cos_anneal_ratio": 0.5, "flip_saturation": 0.0, "color_base_weight": 0.01,
             "color_weight": 1.0, "color_pixel_weight": 0.0, "color_patch_weight": 0.0,
             "mask_weight": 0.0, "igr_ns_weight": 0.0, "sparse_weight": 0.0, "igr_weight": 0.1}
    results = {}
    for core, prec in (("off", "highest"), ("on", "highest"), ("on", "high")):
        ucfg = dataclasses.replace(cfg.model.udf_network, fused_core=core, fused_precision=prec)
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, udf_network=ucfg))
        params = init_params(torch.Generator().manual_seed(1), c, dev)
        loss_fn = tstep.build_loss_fn(c, UDFRenderer(c.model))
        gen = torch.Generator(device=dev).manual_seed(2)
        launched = (fd.fused_forward.launches, fd.fused_backward.launches)
        total, _ = loss_fn(params, dataset.scene, 3, sched, gen)
        grads = tstep.param_grads(total, params)
        results[(core, prec)] = (total.detach(), grads)
        ran = (fd.fused_forward.launches - launched[0], fd.fused_backward.launches - launched[1])
        if ran != ((1, 1) if core == "on" else (0, 0)):
            raise AssertionError(f"fused_core={core!r} ({prec}) launched K1, K2 {ran} times")
    l_p, g_p = results[("off", "highest")]
    for prec, tol in (("highest", TOL_STEP), ("high", TOL_STEP_HIGH)):
        l_k, g_k = results[("on", prec)]
        err = abs(float(l_k) - float(l_p)) / abs(float(l_p))
        worst = max(rel_err(g_k[p], g_p[p])[1] for p in g_p if p[0] == "udf")
        log(f"  loss kernels ({prec})={float(l_k):.6f} plain={float(l_p):.6f} rel={err:.2e}; "
            f"udf grads worst rel={worst:.2e} tol={tol:.0e}")
        if not (err <= tol and worst <= tol):
            raise AssertionError(f"the kernels' training loss or gradients ({prec}) disagree "
                                 f"with the plain path")


def k3_inputs(scene, dev):
    """8 source views of the scene and positions of the finetune's shape,
    made from a seed: clusters like a ray's patches, and in the first rows
    out-of-image, exact-border, huge and NaN positions."""
    from neuraludf_tpu_torch.data.dataset import ref_src_info

    images = ref_src_info(scene, 0)[3]  # [8, 3, H, W], channel last in memory
    v, _, h, w = images.shape
    _, nw, p = K3_SHAPE
    if v != K3_SHAPE[0]:
        raise AssertionError(f"expected {K3_SHAPE[0]} source views, got {v}")
    gen = torch.Generator(device=dev).manual_seed(5)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    cx, cy = rand(v, nw, 1) * (w - 1), rand(v, nw, 1) * (h - 1)
    gx = cx + (rand(v, nw, p) - 0.5) * 60.0
    gy = cy + (rand(v, nw, p) - 0.5) * 60.0  # clusters near a border reach outside
    nan = float("nan")
    gx[:, 0, :12] = torch.tensor([0.0, w - 1.0, 0.0, w - 1.0, -0.5, w - 0.5, 1e11, -1e11, nan,
                                  17.0, 3.25, w - 1.0], device=dev)
    gy[:, 0, :12] = torch.tensor([0.0, h - 1.0, h - 1.0, 0.0, 10.0, 10.0, 5.0, -1e11, 7.0, nan,
                                  h - 1.0, 8.5], device=dev)
    gx[:, 1], gy[:, 1] = -1e11, 1e11
    gx[:, 2], gy[:, 2] = nan, nan
    return images, gx, gy


def library_sample(images, gx, gy):
    """The one PyTorch call that computes K3's colours; timed and compared
    here, used nowhere in the port."""
    import torch.nn.functional as F

    _, _, h, w = images.shape
    grid = torch.stack([2.0 * gx / (w - 1) - 1.0, 2.0 * gy / (h - 1) - 1.0], dim=-1)
    return F.grid_sample(images, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)  # [V, 3, NW, P]


def check_strip_sample(scene, dev):
    """K3 at the finetune's shape on seeded positions."""
    return check_strip_sample_at(*k3_inputs(scene, dev), both_sides=True)


def check_strip_sample_at(images, gx, gy, both_sides: bool):
    """K3 against its plain version and the library call; returns the
    errors and the inputs. ``both_sides``: the positions must fall both in
    and out of the image."""
    from neuraludf_tpu_torch.ops import strip_sample as ss

    colors, mask = ss.strip_sample(images, gx, gy)
    torch.cuda.synchronize()
    ref, ref_mask = ss.strip_sample_plain(images, gx, gy)
    lib = library_sample(images, gx, gy).permute(0, 2, 1, 3)
    if colors.shape != ref.shape or colors.dtype != torch.float32 or mask.dtype != torch.bool:
        raise AssertionError(f"K3 output {tuple(colors.shape)} {colors.dtype} {mask.dtype}")
    if not bool(torch.isfinite(colors).all()):
        raise AssertionError("K3: non-finite colour")
    if not torch.equal(mask, ref_mask):
        raise AssertionError("K3: mask differs from the plain version's")
    m = mask[:, :, None, :].expand_as(colors)
    errors = {"plain": float((colors - ref)[m].abs().max()),
              "library": float((colors - lib)[m].abs().max()),
              "plain_everywhere": float((colors - ref).abs().max())}
    share = float(mask.float().mean())
    log(f"  K3 vs plain   max_abs_err={errors['plain']:.3e} (mask true; "
        f"{errors['plain_everywhere']:.3e} everywhere) tol={TOL_K3['plain']:.0e}")
    log(f"  K3 vs library max_abs_err={errors['library']:.3e} tol={TOL_K3['library']:.0e}; "
        f"masks equal, in-image share {share:.3f}, all colours finite")
    if errors["plain"] > TOL_K3["plain"] or errors["library"] > TOL_K3["library"]:
        raise AssertionError(f"K3 outside tolerance: {errors}")
    if errors["plain_everywhere"] > TOL_K3["plain"]:
        raise AssertionError("K3 differs from the plain version where the mask is false")
    if both_sides and not 0.2 < share < 1.0:
        raise AssertionError(f"K3 check: in-image share {share}, both sides must be hit")
    if share == 0.0:
        raise AssertionError("K3 check: no position lies in its image")
    return errors, dict(images=images, gx=gx, gy=gy)


def check_small_blending_step(cfg, dataset, dev):
    """One blending loss and its gradients on a 64-ray batch with
    warp_sampler='strip': through K3 against the same through K3's plain
    version (K1/K2 at tier 'highest' on both sides), same params and draws;
    with the configuration's SSIM patch loss and with the L1 patch loss."""
    from neuraludf_tpu_torch.ops import strip_sample as ss
    from neuraludf_tpu_torch.render import renderer as renderer_mod
    from neuraludf_tpu_torch.train import step as tstep
    from neuraludf_tpu_torch.train.runner import init_params

    rcfg = dataclasses.replace(cfg.model.udf_renderer, warp_sampler="strip")
    ucfg = dataclasses.replace(cfg.model.udf_network, fused_core="on", fused_precision="highest")
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=64),
        model=dataclasses.replace(cfg.model, udf_renderer=rcfg, udf_network=ucfg))
    sched = {"cos_anneal_ratio": 0.5, "flip_saturation": 0.0, "color_base_weight": 0.01,
             "color_weight": 1.0, "color_pixel_weight": 0.1, "color_patch_weight": 0.1,
             "mask_weight": 0.0, "igr_ns_weight": 0.0, "sparse_weight": 0.0, "igr_weight": 0.1}
    kernel_entry = renderer_mod.strip_sample
    for loss_type, tol in TOL_STEP_BLENDING.items():
        c = dataclasses.replace(cfg, color_loss=dataclasses.replace(cfg.color_loss,
                                                                    patch_loss_type=loss_type))
        results = []
        for sampler in (kernel_entry, ss.strip_sample_plain):
            renderer_mod.strip_sample = sampler  # the reference pass swaps in the plain version
            try:
                params = init_params(torch.Generator().manual_seed(1), c, dev)
                loss_fn = tstep.build_loss_fn(c, renderer_mod.UDFRenderer(c.model),
                                              blending=True)
                gen = torch.Generator(device=dev).manual_seed(2)
                before = ss.strip_sample.launches
                total, metrics = loss_fn(params, dataset.scene, 3, sched, gen)
                launched = ss.strip_sample.launches - before
                results.append((total.detach(), tstep.param_grads(total, params), metrics))
            finally:
                renderer_mod.strip_sample = kernel_entry
            if launched != (1 if sampler is kernel_entry else 0):
                raise AssertionError(f"warp_sampler='strip' launched K3 {launched} times")
        (l_k, g_k, m_k), (l_p, g_p, _) = results
        err = abs(float(l_k) - float(l_p)) / abs(float(l_p))
        worst, leaf = max((rel_err(g_k[p], g_p[p])[1], "/".join(p)) for p in g_p
                          if g_p[p] is not None)
        log(f"  blending loss ({loss_type} patches) K3={float(l_k):.6f} plain={float(l_p):.6f} "
            f"rel={err:.2e}; grads worst rel={worst:.2e} ({leaf}) tol={tol:.0e}; pixel loss "
            f"{float(m_k['color_pixel_loss']):.4f}, patch loss "
            f"{float(m_k['color_patch_loss']):.4f}, cover {float(m_k['blend_strip_cover']):.3f}")
        if not (err <= TOL_STEP and worst <= tol):
            raise AssertionError("the blending loss or its gradients through K3 disagree with "
                                 "the plain version")
        if not (float(m_k["color_pixel_loss"]) > 0 and float(m_k["color_patch_loss"]) > 0):
            raise AssertionError("a blending loss term is zero")


def train_main_path(runner, cfg, exp_dir, counters, on_path):
    """Runner.train with the launch counts of ``counters`` (name -> kernel
    entry) set to 0 just before and read just after; checks the loss, that
    every kernel of ``on_path`` ran once in every step and that no other
    ran. Returns the launches and the metric rows of the run."""
    for k in counters.values():
        k.launches = 0
    first = runner.iter_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    runner.train()
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = {name: k.launches for name, k in counters.items()}
    n_steps = runner.iter_step - first
    log_path = exp_dir / cfg.general.expname / "logs" / "metrics.jsonl"
    rows = [json.loads(line) for line in log_path.read_text().splitlines()][-n_steps:]
    losses = [r["loss"] for r in rows]
    means = [sum(losses[i:i + 50]) / 50 for i in range(0, n_steps, 50)]
    log(f"[train] {cfg.general.expname}: {n_steps} steps in {train_s:.1f} s; launches {launches}; "
        f"window mean losses {['%.5f' % m for m in means]}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if n_steps <= 0 or not all(math.isfinite(v) for r in rows for k, v in r.items()
                               if k.endswith(("loss", "error"))):
        raise AssertionError("no step ran, or a non-finite loss term")
    if any(n != (n_steps if name in on_path else 0) for name, n in launches.items()):
        raise AssertionError(f"kernels {on_path} did not run once in every step, or another "
                             f"ran: {launches}, {n_steps} steps")
    if not means[-1] <= means[0]:
        raise AssertionError(f"training loss did not decrease: window means {means}")
    return launches, rows


def train_tier(tier, ckpt, common, exp_dir, n_stage1, dev, counters) -> dict:
    """Both training paths at ``fused_precision = tier``, TIER_STEPS steps
    each from the stage-1 checkpoint at full width, in an experiment
    directory of their own; K1 and K2 launch once a step, each through the
    route the tier takes on the main-path net (its route counter once a
    step, every other route's 0). Returns the launches by path."""
    from neuraludf_tpu_torch import config as config_mod
    from neuraludf_tpu_torch.ops import fused_distance as fd
    from neuraludf_tpu_torch.train.runner import Runner

    t0 = time.time()
    tier_dir = exp_dir / tier
    over = dict(common, general__base_exp_dir=str(tier_dir),
                model__udf_network__fused_precision=tier)
    cfg = config_mod.load(str(CONF), train__end_iter=n_stage1 + TIER_STEPS,
                          train__save_freq=n_stage1, **over)
    route = fd.route_for(fd.layout_for(cfg.model.udf_network), tier)
    with_routes = dict(counters, **{f"{name}/{r}": kern.routes[r] for name, kern in
                                    (("K1", fd.fused_forward), ("K2", fd.fused_backward))
                                    for r in fd.ROUTES})
    on_path = ("K1", "K2", f"K1/{route}", f"K2/{route}")
    runner = Runner(cfg, device=dev, seed=0)
    runner.load_checkpoint(ckpt)
    log(f"[{tier}] stage 1 at fused_precision={tier}, route {route}, from {Path(ckpt).name}")
    launches = {"stage1": train_main_path(runner, cfg, tier_dir, with_routes, on_path)[0]}
    ft_cfg = config_mod.load(str(FT_CONF), train__end_iter=TIER_STEPS, **FT_SCHEDULE, **over)
    ft_runner = Runner(ft_cfg, device=dev, seed=1, is_finetune=True)
    ft_runner.load_checkpoint(ckpt)
    log(f"[{tier}] finetune at fused_precision={tier}, route {route}")
    launches["finetune"], ft_rows = train_main_path(ft_runner, ft_cfg, tier_dir, with_routes,
                                                    on_path + ("K3",))
    check_finetune_rows(ft_rows)
    del runner, ft_runner
    torch.cuda.empty_cache()
    log(f"[{tier}] ok in {time.time() - t0:.1f} s")
    return launches


def time_graphed_tiers(ckpt, common, exp_dir, dev, card) -> dict:
    """The graphed stage-1 step at every tier from the stage-1 checkpoint,
    the tiers in turns (``time_in_turns``)."""
    from neuraludf_tpu_torch import config as config_mod
    from neuraludf_tpu_torch.train.runner import Runner

    runners = {}
    for tier in TIERS:
        cfg = config_mod.load(str(CONF), **dict(
            common, general__base_exp_dir=str(exp_dir / "timed" / tier),
            model__udf_network__fused_precision=tier))
        runners[tier] = Runner(cfg, device=dev, seed=0)
        runners[tier].load_checkpoint(ckpt)
    out = time_in_turns({f"stage-1 step at fused_precision={tier}": r
                         for tier, r in runners.items()}, "tiers", card)
    del runners
    torch.cuda.empty_cache()
    return {tier: out[f"stage-1 step at fused_precision={tier}"] for tier in TIERS}


def time_in_turns(runners: dict, tag: str, card) -> dict:
    """Host-clock ms a graphed step of each runner (name -> Runner) over
    TIMED_REPEATS repeats of TIMED_STEPS iterations (a window of
    TIMED_STEPS, captured before the timing), the runners in turns, each
    repeat ended by a synchronize."""
    inputs = {}
    for name, runner in runners.items():
        inputs[name] = window_inputs(runner, TIMED_STEPS)
        graphed_steps(runner, *inputs[name])  # warm-up and capture
    times = {name: [] for name in runners}
    for _ in range(TIMED_REPEATS):
        for name, runner in runners.items():
            torch.cuda.synchronize()
            t0 = time.time()
            graphed_steps(runner, *inputs[name])
            torch.cuda.synchronize()
            times[name].append((time.time() - t0) / TIMED_STEPS * 1e3)
    out = {}
    for name, ts in times.items():
        med = sorted(ts)[len(ts) // 2]
        out[name] = {"median_ms": med, "min_ms": min(ts), "max_ms": max(ts), "ms": ts,
                     "rays_per_s": runners[name].cfg.train.batch_size / med * 1e3}
        log(f"[{tag}] graphed {name}: median {med:.2f} ms (min {min(ts):.2f}, max "
            f"{max(ts):.2f}; {TIMED_REPEATS} x {TIMED_STEPS} steps in turns) = "
            f"{out[name]['rays_per_s']:.0f} rays/s  [{card}]")
    return out


def check_finetune_rows(rows):
    """The blending terms really contributed in every finetune step."""
    for key in ("color_pixel_loss", "color_patch_loss"):
        if not all(r[key] > 0.0 for r in rows):
            raise AssertionError(f"{key} is zero in a finetune step")
    if not all(0.0 < r["blend_strip_cover"] <= 1.0 for r in rows):
        raise AssertionError("blend_strip_cover outside (0, 1]")
    mean = lambda key: sum(r[key] for r in rows) / len(rows)
    log(f"[train] finetune means: pixel loss {mean('color_pixel_loss'):.4f}, patch loss "
        f"{mean('color_patch_loss'):.4f}, blend_strip_cover {mean('blend_strip_cover'):.4f}, "
        f"psnr {mean('psnr'):.2f}")


def window_inputs(runner, k: int):
    """The schedules, schedule rows and views of k iterations from the
    runner's iter_step (views in order, as a device tensor)."""
    from neuraludf_tpu_torch.train import schedules

    scheds = [runner._schedules_at(runner.iter_step + j) for j in range(k)]
    rows = torch.from_numpy(schedules.schedule_rows(scheds)).to(runner.device)
    idxs = (torch.arange(k, device=runner.device) + runner.iter_step) % runner.dataset.n_images
    return scheds, rows, idxs


def eager_steps(runner, scheds, rows, idxs) -> torch.Tensor:
    """The eager step body over the given iterations: metric rows [k, M]."""
    from neuraludf_tpu_torch.train.step import METRIC_KEYS

    body = runner.step_body(scheds[0])
    out = []
    for j in range(len(scheds)):
        m = body(runner.params, runner.opt_state, runner.dataset.scene, idxs[j], rows[j],
                 runner.generator)
        out.append(torch.stack([m[name] for name in METRIC_KEYS]))
    runner.iter_step += len(scheds)
    return torch.stack(out)


def graphed_steps(runner, scheds, rows, idxs) -> torch.Tensor:
    """The same iterations through the runner's window of len(scheds)."""
    from neuraludf_tpu_torch.train import schedules

    window_fn = runner._get_window_fn(schedules.is_blending(scheds[0]), len(scheds))
    out = window_fn(runner.params, runner.opt_state, runner.dataset.scene, idxs,
                    runner.generator, rows)
    runner.iter_step += len(scheds)
    return out


def differences(rows_a, rows_b, runner_a, runner_b) -> dict:
    """How two runs of the same iterations differ: bit equality of the first
    step's metric row and of all rows, the largest relative difference of
    the loss over the steps, of each parameter leaf (to its largest entry)
    at the end, and whether both consumed the generator alike."""
    from neuraludf_tpu_torch.train.optim import leaves
    from neuraludf_tpu_torch.train.step import METRIC_KEYS

    loss = METRIC_KEYS.index("loss")
    worst, leaf = 0.0, ""
    for (path, a), (_, b) in zip(leaves(runner_a.params), leaves(runner_b.params)):
        rel = (a.detach() - b.detach()).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if rel > worst:
            worst, leaf = rel, "/".join(path)
    return {"first_step_bit_equal": torch.equal(rows_a[0], rows_b[0]),
            "all_rows_bit_equal": torch.equal(rows_a, rows_b),
            "loss_max_rel": ((rows_a[:, loss] - rows_b[:, loss]).abs()
                             / rows_b[:, loss].abs()).max().item(),
            "params_max_rel": worst, "params_worst_leaf": leaf,
            "generators_equal": torch.equal(runner_a.generator.get_state(),
                                            runner_b.generator.get_state())}


def time_windows(g_runner, e_runner, card) -> dict:
    """Host-clock ms a step of TIMED_REPEATS repeats of TIMED_STEPS
    iterations, graphed (a window of TIMED_STEPS, captured before the
    timing) against eager, alternating, each ended by a synchronize."""
    scheds, rows, idxs = window_inputs(g_runner, TIMED_STEPS)
    graphed_steps(g_runner, scheds, rows, idxs)  # warm-up and capture
    eager_steps(e_runner, scheds[:1], rows[:1], idxs[:1])
    times = {"graphed": [], "eager": []}
    for _ in range(TIMED_REPEATS):
        for name, run, r in (("graphed", graphed_steps, g_runner),
                             ("eager", eager_steps, e_runner)):
            torch.cuda.synchronize()
            t0 = time.time()
            run(r, scheds, rows, idxs)
            torch.cuda.synchronize()
            times[name].append((time.time() - t0) / TIMED_STEPS * 1e3)
    out = {}
    for name, ts in times.items():
        med = sorted(ts)[len(ts) // 2]
        out[name] = {"median_ms": med, "min_ms": min(ts), "max_ms": max(ts), "ms": ts,
                     "rays_per_s": g_runner.cfg.train.batch_size / med * 1e3}
        log(f"[window] {g_runner.cfg.general.expname} {name} step: median {med:.2f} ms "
            f"(min {min(ts):.2f}, max {max(ts):.2f}; {TIMED_REPEATS} x {TIMED_STEPS} steps) = "
            f"{out[name]['rays_per_s']:.0f} rays/s  [{card}]")
    return out


def profile_window(runner, card) -> dict:
    """Device time and kernel count a step inside graph replays
    (torch.profiler over one captured window of TIMED_STEPS), against the
    host clock."""
    from torch.profiler import ProfilerActivity, profile

    scheds, rows, idxs = window_inputs(runner, TIMED_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        graphed_steps(runner, scheds, rows, idxs)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / TIMED_STEPS
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / TIMED_STEPS
    count = sum(e.count for e in kern) / TIMED_STEPS
    if busy == 0:
        log("[window] the profiler saw no device time inside the replays: not measured")
        return {"wall_ms": wall_ms, "busy_ms": None, "busy_share": None, "kernels": None}
    log(f"[window] {runner.cfg.general.expname} replayed step under the profiler: {count:.0f} "
        f"kernels, device busy {busy:.2f} of {wall_ms:.2f} ms (busy share "
        f"{busy / wall_ms:.2f})  [{card}]")
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms, "kernels": count}


def check_window_tolerance(graphed: dict, run_to_run: dict) -> None:
    """TOL_WINDOW, against the eager loop's own spread from run to run."""
    if not (graphed["generators_equal"] and run_to_run["generators_equal"]):
        raise AssertionError("[window] the runs consumed the generator differently")
    if run_to_run["all_rows_bit_equal"] and run_to_run["params_max_rel"] == 0.0:
        if not (graphed["all_rows_bit_equal"] and graphed["params_max_rel"] == 0.0):
            raise AssertionError(f"[window] the eager loop repeats itself bit for bit, the "
                                 f"graphed window differs from it: {graphed}")
        return
    for key in ("loss_max_rel", "params_max_rel"):
        if graphed[key] > max(TOL_WINDOW, 10 * run_to_run[key]):
            raise AssertionError(f"[window] graphed vs eager {key} {graphed[key]:.2e} over "
                                 f"{TOL_WINDOW:.0e} and 10x the eager run-to-run "
                                 f"{run_to_run[key]:.2e}")


def check_window(cfg, ckpt, dev, counters, on_path, card, *, seed: int, is_finetune: bool):
    """[window]: WINDOW_STEPS iterations from ``ckpt`` through the graphed
    window (its warm-up and capture included) and through the eager loop,
    two runners on one start state and generator state; launch counts of the
    graphed run (once a step for each kernel of ``on_path``); the compare;
    then step times, the replayed step's device-busy share, and the graph
    pool's memory."""
    from neuraludf_tpu_torch.train.runner import Runner

    g_runner, e_runner, e2_runner = (Runner(cfg, device=dev, seed=seed, is_finetune=is_finetune)
                                     for _ in range(3))
    for r in (g_runner, e_runner, e2_runner):
        r.load_checkpoint(ckpt)
    scheds, rows, idxs = window_inputs(g_runner, WINDOW_STEPS)
    for k in counters.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    graphed = graphed_steps(g_runner, scheds, rows, idxs)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {name: k.launches for name, k in counters.items()}
    torch.cuda.empty_cache()  # what stays reserved is the graph's pool and the static buffers
    memory = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "graph_pool_gib": (torch.cuda.memory_reserved() - reserved) / 2**30}
    log(f"[window] {cfg.general.expname}: {WINDOW_STEPS} graphed steps (2 eager warm-up, the "
        f"capture, {WINDOW_STEPS - 2} replays) in {first_s:.1f} s; launches {launches}; peak "
        f"device memory {memory['peak_gib']:.2f} GiB; the graph's pool holds "
        f"{memory['graph_pool_gib']:.2f} GiB")
    if any(n != (WINDOW_STEPS if name in on_path else 0) for name, n in launches.items()):
        raise AssertionError(f"[window] kernels {on_path} did not run once a graphed step: "
                             f"{launches}")
    eager = eager_steps(e_runner, scheds, rows, idxs)
    eager2 = eager_steps(e2_runner, scheds, rows, idxs)
    out = {"launches": launches, "memory": memory,
           "graphed_vs_eager": differences(graphed, eager, g_runner, e_runner),
           "eager_vs_eager": differences(eager2, eager, e2_runner, e_runner)}
    for name in ("graphed_vs_eager", "eager_vs_eager"):
        log(f"[window] {cfg.general.expname} {name} over {WINDOW_STEPS} steps: {out[name]}")
    check_window_tolerance(out["graphed_vs_eager"], out["eager_vs_eager"])
    del e2_runner
    out["times"] = time_windows(g_runner, e_runner, card)
    out["profile"] = profile_window(g_runner, card)
    return out


def grid_parity(runner):
    """The MeshUDF grid at 64³ on the card against the same parameters on
    the CPU."""
    from neuraludf_tpu_torch import convert
    from neuraludf_tpu_torch.mesh import grid

    ucfg, R = runner.cfg.model.udf_network, MESH_PARITY_RES
    on_cpu = {"udf": convert.to_torch(convert.to_numpy(runner.params["udf"]), "cpu")}
    u_card, n_card = grid.udf_and_normals_grid(runner.params, ucfg, R)
    u_cpu, n_cpu = grid.udf_and_normals_grid(on_cpu, ucfg, R)
    band_card, band_cpu = (n_card != 0).any(-1), (n_cpu != 0).any(-1)
    at_edge = abs(u_cpu - 2 * (2.0 / (R - 1))) < TOL_GRID["band_edge"]
    differ = int(((band_card != band_cpu) & ~at_edge).sum())
    both = band_card & band_cpu
    if not both.any():
        raise AssertionError("the 64³ grid has no near-surface band")
    udf_err = float(abs(u_card - u_cpu).max())
    nrm_err = float(abs(n_card[both] - n_cpu[both]).max())
    log(f"  grid {R}³ card vs CPU: udf max_abs_err={udf_err:.3e} tol={TOL_GRID['udf']:.0e}; "
        f"normals max_abs_err={nrm_err:.3e} tol={TOL_GRID['normals']:.0e} over {int(both.sum())} "
        f"band points; band masks differ at {differ} points away from the edge")
    if udf_err > TOL_GRID["udf"] or nrm_err > TOL_GRID["normals"] or differ:
        raise AssertionError("the grid on the card disagrees with the CPU's")
    return {"udf_err": udf_err, "normals_err": nrm_err}


def time_grid_fill(runner, card):
    """CUDA-event times and peak device memory of the 512³ grid fill and of
    the near band's normals, with the operations of the fill's forward
    passes (2 per multiply-add) against the f32 peak."""
    from neuraludf_tpu_torch.mesh import grid
    from neuraludf_tpu_torch.nets import fields

    ucfg, R, p = runner.cfg.model.udf_network, MESH_RES, runner.params["udf"]
    dims, d0 = fields.distance_dims(ucfg)
    macs = sum(dims[l] * (dims[l + 1] - d0 if (l + 1) in ucfg.skip_in else dims[l + 1])
               for l in range(ucfg.n_layers + 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    udf = grid.fill_on_device(p, ucfg, [-1, -1, -1], [1, 1, 1], R)
    ev[1].record()
    normals = grid.band_normals_on_device(p, ucfg, udf, R)
    ev[2].record()
    ev[2].synchronize()
    n_band = int((normals != 0).any(-1).sum())
    out = {"fill_ms": ev[0].elapsed_time(ev[1]), "band_ms": ev[1].elapsed_time(ev[2]),
           "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30, "band_points": n_band,
           "fill_tflop": 2.0 * R ** 3 * macs / 1e12}
    out["fill_bound_ms"] = out["fill_tflop"] * 1e12 / PEAK_FLOPS["highest"] * 1e3
    del udf, normals
    log(f"[time] grid fill {R}³ ({R ** 3} points, {out['fill_tflop']:.1f} TFLOP f32): "
        f"{out['fill_ms']:.1f} ms on the device (bound {out['fill_bound_ms']:.1f} ms, "
        f"{100 * out['fill_bound_ms'] / out['fill_ms']:.1f}% of it reached); band normals "
        f"({n_band} points) {out['band_ms']:.1f} ms; peak device memory "
        f"{out['peak_gib']:.2f} GiB above the resident {held / 2**30:.2f} GiB  [{card}]")
    return out


def geometry_close(va, fa, vb, fb, voxel) -> tuple:
    """The contract of two extractions of one field: face counts within 3%,
    mean nearest-vertex distance below voxel/100, maximum below voxel."""
    from scipy.spatial import cKDTree

    d = cKDTree(vb).query(va, k=1)[0]
    ok = abs(len(fa) - len(fb)) <= 0.03 * len(fb) and d.mean() < voxel / 100 and d.max() < voxel
    return ok, float(d.mean()), float(d.max())


def check_mesh(runner, card):
    """The [mesh] phase on the runner's field: grid parity, the CLI's
    closing extraction at 512³, validate_mesh and the incremental
    extraction at 256³, the Chamfer distance to the sphere."""
    import numpy as np

    from neuraludf_tpu_torch.data.synthetic import gt_surface_points
    from neuraludf_tpu_torch.eval.chamfer import eval_mesh
    from neuraludf_tpu_torch.mesh import grid, meshudf
    from neuraludf_tpu_torch.mesh.ply import export_ply, load_ply

    ucfg = runner.cfg.model.udf_network
    out = {"parity": grid_parity(runner), "fill": time_grid_fill(runner, card)}

    # the CLI's closing extraction
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.time()
    path = runner.extract_udf_mesh(resolution=MESH_RES, world_space=True,
                                   dist_threshold_ratio=5.0, timings=timings)
    total_s = time.time() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30  # the windows' graph pools included
    verts_w, faces = load_ply(path)
    sm = runner.dataset.scale_mats_np[0]
    verts = ((verts_w - sm[:3, 3][None]) / sm[0, 0]).astype(np.float32)
    voxel = 2.0 / (MESH_RES - 1)
    if len(faces) == 0 or not np.isfinite(verts).all():
        raise AssertionError(f"the {MESH_RES}³ mesh is empty or has a non-finite vertex")
    residual = float(np.abs(grid.query_udf_at(runner.params, ucfg, verts)).mean())
    out["extract"] = {"verts": len(verts), "faces": len(faces), "total_s": total_s,
                      "peak_gib": peak, "peak_reserved_gib": reserved, "mean_abs_udf": residual,
                      **timings}
    log(f"[mesh] extract_udf_mesh {MESH_RES}³: {len(verts)} vertices, {len(faces)} faces in "
        f"{total_s:.1f} s (host clock: " + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items())
        + f"); peak device memory {peak:.2f} GiB ({reserved:.2f} GiB reserved in all, the "
        f"training windows' graph pools included); mean |udf| at the vertices {residual:.2e} "
        f"(limit voxel/2 = {voxel / 2:.2e})  [{card}]")
    if residual > voxel / 2:
        raise AssertionError("the extracted vertices do not sit on the zero level")

    t0 = time.time()
    vm_verts, vm_faces = load_ply(runner.validate_mesh(resolution=MESH_CHECK_RES))
    out["validate_mesh"] = {"faces": len(vm_faces), "s": time.time() - t0}
    log(f"[mesh] validate_mesh {MESH_CHECK_RES}³: {len(vm_verts)} vertices, {len(vm_faces)} "
        f"faces in {out['validate_mesh']['s']:.1f} s")
    if len(vm_faces) == 0:
        raise AssertionError("validate_mesh wrote an empty mesh")

    cache, times = {}, []
    meshes = []
    for _ in range(2):
        t0 = time.time()
        meshes.append(meshudf.get_mesh_udf(runner.params, ucfg, resolution=MESH_CHECK_RES,
                                           dist_threshold_ratio=5.0, cache=cache))
        times.append(time.time() - t0)
    (v_full, f_full), (v_inc, f_inc) = meshes
    ok, d_mean, d_max = geometry_close(v_inc, f_inc, v_full, f_full, 2.0 / (MESH_CHECK_RES - 1))
    out["incremental"] = {"full_s": times[0], "incremental_s": times[1], "faces_full": len(f_full),
                          "faces_incremental": len(f_inc), "nn_mean": d_mean, "nn_max": d_max}
    log(f"[mesh] incremental {MESH_CHECK_RES}³: full {times[0]:.2f} s ({len(f_full)} faces), "
        f"incremental {times[1]:.2f} s ({len(f_inc)} faces); nearest-vertex distance mean "
        f"{d_mean:.2e} max {d_max:.2e} (voxel {2.0 / (MESH_CHECK_RES - 1):.2e})  [{card}]")
    if cache.get("incr_count") != 1 or not ok:
        raise AssertionError("the incremental extraction disagrees with the full fill")

    normalized = str(BUILD / "smoke_exp" / f"mesh_{MESH_RES}_normalized.ply")
    export_ply(normalized, verts, faces)
    t0 = time.time()
    res = eval_mesh(normalized, gt_surface_points("sphere").astype(np.float64), **CHAMFER)
    out["chamfer"] = dataclasses.asdict(res)
    log(f"[mesh] Chamfer of the {MESH_RES}³ mesh to the sphere after {runner.iter_step} steps: "
        f"{res.chamfer:.5f} (to GT {res.mean_d2s:.5f}, from GT {res.mean_s2d:.5f}; "
        f"F@{CHAMFER['thresh2']} {res.fscore_2:.3f}) in {time.time() - t0:.1f} s")
    print(json.dumps({"mesh": out}), flush=True)
    return out


def validation_chunk(runner):
    """4,096 rays across the middle rows of view VAL_IDX at full resolution:
    the sphere and the background."""
    rays_o, rays_d = runner.dataset.gen_rays_at(VAL_IDX, 1)
    bs = runner.cfg.train.batch_size * 8
    mid = rays_o.shape[0] * rays_o.shape[1] // 2
    rows = slice(mid - bs // 2, mid + bs // 2)
    return rays_o.reshape(-1, 3)[rows], rays_d.reshape(-1, 3)[rows]


def render_chunk_with(runner, model_cfg, sampler, rays):
    """Runner.render_chunk of ``rays`` with the renderer of ``model_cfg``
    and ``sampler`` as the warp sampler, on the runner's generator state
    (restored afterwards, so every variant gets the same draws)."""
    from neuraludf_tpu_torch.render import renderer as renderer_mod
    from neuraludf_tpu_torch.train import schedules

    kernel_entry, renderer, state = (renderer_mod.strip_sample, runner.renderer,
                                     runner.generator.get_state())
    renderer_mod.strip_sample = sampler
    runner.renderer = renderer_mod.UDFRenderer(model_cfg)
    try:
        ret = runner.render_chunk(*rays, VAL_IDX, pixel_blending=True,
                                  cos_anneal=schedules.cos_anneal_ratio(runner.iter_step,
                                                                        runner.cfg.train))
        return runner.image_rows(ret)
    finally:
        renderer_mod.strip_sample, runner.renderer = kernel_entry, renderer
        runner.generator.set_state(state)


def check_validation_chunk(runner):
    """One 4,096-ray validation chunk through the kernels (each tier of K1,
    K3) against the plain path; K3 alone at the chunk's own positions
    against its plain version and F.grid_sample. Returns K3's errors and
    inputs."""
    from neuraludf_tpu_torch.ops import strip_sample as ss

    mcfg = runner.cfg.model
    rays = validation_chunk(runner)
    variant = lambda **kw: dataclasses.replace(
        mcfg, udf_network=dataclasses.replace(mcfg.udf_network, **kw))
    plain = render_chunk_with(runner, variant(fused_core="off"), ss.strip_sample_plain, rays)
    recorded = []

    def recording(images, gx, gy):
        recorded.append((images, gx, gy))
        return ss.strip_sample(images, gx, gy)

    names = {"color": slice(0, 3), "color_pixel": slice(3, 6), "normal": slice(6, 9),
             "depth": slice(9, 10)}
    for tier in ("highest", "default"):
        before = ss.strip_sample.launches
        out = render_chunk_with(runner, variant(fused_core="on", fused_precision=tier),
                                recording, rays)
        if ss.strip_sample.launches - before != 1:
            raise AssertionError("the validation chunk did not launch K3 once")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"the validation chunk ({tier}) has a non-finite output")
        for name, cols in names.items():
            d = (out[:, cols] - plain[:, cols]).abs()
            worst, mean = float(d.max()), float(d.mean())
            tol_max, tol_mean = TOL_VAL[tier][name]
            log(f"  chunk {tier:8s} {name:11s} max_abs_err={worst:.3e} (tol {tol_max:.0e}) "
                f"mean={mean:.3e} (tol {tol_mean:.0e})")
            if worst > tol_max or mean > tol_mean:
                raise AssertionError(f"the validation chunk ({tier}) disagrees with the plain "
                                     f"path in {name}")
    if float(plain[:, 3:6].abs().max()) == 0.0:
        raise AssertionError("the validation chunk rendered no pixel-blended colour")

    images, gx, gy = recorded[-1]
    if tuple(gx.shape) != K3_VAL_SHAPE:
        raise AssertionError(f"K3 at the validation chunk: positions {tuple(gx.shape)}, "
                             f"expected {K3_VAL_SHAPE}")
    log(f"[kernels] K3 at the validation chunk's own positions {K3_VAL_SHAPE}")
    return check_strip_sample_at(images, gx, gy, both_sides=False)


def check_png(path, shape):
    """The PNG exists, decodes, and has the expected shape."""
    from neuraludf_tpu_torch.data.png import read_png

    img = read_png(str(path))
    if img.shape != shape:
        raise AssertionError(f"{path}: shape {img.shape}, expected {shape}")


def check_validate(runner, cfg, exp_dir, counters, card):
    """[validate] on the stage-1 runner: the kernels at the validation
    shapes, Runner.validate at level 4 as the main path (launch counts equal
    to the chunk count), the CLI's validate_image at level 1, a novel view,
    the ray statistics, the HDF5 dump, and a short training run across
    val_freq. Returns the numbers for the kernels line and PERF.md."""
    import numpy as np

    from neuraludf_tpu_torch import cli
    from neuraludf_tpu_torch.mesh import grid as mesh_grid
    from neuraludf_tpu_torch.train.runner import Runner

    out = {}
    log(f"[kernels] K1 at N={N_VAL_POINTS} (a validation chunk), forward only")
    out["k1_errors"], out["k1_inputs"] = check_kernels(runner.cfg.model.udf_network, runner.device,
                                                       N_VAL_POINTS, backward=False)
    log("[validate] a 4,096-ray chunk through the kernels against the plain path")
    out["k3_errors"], out["k3_inputs"] = check_validation_chunk(runner)

    # the main path: one validation render at level 4
    exp_root = exp_dir / cfg.general.expname
    h, w = runner.dataset.H // 4, runner.dataset.W // 4
    bs = runner.cfg.train.batch_size * 8
    n_chunks = -(-h * w // bs)
    rendered = []
    render_rays = runner.render_rays
    runner.render_rays = lambda *a, **k: rendered.append(render_rays(*a, **k)) or rendered[-1]
    for k in counters.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.time()
    try:
        runner.validate(VAL_IDX, resolution_level=4)
    finally:
        del runner.render_rays
    torch.cuda.synchronize()
    out["validate_s"] = time.time() - t0
    out["validate_peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    launches = {name: k.launches for name, k in counters.items()}
    out["launches"] = launches
    (img,) = rendered
    log(f"[validate] Runner.validate(level 4): {h * w} rays, {n_chunks} chunks in "
        f"{out['validate_s']:.2f} s; launches {launches}; peak device memory "
        f"{out['validate_peak_gib']:.2f} GiB above the resident {held / 2**30:.2f} GiB  [{card}]")
    if launches != {"K1": n_chunks, "K2": 0, "K3": n_chunks}:
        raise AssertionError(f"validate: launches {launches}, expected K1 = K3 = {n_chunks}")
    if img.shape != (h * w, 10) or not np.isfinite(img).all():
        raise AssertionError("validate rendered a non-finite image or one of the wrong shape")
    gt = runner.dataset.image_at(VAL_IDX, 4).reshape(-1, 3) / 256.0
    psnr = {k: float(-10 * np.log10(np.mean((img[:, cols] - gt) ** 2)))
            for k, cols in (("color", slice(0, 3)), ("color_pixel", slice(3, 6)))}
    out["validate_psnr"] = psnr
    log(f"[validate] PSNR against the ground truth: colour {psnr['color']:.2f} dB, pixel-blended "
        f"{psnr['color_pixel']:.2f} dB after {runner.iter_step} steps")
    name = f"{runner.iter_step:0>8d}_{VAL_IDX}.png"
    check_png(exp_root / "validations_fine" / name, (3 * h, w, 3))
    check_png(exp_root / "normals" / name, (h, w, 3))
    check_png(exp_root / "depth" / name, (h, w, 3))

    # the CLI's validate_image at level 1, from the stage-1 checkpoint
    conf = BUILD / "smoke_validate.conf"
    conf.write_text(CONF.read_text()
                    .replace("./exp/udf/synthetic/CASE_NAME/", str(exp_dir) + "/")
                    .replace("./data/synthetic/CASE_NAME/", str(runner.dataset.data_dir) + "/"))
    times = []
    validate = Runner.validate

    def timed(self, *a, **k):
        torch.cuda.synchronize()
        t = time.time()
        validate(self, *a, **k)
        torch.cuda.synchronize()
        times.append(time.time() - t)

    Runner.validate = timed
    for k in counters.values():
        k.launches = 0
    t0 = time.time()
    try:
        cli.main(["--mode", "validate_image", "--conf", str(conf), "--case", "sphere",
                  "--is_continue"])
    finally:
        Runner.validate = validate
    out["cli_s"] = time.time() - t0
    n_img = len(range(0, min(80, runner.dataset.n_images), 10))
    rays = runner.dataset.H * runner.dataset.W
    per_window = min(8, -(-rays // bs))  # Runner.render_rays: windows of up to 8 chunks
    chunks = n_img * -(-rays // (bs * per_window)) * per_window
    out["validate_image"] = {"images": n_img, "rays": rays, "s": times,
                             "rays_per_s": [rays / t for t in times]}
    launches = out["cli_launches"] = {name: k.launches for name, k in counters.items()}
    log(f"[validate] CLI validate_image (level 1, {n_img} views of {rays} rays, {chunks} chunks): "
        f"{out['cli_s']:.1f} s in all; per view " + ", ".join(
            f"{t:.2f} s = {rays / t:.0f} rays/s" for t in times) + f"; launches {launches}  [{card}]")
    if launches != {"K1": chunks, "K2": 0, "K3": chunks} or len(times) != n_img:
        raise AssertionError(f"validate_image: launches {launches}, expected K1 = K3 = {chunks}")
    for i in range(0, n_img * 10, 10):
        check_png(exp_root / "novel_view" / f"pred_{i}.png",
                  (runner.dataset.H, runner.dataset.W, 3))

    # the other modes, once each
    t0 = time.time()
    path = runner.validate_novel_image(0, 1, 0.5, out_idx=0, resolution_level=4)
    check_png(path, (h, w, 3))
    fig = Path(runner.visualize_one_ray(VAL_IDX, runner.dataset.W // 2, runner.dataset.H // 2))
    check_png(fig, (4200, 1000, 3))
    stats = np.load(fig.with_suffix(".npy"), allow_pickle=True).item()
    if sorted(stats) != ["cos", "udf", "z_vals"] or not all(
            np.isfinite(v).all() for v in stats.values()):
        raise AssertionError("visualize_one_ray wrote a malformed .npy")
    res = 128
    path = Path(runner.save_hdf5(resolution=res))
    u = mesh_grid.extract_fields(runner.params, runner.cfg.model.udf_network, *runner._bbox(),
                                 res + 1)
    data = np.frombuffer(path.read_bytes()[-u.nbytes:], dtype="<f4").reshape(u.shape)
    if not np.allclose(data, u / u.max() * 0.5, rtol=0, atol=1e-6):
        raise AssertionError("save_hdf5 wrote other values than the grid's")
    out["other_modes_s"] = time.time() - t0
    log(f"[validate] validate_novel_image, visualize_one_ray and save_hdf5 ({res + 1}³, "
        f"{path.stat().st_size} bytes) in {out['other_modes_s']:.1f} s")

    # a short training run across val_freq writes its validation image
    runner.cfg = dataclasses.replace(runner.cfg, train=dataclasses.replace(
        runner.cfg.train, val_freq=VAL_FREQ))
    runner.end_iter = runner.iter_step + VAL_FREQ
    runner.train()
    written = sorted((exp_root / "validations_fine").glob(f"{runner.iter_step:0>8d}_*.png"))
    log(f"[validate] training to {runner.iter_step} with val_freq {VAL_FREQ} wrote "
        f"{[p.name for p in written]}")
    if len(written) != 1:
        raise AssertionError("the training run across val_freq wrote no validation image")
    return out


def profile_chunk(runner) -> None:
    """Kernel launches and device-busy share of one validation chunk
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from neuraludf_tpu_torch.train import schedules

    rays = validation_chunk(runner)
    run = lambda: runner.image_rows(runner.render_chunk(
        *rays, VAL_IDX, pixel_blending=True,
        cos_anneal=schedules.cos_anneal_ratio(runner.iter_step, runner.cfg.train))).cpu()
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    if busy == 0:
        log("[profile] the profiler saw no device time in a chunk: not measured")
        return
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[profile] one validation chunk (4,096 rays): {launches} kernel launches, device busy "
        f"{busy:.2f} ms of {wall_ms:.2f} ms wall (busy share {busy / wall_ms:.2f}, under the "
        f"profiler); largest: " + "; ".join(
            f"{e.self_device_time_total / 1e3:.2f} ms {e.key[:40]}" for e in top))


def texels_read(images, gx, gy) -> int:
    """Distinct texels of each view that the bilinear corners of these
    positions touch (clamped and NaN positions as K3 takes them): the image
    bytes K3 must read are these, not the whole views."""
    v, _, h, w = images.shape
    x = torch.nan_to_num(gx, nan=0.0).clamp(0.0, w - 1.0).floor().long()
    y = torch.nan_to_num(gy, nan=0.0).clamp(0.0, h - 1.0).floor().long()
    base = (torch.arange(v, device=gx.device) * (h * w)).view(v, 1, 1)
    hit = torch.zeros(v * h * w, dtype=torch.bool, device=gx.device)
    for dx in (0, 1):
        for dy in (0, 1):
            hit[(base + (y + dy).clamp(max=h - 1) * w + (x + dx).clamp(max=w - 1)).view(-1)] = True
    return int(hit.sum())


def time_strip_sample(k3in, card):
    """CUDA-event times of K3, its plain version and the library call, and
    the bytes and operations K3 must move and do on these inputs."""
    from neuraludf_tpu_torch.ops import strip_sample as ss

    images, gx, gy = k3in["images"], k3in["gx"], k3in["gy"]
    n = gx.numel()
    texels = texels_read(images, gx, gy)
    # the texels touched, 3 channels each; gx, gy; colours, mask
    nbytes = texels * images.shape[1] * 4 + 2 * n * 4 + 3 * n * 4 + n
    flops = K3_FLOPS_PER_POSITION * n
    with torch.no_grad():
        times = {"K3": cuda_ms(lambda: ss.strip_sample(images, gx, gy)),
                 "K3plain": cuda_ms(lambda: ss.strip_sample_plain(images, gx, gy), 3),
                 "K3library": cuda_ms(lambda: library_sample(images, gx, gy))}
    log(f"[time] K3 kernel {times['K3']:.3f} ms  plain {times['K3plain']:.3f} ms  library "
        f"(F.grid_sample) {times['K3library']:.3f} ms  bound "
        f"{bound_ms(nbytes, flops, 'highest'):.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP f32) at {n} positions, {texels} texels of "
        f"{images.shape[0] * images.shape[2] * images.shape[3]} read  [{card}]")
    return times, nbytes, flops


def call_launches(kin) -> dict:
    """CUDA launches of one K1 and one K2 call at each tier on the inputs
    of ``kin`` (torch.profiler). Taken before any other profiler session of
    the run: later sessions, after the graph captures and the profiles of
    the steps, counted 0 launches for most calls."""
    from neuraludf_tpu_torch.ops import fused_distance as fd

    x, wflat, bflat, lay = kin["x"], kin["wflat"], kin["bflat"], kin["lay"]
    cot = (kin["ubar"], kin["fbar"], kin["gbar"])
    with torch.no_grad():
        out = {(k, tier): cuda_launches(lambda: call(tier)) for tier in TIERS
               for k, call in (("K1", lambda t: fd.fused_forward(x, wflat, bflat, lay, t)),
                               ("K2", lambda t: fd.fused_backward(x, wflat, bflat, lay, t, *cot)))}
    log(f"[kernels] CUDA launches a call: {({f'{k} {t}': n for (k, t), n in out.items()})}")
    return out


def time_kernels(ucfg, kin, card, launches: dict, backward: bool = True):
    """CUDA-event times of K1, K2 (K1 alone without ``backward``) and their
    explicit plain versions, every tier, at the points of ``kin``; with the
    work each must do at each tier, and the CUDA launches a call of
    ``launches`` (call_launches)."""
    from neuraludf_tpu_torch.ops import fused_distance as fd

    x, wflat, bflat, lay = kin["x"], kin["wflat"], kin["bflat"], kin["lay"]
    ub, fb, gb = kin["ubar"], kin["fbar"], kin["gbar"]
    n = x.shape[0]
    flops = {tier: kernel_flops(ucfg, n, tier) for tier in TIERS}
    n_w = kin["n_weights"] * 4  # the true (unpadded) weights and biases
    nbytes = {"K1": x.numel() * 4 + n_w + n * (ucfg.d_out + 3) * 4,
              "K2": (x.numel() + ub.numel() + fb.numel() + gb.numel()) * 4 + n_w
              + x.numel() * 4 + n_w}
    calls = {"K1": lambda tier: fd.fused_forward(x, wflat, bflat, lay, tier),
             "K2": lambda tier: fd.fused_backward(x, wflat, bflat, lay, tier, ub, fb, gb)}
    plain = {"K1": lambda tier: fd.explicit_forward(x, wflat, bflat, lay, tier),
             "K2": lambda tier: fd.explicit_backward(x, wflat, bflat, lay, tier, ub, fb, gb)}
    names = ("K1", "K2") if backward else ("K1",)
    times = {}
    with torch.no_grad():
        for tier in TIERS:
            for k in names:
                times[(k, tier)] = cuda_ms(lambda: calls[k](tier))
                times[(k + "plain", tier)] = cuda_ms(lambda: plain[k](tier), 3)
    for tier in TIERS:
        for k in names:
            bound = bound_ms(nbytes[k], flops[tier][k], tier)
            times[(k + "launches", tier)] = launches[(k, tier)]
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            calls[k](tier)
            torch.cuda.synchronize()
            mem = (torch.cuda.max_memory_allocated() - held) / 2**20
            log(f"[time] {k} {tier:8s} at N={n} (route {fd.route_for(lay, tier)}): kernel "
                f"{times[(k, tier)]:.3f} ms  plain "
                f"{times[(k + 'plain', tier)]:.3f} ms  bound {bound:.4f} ms "
                f"({100 * bound / times[(k, tier)]:.1f}% of it reached; "
                f"{flops[tier][k] / 1e9:.1f} GFLOP, {nbytes[k] / 1e6:.1f} MB)  "
                f"{times[(k + 'launches', tier)]} CUDA launches, {mem:.0f} MiB of outputs and "
                f"scratch a call  [{card}]")
            if tier == "highest":
                route = fd.highest_route(lay)
                rb = route_bound_ms(nbytes[k], flops[tier][k], route)
                log(f"[time] {k} highest  route {route}: bound {rb:.4f} ms at "
                    f"{ROUTE_PEAK[route][0]} pass(es) of {ROUTE_PEAK[route][1] / 1e12:.0f} "
                    f"TFLOP/s ({100 * rb / times[(k, tier)]:.1f}% of it reached) beside the f32 "
                    f"CUDA-core bound {bound:.4f} ms  [{card}]")
    return times, nbytes, flops


def cuda_launches(fn) -> int:
    """Device kernels and memsets one call of fn enqueues (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def bound_ms(nbytes: float, flops: float, tier: str) -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[tier]) * 1e3


def route_bound_ms(nbytes: float, flops: float, route: str) -> float:
    """The bound of a tier-"highest" route: its passes of the f32 work at
    its peak, or the bytes."""
    passes, peak = ROUTE_PEAK[route]
    return max(nbytes / PEAK_BYTES, passes * flops / peak) * 1e3


def steady_body(runner):
    """The eager step body and schedule values of the runner's current
    iteration."""
    s = runner._schedules_at(runner.iter_step)
    return runner.step_body(s), dataclasses.asdict(s)


def profile_step(runner, n_steps: int = 5, top: int = 14) -> dict:
    """Device time by kernel over a few steady eager steps (torch.profiler),
    and the share of them the device was busy. Returns kernel name -> (ms
    per step, launches per step)."""
    from torch.profiler import ProfilerActivity, profile

    body, sched = steady_body(runner)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for i in range(n_steps):
            body(runner.params, runner.opt_state, runner.dataset.scene, i, sched,
                 runner.generator)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # kernels only: the operator rows repeat the device time of their kernels
    rows = sorted(((e.self_device_time_total / 1e3 / n_steps, e.count / n_steps, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("[profile] the profiler saw no device time: not measured")
        return {}
    log(f"[profile] {runner.cfg.general.expname} per step: {sum(r[1] for r in rows):.0f} "
        f"kernel launches, device busy "
        f"{busy:.2f} ms of {wall_ms / n_steps:.2f} ms wall (idle share "
        f"{1 - busy * n_steps / wall_ms:.2f}, under the profiler)")
    # the top rows, and the port's own kernels wherever they rank
    own = ("sweep_kernel", "wgrad_kernel", "pack_bf16_kernel", "reduce_kernel", "gemm_kernel",
           "colsum_kernel", "pe_kernel", "ss_kernel")
    for rank, (ms, count, key) in enumerate(rows):
        if rank < top or key.startswith(own) or key.startswith(tuple("void " + o for o in own)):
            log(f"  {ms:8.3f} ms  x{count:<6.0f} {key[:90]}")
    return {key: (ms, count) for ms, count, key in rows}


def profile_difference(base: dict, other: dict, top: int = 10) -> None:
    """The kernels whose device time per step differs most between two
    profiles: what the finetune step adds to the stage-1 step."""
    if not base or not other:
        return
    diff = sorted(((other.get(k, (0.0, 0))[0] - base.get(k, (0.0, 0))[0],
                    other.get(k, (0.0, 0))[1] - base.get(k, (0.0, 0))[1], k)
                   for k in set(base) | set(other)), reverse=True)
    log(f"[profile] finetune step minus stage-1 step: "
        f"{sum(d[0] for d in diff):+.2f} ms, {sum(d[1] for d in diff):+.0f} launches; largest:")
    for ms, count, key in diff[:top]:
        log(f"  {ms:+8.3f} ms  x{count:<+6.0f} {key[:90]}")


def scan_views(i: int, n_img: int, steps: int) -> torch.Tensor:
    """Scan i's views of its first ``steps`` iterations (the multi-scan
    runner's stream, np.random.RandomState(i))."""
    import numpy as np

    rng = np.random.RandomState(i)
    perm, out = rng.permutation(n_img), []
    for step in range(steps):
        out.append(int(perm[step % n_img]))
        if (step + 1) % n_img == 0:
            perm = rng.permutation(n_img)
    return torch.tensor(out)


def jsonl_rows(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def same_state(a, b) -> bool:
    """Parameters, optimizer state and generator of two runners, bit for bit."""
    from neuraludf_tpu_torch.train.optim import leaves

    trees = ((a.params, b.params), (a.opt_state, b.opt_state))
    return (all(torch.equal(x.detach(), y.detach()) for ta, tb in trees
                for (_, x), (_, y) in zip(leaves(ta), leaves(tb)))
            and torch.equal(a.generator.get_state(), b.generator.get_state()))


def multi_scan_run(cfg, scene_dir, out_dir, n_scans, dev, counters, on_path, *, seed,
                   is_finetune=False, ckpt=None):
    """[multi_scan] main path: MultiScanRunner.train of n_scans scans of the
    sphere for MS_STEPS iterations (resumed from ``ckpt`` for a finetune),
    launch counts set to 0 just before and read just after (S launches of
    each kernel of ``on_path`` an iteration); then each scan against a
    single-scan Runner(seed + i) through its graphed window on scan i's
    views: metric rows, parameters, optimizer and generator state bit for
    bit."""
    import shutil

    from neuraludf_tpu_torch.parallel.multi_scan import MultiScanRunner
    from neuraludf_tpu_torch.train import schedules
    from neuraludf_tpu_torch.train.runner import Runner
    from neuraludf_tpu_torch.train.step import METRIC_KEYS

    cases = [f"scan{i}" for i in range(n_scans)]
    if ckpt is not None:  # every scan resumes from the stage-1 checkpoint
        for case in cases:
            (out_dir / case / "checkpoints").mkdir(parents=True, exist_ok=True)
            shutil.copy(ckpt, out_dir / case / "checkpoints")
    ms = MultiScanRunner(cfg, [str(scene_dir)] * n_scans, cases, out_dir=str(out_dir), seed=seed,
                         is_continue=ckpt is not None, is_finetune=is_finetune, device=dev)
    first = ms.iter_step
    for k in counters.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    ms.train()
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = {name: k.launches for name, k in counters.items()}
    n_steps = ms.iter_step - first
    log(f"[multi_scan] {n_scans} scans x {n_steps} iterations ({cfg.general.expname}) in "
        f"{train_s:.1f} s; launches {launches}")
    if any(n != (n_scans * n_steps if name in on_path else 0) for name, n in launches.items()):
        raise AssertionError(f"[multi_scan] kernels {on_path} did not run once a scan and "
                             f"iteration: {launches}, {n_scans} x {n_steps}")
    equal = []
    for i, scan in enumerate(ms.scans):
        rows = jsonl_rows(Path(scan.base_exp_dir) / "logs" / "metrics.jsonl")[-n_steps:]
        if not all(math.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"[multi_scan] scan {i}: a non-finite metric")
        single = Runner(dataclasses.replace(cfg, general=dataclasses.replace(
            cfg.general, base_exp_dir=str(out_dir / f"single{i}"))), device=dev, seed=seed + i,
            is_finetune=is_finetune, dataset=scan.dataset)
        if ckpt is not None:
            single.load_checkpoint(ckpt)
        scheds = [single._schedules_at(single.iter_step + j) for j in range(n_steps)]
        window_fn = single._get_window_fn(schedules.is_blending(scheds[0]), n_steps)
        got = window_fn(single.params, single.opt_state, single.dataset.scene,
                        scan_views(i, scan.dataset.n_images, n_steps).to(dev), single.generator,
                        torch.from_numpy(schedules.schedule_rows(scheds)).to(dev)).cpu()
        want = [{"iter": first + 1 + j, **dict(zip(METRIC_KEYS, got[j].tolist()))}
                for j in range(n_steps)]
        equal.append(rows == want and same_state(scan, single))
        del single, window_fn
    log(f"[multi_scan] each scan against its single-scan graphed run, bit for bit: {equal}")
    if not all(equal):
        raise AssertionError(f"[multi_scan] a scan differs from its single-scan run: {equal}")
    losses = [jsonl_rows(Path(s.base_exp_dir) / "logs" / "metrics.jsonl")[-1]["loss"]
              for s in ms.scans]
    del ms
    torch.cuda.empty_cache()
    return {"scans": n_scans, "steps": n_steps, "seconds": train_s, "launches": launches,
            "bit_equal": equal, "last_losses": losses}


def device_cover(prof) -> tuple:
    """(summed kernel time, time covered by at least one kernel) in ms over
    a profile's device kernels: branches that overlap count once in the
    second."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total = sum(b - a for a, b in spans)
    cover, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            cover += b - max(a, end)
            end = b
    return total / 1e3, cover / 1e3


def time_multi_scan(cfg, ckpt, scene, dev, card, single_ms) -> dict:
    """Timed multi-scan windows at MS_SWEEP scans, every scan from the
    stage-1 checkpoint with a generator of its own seed: a window of
    TIMED_STEPS iterations, whose first call (warm-up and capture) gives the
    graph pool's memory, then TIMED_REPEATS timed calls ended by a
    synchronize (ms a multi-scan iteration, scan-steps/s, against S x the
    single graphed step ``single_ms``); then, that window freed, a window of
    PROFILE_STEPS under the profiler: the summed kernel time and the time
    covered by a kernel against the host clock. The profiler stretches
    concurrent branches, so the profiled iteration is slower than the timed
    one; S x the kernel time of one scan (the profile at S = 1) over the
    timed iteration reads the overlap of the timed run itself."""
    from torch.profiler import ProfilerActivity, profile

    from neuraludf_tpu_torch import convert
    from neuraludf_tpu_torch.parallel.multi_scan import MultiScanWindow
    from neuraludf_tpu_torch.render.renderer import UDFRenderer
    from neuraludf_tpu_torch.train import schedules
    from neuraludf_tpu_torch.train.step import build_step_body

    c = cfg.color_loss
    sched = schedules.compute_step_schedules(
        N_WINDOWS * 50, cfg.train, c.color_base_weight, c.color_weight, c.color_pixel_weight,
        c.color_patch_weight, is_finetune=False, reg_weights_schedule=False, same_lr=False,
        beta_trainable=True, variance_trainable=True)
    body = build_step_body(cfg, UDFRenderer(cfg.model))
    out = {}
    for S in MS_SWEEP:
        t_start = time.time()
        states = [convert.load_checkpoint(ckpt, dev) for _ in range(S)]
        gens = [torch.Generator(device=dev).manual_seed(100 + i) for i in range(S)]

        def window_call(steps: int):
            window = MultiScanWindow(cfg, body, steps, 1, S)
            rows = torch.from_numpy(schedules.schedule_rows([sched] * (steps * S))).reshape(
                steps, S, -1).to(dev)
            idxs = (torch.arange(steps * S, device=dev) % 16).reshape(steps, S)
            return lambda: window([st["params"] for st in states],
                                  [st["opt_state"] for st in states], [scene] * S, idxs, gens,
                                  rows)

        call = window_call(TIMED_STEPS)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        call()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pool_gib = (torch.cuda.memory_reserved() - reserved) / 2**30
        ts = []
        for _ in range(TIMED_REPEATS):
            torch.cuda.synchronize()
            t0 = time.time()
            call()
            torch.cuda.synchronize()
            ts.append((time.time() - t0) / TIMED_STEPS * 1e3)
        del call
        torch.cuda.empty_cache()
        call = window_call(PROFILE_STEPS)
        call()  # warm-up and capture
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            call()
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3 / PROFILE_STEPS
        summed, busy = (t / PROFILE_STEPS for t in device_cover(prof))
        if not summed:
            raise AssertionError(f"[multi_scan] S={S}: the profiler saw no kernel")
        med = sorted(ts)[len(ts) // 2]
        # S scans' kernel time, each at its time alone, over the timed iteration
        overlap = S * out[1]["kernel_ms_summed"] / med if 1 in out else summed / med
        out[S] = {"median_ms": med, "min_ms": min(ts), "max_ms": max(ts), "ms": ts,
                  "scan_steps_per_s": S / med * 1e3, "vs_single_graphed": med / (S * single_ms),
                  "alone_kernel_ms_over_timed": overlap, "profiled_wall_ms": wall,
                  "kernel_ms_summed": summed, "covered_ms": busy, "covered_share": busy / wall,
                  "graph_pool_gib": pool_gib}
        log(f"[multi_scan] S={S}: median {med:.2f} ms an iteration (min {min(ts):.2f}, max "
            f"{max(ts):.2f}), {S / med * 1e3:.1f} scan-steps/s, {med / (S * single_ms):.3f} of S "
            f"x the single graphed step ({S * single_ms:.2f} ms); S x one scan's kernel time "
            f"over it {overlap:.3f}; under the profiler kernels {summed:.2f} ms summed, covered "
            f"{busy:.2f} of {wall:.2f} ms; graph pool {pool_gib:.2f} GiB "
            f"({time.time() - t_start:.0f} s)  [{card}]")
        del call, states, gens
        torch.cuda.empty_cache()
    return out


def check_multi_scan(cfg, ft_cfg, ckpt, scene_dir, exp_dir, dev, counters, card, single_ms):
    """[multi_scan]: the stage-1 and finetune multi-scan runs against their
    single-scan runs, then the timed sweep."""
    from neuraludf_tpu_torch.data.dataset import Dataset

    out = {"stage1": multi_scan_run(dataclasses.replace(cfg, train=dataclasses.replace(
               cfg.train, end_iter=MS_STEPS, save_freq=MS_STEPS, report_freq=MS_STEPS)),
               scene_dir, exp_dir / "multi_scan", MS_SCANS, dev, counters, ("K1", "K2"), seed=0),
           "finetune": multi_scan_run(dataclasses.replace(ft_cfg, train=dataclasses.replace(
               ft_cfg.train, end_iter=MS_STEPS, save_freq=MS_STEPS, report_freq=MS_STEPS)),
               scene_dir, exp_dir / "multi_scan_ft", MS_FT_SCANS, dev, counters,
               ("K1", "K2", "K3"), seed=1, is_finetune=True, ckpt=ckpt)}
    out["sweep"] = time_multi_scan(cfg, ckpt, Dataset(cfg.dataset, dev).scene, dev, card,
                                   single_ms)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_dp(cfg, ckpt, dev, counters, card, exp_dir) -> dict:
    """[dp]: a process group of one card over NCCL; DP_STEPS steps of the
    ray-parallel window (its capture holding the all-gathers of the per-ray
    outputs and the all-reduce) from the
    stage-1 checkpoint against the single-scan graphed window from the same
    state: metric rows, parameters and generator bit for bit, K1 = K2 =
    DP_STEPS launches; the collective kernels inside the replayed graph
    (torch.profiler); then both windows timed in turns."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from neuraludf_tpu_torch.parallel.sharding import build_parallel_train_window
    from neuraludf_tpu_torch.train.runner import Runner

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        cfg = dataclasses.replace(cfg, general=dataclasses.replace(
            cfg.general, base_exp_dir=str(exp_dir / "dp")))
        dp_runner, single = (Runner(cfg, device=dev, seed=0) for _ in range(2))
        for r in (dp_runner, single):
            r.load_checkpoint(ckpt)
        dp_window = build_parallel_train_window(cfg, dp_runner.renderer, window=DP_STEPS)
        scheds, rows, idxs = window_inputs(single, DP_STEPS)
        for k in counters.values():
            k.launches = 0
        got = dp_window(dp_runner.params, dp_runner.opt_state, dp_runner.dataset.scene, idxs,
                        dp_runner.generator, rows)
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in counters.items()}
        want = graphed_steps(single, scheds, rows, idxs)
        equal = {"rows": torch.equal(got, want), "state": same_state(dp_runner, single)}
        log(f"[dp] world 1 over NCCL: {DP_STEPS} graphed ray-parallel steps, launches "
            f"{launches}; against the single-scan graphed window bit for bit: {equal}")
        if not all(equal.values()):
            from neuraludf_tpu_torch.train.step import METRIC_KEYS

            cols = {METRIC_KEYS[j]: float((got[:, j] - want[:, j]).abs().max())
                    for j in range(got.shape[1]) if not torch.equal(got[:, j], want[:, j])}
            raise AssertionError(f"[dp] the ray-parallel window differs from the single: {equal}; "
                                 f"largest differences by metric {cols}")
        if launches != {"K1": DP_STEPS, "K2": DP_STEPS, "K3": 0}:
            raise AssertionError(f"[dp] launches {launches}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dp_window(dp_runner.params, dp_runner.opt_state, dp_runner.dataset.scene, idxs,
                      dp_runner.generator, rows)
            torch.cuda.synchronize()
        # NCCL may gather and reduce over one rank without a kernel: a count
        nccl = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "nccl" in e.key.lower())
        log(f"[dp] collective kernels in {DP_STEPS} replays: {nccl}")
        times = {"dp": [], "single": []}
        for _ in range(TIMED_REPEATS):
            for name, r, fn in (("dp", dp_runner, dp_window),
                                ("single", single, single._get_window_fn(False, DP_STEPS))):
                torch.cuda.synchronize()
                t0 = time.time()
                fn(r.params, r.opt_state, r.dataset.scene, idxs, r.generator, rows)
                torch.cuda.synchronize()
                times[name].append((time.time() - t0) / DP_STEPS * 1e3)
        med = {name: sorted(ts)[len(ts) // 2] for name, ts in times.items()}
        log(f"[dp] step: ray-parallel (world 1) median {med['dp']:.2f} ms, single "
            f"{med['single']:.2f} ms ({TIMED_REPEATS} x {DP_STEPS} steps)  [{card}]")
        del dp_window  # its graph holds the collectives: before the group goes
        return {"launches": launches, "bit_equal": equal, "collective_kernels": nccl,
                "times_ms": times, "median_ms": med}
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()


def grid_udf(runner) -> torch.Tensor:
    """The runner's distance field on the GARMENT_MESH_RES³ grid over
    [-1, 1]³ that the extraction fills, flat, on the card."""
    from neuraludf_tpu_torch.mesh.grid import fill_on_device

    return fill_on_device(runner.params["udf"], runner.cfg.model.udf_network, [-1] * 3, [1] * 3,
                          GARMENT_MESH_RES)


def check_garment(dtu_cfg, ckpt, dev, counters, card) -> dict:
    """[garment]: the DeepFashion3D recipe at full width through
    scripts/torch_benchmark_garment.py's functions (scene, configurations,
    score): K1/K2 at "default" on the garment step's N_GARMENT_POINTS rows
    against both plain versions; GARMENT_STEPS graphed stage-1 steps and
    GARMENT_FT_STEPS finetune steps, K1 = K2 = one a step and K3 never (the
    garment finetune blends no pixels or patches), finite and falling
    losses; each stage's geometry moved by a grid voxel; the graphed
    garment step against the DTU stage-1 step (``dtu_cfg`` from ``ckpt``)
    in turns, with its kernels and busy share a replay; the extraction at
    GARMENT_MESH_RES of both fields, each with faces, and the DF3D score of
    the finetuned one."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_benchmark_garment as garment

    from neuraludf_tpu_torch.mesh.ply import load_ply
    from neuraludf_tpu_torch.train.runner import Runner

    out = {}
    scene_dir = BUILD / "smoke_scene" / "garment"
    exp_dir = BUILD / "smoke_exp" / "garment"
    out["scene_s"] = garment.build_scene(str(scene_dir), GARMENT_VIEWS, GARMENT_H, GARMENT_W)
    log(f"[garment] scene: {GARMENT_VIEWS} views {GARMENT_W}x{GARMENT_H} in "
        f"{out['scene_s']:.1f} s")
    cfg = garment.stage1_config(str(exp_dir), str(scene_dir), iters=GARMENT_STEPS)
    r, u = cfg.model.udf_renderer, cfg.model.udf_network
    widths = (cfg.train.batch_size, r.n_samples, r.n_importance, r.n_outside, r.upsampling_type,
              u.n_layers, u.d_hidden, u.fused_precision)
    log(f"[garment] recipe: batch, samples, importance, outside, up-sampling, udf layers, "
        f"width, tier = {widths}; fix_geo_end {cfg.train.fix_geo_end}")
    if (widths != (512, 64, 80, 0, "mix", 8, 256, "default")
            or cfg.train.batch_size * (r.n_samples + r.n_importance) != N_GARMENT_POINTS
            or not cfg.train.fix_geo_end < GARMENT_STEPS):
        raise AssertionError(f"[garment] not the garment recipe's widths, or stage 1 ends "
                             f"before its geometry trains: {widths}")

    log(f"[kernels] K1/K2 at N={N_GARMENT_POINTS} (a garment step's rows) at 'default'")
    errors, _ = check_kernels(u, dev, N_GARMENT_POINTS, tiers=("default",))
    out["kernel_errors"] = {f"{k}/{ref}/{o}": v for (k, _, ref, o), v in errors.items()}

    runner = Runner(cfg, seed=0, reg_weights_schedule=True, device=dev)
    grids = {"init": grid_udf(runner)}
    out["launches"] = {"stage1": train_main_path(runner, cfg, exp_dir, counters,
                                                 ("K1", "K2"))[0]}
    stage1_ckpt = runner.save_checkpoint()
    grids["stage1"] = grid_udf(runner)
    ft_cfg = garment.finetune_config(cfg, GARMENT_FT_STEPS)
    ft_runner = Runner(ft_cfg, seed=0, is_finetune=True, reg_weights_schedule=False, device=dev)
    ft_runner.load_checkpoint(stage1_ckpt)
    log(f"[garment] finetune from {Path(stage1_ckpt).name}: lr {ft_cfg.train.learning_rate} "
        f"both groups (same_lr {ft_cfg.train.same_lr}), pixel/patch weights "
        f"{ft_cfg.color_loss.color_pixel_weight}/{ft_cfg.color_loss.color_patch_weight}")
    out["launches"]["finetune"] = train_main_path(ft_runner, ft_cfg, exp_dir, counters,
                                                  ("K1", "K2"))[0]
    log(f"[garment] K3 launches in the finetune: {out['launches']['finetune']['K3']} (its "
        f"pixel and patch weights are 0: no blending step)")
    grids["finetune"] = grid_udf(ft_runner)
    voxel = 2.0 / (GARMENT_MESH_RES - 1)
    out["grid"] = {"voxel": voxel,
                   "min_udf": {k: float(g.min()) for k, g in grids.items()},
                   "moved": {"stage1": float((grids["stage1"] - grids["init"]).abs().max()),
                             "finetune": float((grids["finetune"] - grids["stage1"]).abs().max())}}
    del grids
    log(f"[garment] the field on the {GARMENT_MESH_RES}³ grid: min udf {out['grid']['min_udf']}; "
        f"largest move {out['grid']['moved']} (a voxel is {voxel:.4f})")
    if not min(out["grid"]["moved"].values()) > voxel:
        raise AssertionError(f"[garment] a stage's geometry did not train: {out['grid']}")

    # the garment step against the DTU stage-1 step, each graphed, in turns
    timed_cfg = dataclasses.replace(cfg, general=dataclasses.replace(
        cfg.general, base_exp_dir=str(exp_dir / "timed")))
    g_runner = Runner(timed_cfg, seed=0, reg_weights_schedule=True, device=dev)
    g_runner.load_checkpoint(stage1_ckpt)
    d_runner = Runner(dtu_cfg, seed=0, device=dev)
    d_runner.load_checkpoint(ckpt)
    times = time_in_turns({"garment stage-1 step": g_runner, "DTU stage-1 step": d_runner},
                          "garment", card)
    out["times"] = {"garment": times["garment stage-1 step"], "dtu": times["DTU stage-1 step"]}
    for k in counters.values():
        k.launches = 0
    out["profile"] = profile_window(g_runner, card)
    out["launches_per_replay"] = {n: k.launches / TIMED_STEPS for n, k in counters.items()}
    log(f"[garment] launches a replayed step: {out['launches_per_replay']}")
    if out["launches_per_replay"] != {"K1": 1.0, "K2": 1.0, "K3": 0.0}:
        raise AssertionError(f"[garment] K1/K2 not once a replayed step: "
                             f"{out['launches_per_replay']}")
    del g_runner, d_runner
    torch.cuda.empty_cache()

    stage1_faces = len(load_ply(runner.extract_udf_mesh(
        world_space=False, resolution=GARMENT_MESH_RES, dist_threshold_ratio=5.0))[1])
    t0 = time.time()
    timings = {}
    raw_ply = ft_runner.extract_udf_mesh(world_space=False, resolution=GARMENT_MESH_RES,
                                         dist_threshold_ratio=5.0, timings=timings)
    out["extract_s"] = time.time() - t0
    faces = load_ply(raw_ply)[1]
    log(f"[garment] faces at {GARMENT_MESH_RES}³: stage-1 field {stage1_faces}, finetuned "
        f"field {len(faces)}")
    if stage1_faces == 0 or len(faces) == 0:
        raise AssertionError("[garment] the extraction found no surface in a trained field")
    t0 = time.time()
    score, score_vhull = garment.score(raw_ply, str(scene_dir), None)
    out["score_s"] = time.time() - t0
    out["mesh"] = {"resolution": GARMENT_MESH_RES, "faces": int(len(faces)),
                   "stage1_field_faces": stage1_faces,
                   "stages_s": timings, "chamfer": score.chamfer, "fscore_1": score.fscore_1,
                   "fscore_2": score.fscore_2,
                   "chamfer_vhull": score_vhull.chamfer if score_vhull else None}
    log(f"[garment] extract_udf_mesh at {GARMENT_MESH_RES}³: {len(faces)} faces in "
        f"{out['extract_s']:.1f} s; DF3D score in {out['score_s']:.1f} s: Chamfer "
        f"{score.chamfer:.5f} (after the visual hull "
        f"{out['mesh']['chamfer_vhull']}), F@0.001 {score.fscore_1:.4f}, F@0.002 "
        f"{score.fscore_2:.4f} (the {GARMENT_STEPS} + {GARMENT_FT_STEPS}-step field; no bound)")
    if not math.isfinite(score.chamfer):
        raise AssertionError("[garment] the Chamfer distance is not finite")
    return out


def check_bmvs(dev, counters, card) -> dict:
    """[bmvs]: every JPEG of the committed BlendedMVS-layout scene decoded
    by ``data/jpeg.read_jpeg`` to the array its manifest hashes (what
    ``cv2.imread`` decodes), timed; then ``Dataset(dataset_name="bmvs")`` on
    the card and one graphed window of BMVS_STEPS stage-1 steps at the DTU
    widths, K1 = K2 = one a step."""
    from neuraludf_tpu_torch import config as config_mod
    from neuraludf_tpu_torch.data.jpeg import read_jpeg
    from neuraludf_tpu_torch.train.runner import Runner

    manifest = json.loads((BMVS_DIR / "manifest.json").read_text())
    decoded, seconds, wrong = {}, {}, []
    for rel, ref in manifest["files"].items():
        t0 = time.time()
        decoded[rel] = read_jpeg(str(BMVS_DIR / rel))
        seconds[rel] = time.time() - t0
        if (list(decoded[rel].shape) != ref["shape"]
                or hashlib.sha256(decoded[rel].tobytes()).hexdigest() != ref["sha256"]):
            wrong.append(rel)
    if wrong:
        raise AssertionError(f"[bmvs] decoded arrays differ from cv2.imread's: "
                             f"{source_differences(manifest, decoded, wrong)}")
    per_image = sorted(t for rel, t in seconds.items() if rel.startswith("blended_images"))
    per_mask = sorted(t for rel, t in seconds.items() if rel.startswith("masks"))
    out = {"files": len(seconds), "decode_s_image_median": per_image[len(per_image) // 2],
           "decode_s_image": per_image, "decode_s_mask_median": per_mask[len(per_mask) // 2]}
    log(f"[bmvs] {len(seconds)} JPEGs ({list(decoded['blended_images/000.jpg'].shape)}) "
        f"decoded to their "
        f"manifest's cv2.imread hashes; read_jpeg on the host: median "
        f"{out['decode_s_image_median']:.3f} s an image (min {per_image[0]:.3f}, max "
        f"{per_image[-1]:.3f}), {out['decode_s_mask_median']:.3f} s a mask")

    exp_dir = BUILD / "smoke_exp" / "bmvs"
    cfg = config_mod.load(str(CONF), case="bmvs_sphere", dataset__data_dir=str(BMVS_DIR),
                          dataset__dataset_name="bmvs", general__base_exp_dir=str(exp_dir),
                          train__end_iter=BMVS_STEPS)
    t0 = time.time()
    runner = Runner(cfg, seed=0, device=dev)
    out["load_s"] = time.time() - t0
    images = runner.dataset.scene["images"]
    first = torch.from_numpy(decoded["blended_images/000.jpg"] / 256.0).float()
    if images.device.type != "cuda" or not torch.equal(images[0].cpu(), first):
        raise AssertionError("[bmvs] the dataset's first image is not the decoded JPEG / 256 "
                             "on the card")
    log(f"[bmvs] Dataset(dataset_name='bmvs'): {runner.dataset.n_images} views "
        f"{tuple(images.shape[1:3])} on {images.device} in {out['load_s']:.1f} s")
    out["launches"], _ = train_main_path(runner, cfg, exp_dir, counters, ("K1", "K2"))
    del runner
    torch.cuda.empty_cache()
    return out


def source_differences(manifest, decoded, wrong) -> dict:
    """For each wrongly decoded file: the max level difference of the
    port's array and of cv2's (the manifest's) to the pixels the sphere
    generator rendered, which the encoder was given."""
    import numpy as np

    from neuraludf_tpu_torch.data.png import read_png
    from neuraludf_tpu_torch.data.synthetic import generate_scene

    src = BUILD / "smoke_scene" / "bmvs_source"
    generate_scene(str(src), **manifest["scene"])
    out = {}
    for rel in wrong:
        sub = "image" if rel.startswith("blended_images") else "mask"
        source = read_png(str(src / sub / Path(rel).with_suffix(".png").name)).astype(np.int64)
        port = decoded[rel].astype(np.int64)
        out[rel] = {"shape": list(port.shape),
                    "port_max_level_diff_to_source": int(np.abs(port - source).max())
                    if port.shape == source.shape else None,
                    "cv2_max_level_diff_to_source":
                        manifest["files"][rel]["source_max_level_diff"]}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    if not (ROOT / "neuraludf_tpu_torch").is_dir() or not CONF.is_file() or not FT_CONF.is_file():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 references stay true f32
    torch.backends.cudnn.allow_tf32 = False

    from neuraludf_tpu_torch import config as config_mod
    from neuraludf_tpu_torch.data.synthetic import generate_scene
    from neuraludf_tpu_torch.mesh import build as mesh_build
    from neuraludf_tpu_torch.ops import build
    from neuraludf_tpu_torch.ops import fused_distance as fd
    from neuraludf_tpu_torch.ops import strip_sample as ss
    from neuraludf_tpu_torch.train.runner import Runner

    dev = torch.device("cuda:0")
    card = card_line()
    log(f"[card] {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc processes
        engine = pool.submit(mesh_build.ensure_built)
        built = build.compile_sources(["fused_distance", "strip_sample"])  # in parallel
        engine = engine.result()
    fd.library(), ss.library()
    log(f"[build] {', '.join(f'{n}.cu -> {p.name}' for n, p in built.items())}, "
        f"mesh/csrc -> {engine.name} in {time.time() - t0:.1f} s")

    scene_dir = BUILD / "smoke_scene" / "sphere"
    exp_dir = BUILD / "smoke_exp"
    common = dict(case="sphere", dataset__data_dir=str(scene_dir),
                  general__base_exp_dir=str(exp_dir))
    n_stage1 = 50 * N_WINDOWS
    cfg = config_mod.load(str(CONF), train__end_iter=n_stage1, train__save_freq=n_stage1,
                          **common)
    ft_cfg = config_mod.load(str(FT_CONF), train__end_iter=FT_STEPS, **FT_SCHEDULE, **common)
    ucfg, rcfg = cfg.model.udf_network, ft_cfg.model.udf_renderer
    log(f"[config] udf net {ucfg.n_layers}x{ucfg.d_hidden}, skip {ucfg.skip_in}, "
        f"fused_precision={ucfg.fused_precision}, batch {cfg.train.batch_size}; finetune: "
        f"h_patch_size {rcfg.h_patch_size}, blend_top_k {rcfg.blend_top_k}, blend_chunk "
        f"{rcfg.blend_chunk}, warp_sampler {rcfg.warp_sampler}, pixel/patch weights "
        f"{ft_cfg.color_loss.color_pixel_weight}/{ft_cfg.color_loss.color_patch_weight}")
    if ft_cfg.model.udf_network != ucfg or ft_cfg.model.nerf != cfg.model.nerf:
        raise AssertionError("the two configurations differ in their networks")

    t0 = time.time()
    log(f"[kernels] K1/K2 at N={N_POINTS} against the plain versions")
    errors, kin = check_kernels(ucfg, dev)
    launches_a_call = call_launches(kin)
    for head in sorted(set(fd.HEADS) - {ucfg.udf_type}):  # the heads the main path does not run
        log(f"[kernels] K1/K2 with the '{head}' head at N={N_OTHER_HEADS}")
        check_kernels(dataclasses.replace(ucfg, udf_type=head), dev, N_OTHER_HEADS)
    for n in N_RAGGED:
        log(f"[kernels] K1/K2 at N={n}: a partly empty row tile")
        check_kernels(ucfg, dev, n)
    log(f"[kernels] tier 'high' on shallow nets at N={N_POINTS}: {list(HIGH_ROUNDING_NETS)}")
    high_rounding = check_high_rounding(ucfg, dev)
    refused = check_refused_net(ucfg, dev)
    log(f"[kernels] ok in {time.time() - t0:.1f} s; K2's outputs bit-equal over two calls")

    t0 = time.time()
    if not (scene_dir / "cameras.npz").is_file():
        generate_scene(str(scene_dir), kind="sphere", n_views=16, H=600, W=800)
    log(f"[scene] sphere, 16 views 600x800 in {time.time() - t0:.1f} s")

    runner = Runner(cfg, device=dev, seed=0)
    log(f"[data] {runner.dataset.n_images} views {runner.dataset.H}x{runner.dataset.W} loaded")

    t0 = time.time()
    log(f"[kernels] K3 at {K3_SHAPE} positions against the plain version and F.grid_sample")
    k3_errors, k3in = check_strip_sample(runner.dataset.scene, dev)
    log(f"[kernels] K3 ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    check_small_step(cfg, runner.dataset, dev)
    check_small_blending_step(ft_cfg, runner.dataset, dev)
    log(f"[step-parity] ok in {time.time() - t0:.1f} s")

    # the two main paths; every kernel's count is set to 0 before each
    counters = {"K1": fd.fused_forward, "K2": fd.fused_backward, "K3": ss.strip_sample}
    launches_stage1, _ = train_main_path(runner, cfg, exp_dir, counters, ("K1", "K2"))
    ckpt = runner._latest_checkpoint()
    if ckpt is None:
        raise AssertionError("the stage-1 run saved no checkpoint")

    ft_runner = Runner(ft_cfg, device=dev, seed=1, is_finetune=True)
    ft_runner.load_checkpoint(ckpt)
    if ft_runner.iter_step != 0:
        raise AssertionError("the finetune did not restart the schedule clock")
    log(f"[finetune] loaded {Path(ckpt).name} of the stage-1 run")
    launches_ft, ft_rows = train_main_path(ft_runner, ft_cfg, exp_dir, counters,
                                           ("K1", "K2", "K3"))
    check_finetune_rows(ft_rows)

    # the graph-replayed window against the eager loop, from the stage-1
    # checkpoint, in an experiment directory of its own
    t0 = time.time()
    window_common = dict(common, general__base_exp_dir=str(exp_dir / "window"))
    window = {
        "stage1": check_window(config_mod.load(str(CONF), **window_common), ckpt, dev, counters,
                               ("K1", "K2"), card, seed=0, is_finetune=False),
        "finetune": check_window(config_mod.load(str(FT_CONF), train__end_iter=FT_STEPS,
                                                 **FT_SCHEDULE, **window_common),
                                 ckpt, dev, counters, ("K1", "K2", "K3"), card, seed=1,
                                 is_finetune=True)}
    torch.cuda.empty_cache()
    print(json.dumps({"window": window, "card": card}), flush=True)
    log(f"[window] ok in {time.time() - t0:.1f} s")

    # tiers "high" and "highest" on both training paths: one window each
    # from the stage-1 checkpoint, each through its own route
    launches_tier = {tier: train_tier(tier, ckpt, common, exp_dir, n_stage1, dev, counters)
                     for tier in ("high", "highest")}
    step_times = time_graphed_tiers(ckpt, common, exp_dir, dev, card)
    print(json.dumps({"graphed_stage1_step_by_tier": step_times, "card": card}), flush=True)

    t0 = time.time()
    log(f"[mesh] on the stage-1 field ({runner.iter_step} steps)")
    check_mesh(runner, card)
    log(f"[mesh] ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    log(f"[validate] on the stage-1 field ({runner.iter_step} steps)")
    val = check_validate(runner, cfg, exp_dir, counters, card)
    log(f"[validate] ok in {time.time() - t0:.1f} s")

    # the training windows' graph pools go before the multi-scan graphs
    runner._window_fns, ft_runner._window_fns = {}, {}
    torch.cuda.empty_cache()
    t0 = time.time()
    log(f"[multi_scan] {MS_SCANS} stage-1 scans, {MS_FT_SCANS} finetune scans, the sweep over "
        f"{MS_SWEEP} scans")
    multi = check_multi_scan(cfg, ft_cfg, ckpt, scene_dir, exp_dir, dev, counters, card,
                             window["stage1"]["times"]["graphed"]["median_ms"])
    log(f"[multi_scan] ok in {time.time() - t0:.1f} s")
    t0 = time.time()
    dp = check_dp(config_mod.load(str(CONF), **common), ckpt, dev, counters, card, exp_dir)
    log(f"[dp] ok in {time.time() - t0:.1f} s")
    print(json.dumps({"multi_scan": multi, "dp": dp, "card": card}), flush=True)

    t0 = time.time()
    log(f"[garment] the DeepFashion3D recipe: {GARMENT_STEPS} stage-1 and {GARMENT_FT_STEPS} "
        f"finetune steps on a {GARMENT_VIEWS}-view garment, timed, extracted, scored")
    garment = check_garment(config_mod.load(str(CONF), **dict(
        common, general__base_exp_dir=str(exp_dir / "garment_dtu"))), ckpt, dev, counters, card)
    log(f"[garment] ok in {time.time() - t0:.1f} s")
    t0 = time.time()
    bmvs = check_bmvs(dev, counters, card)
    log(f"[bmvs] ok in {time.time() - t0:.1f} s")
    print(json.dumps({"garment": garment, "bmvs": bmvs, "card": card}), flush=True)

    times, nbytes, flops = time_kernels(ucfg, kin, card, launches_a_call)
    k3_times, k3_bytes, k3_flops = time_strip_sample(k3in, card)
    k1_val_times, k1_val_bytes, k1_val_flops = time_kernels(ucfg, val["k1_inputs"], card,
                                                            launches_a_call, backward=False)
    k3_val_times, k3_val_bytes, k3_val_flops = time_strip_sample(val["k3_inputs"], card)
    # after cuda_launches: a profile taken before it cost that count its launches
    profile_chunk(runner)
    profile_difference(*(profile_step(r) for r in (runner, ft_runner)))

    tier = ucfg.fused_precision  # the main paths' tier
    by_path = lambda k: {"stage1": launches_stage1[k], "finetune": launches_ft[k],
                         "validate": val["launches"][k],
                         "validate_image": val["cli_launches"][k],
                         "multi_scan": (multi["stage1"]["launches"][k]
                                        + multi["finetune"]["launches"][k]),
                         "dp": dp["launches"][k],
                         "garment": garment["launches"]["stage1"][k],
                         "garment_ft": garment["launches"]["finetune"][k],
                         "bmvs": bmvs["launches"][k]}
    hroute = fd.highest_route(fd.layout_for(ucfg))
    high_route = fd.route_for(fd.layout_for(ucfg), "high")
    checked_k12 = [f"{N_POINTS} points ({ucfg.udf_type} head, every tier)",
                   f"{N_OTHER_HEADS} points (square and sdf heads)"] + [
                   f"{n} points (a partly empty tile)" for n in N_RAGGED] + [
                   f"{N_GARMENT_POINTS} points (a garment step, 'default')"]
    kernels = []
    for k, name, line in (("K1", "fused_distance_fwd", 226), ("K2", "fused_distance_bwd", 252)):
        outs = ("udf", "feat", "grad") if k == "K1" else ("xbar", "wbar", "bbar")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "neuraludf_tpu_torch/csrc/fused_distance.cu",
            "replaces": f"neuraludf_tpu/ops/fused_distance.py:{line}",
            "launches": sum(by_path(k).values()),
            "launches_by_path": by_path(k),
            "window_launches": {p: window[p]["launches"][k] for p in window},
            "checked_at": checked_k12 + ([f"{N_VAL_POINTS} points (a validation chunk, every "
                                          f"tier, forward)"] if k == "K1" else []),
            "max_abs_err": max(errors[(k, tier, "explicit", o)][0] for o in outs),
            "ms": times[(k, tier)], "plain_ms": times[(k + "plain", tier)],
            "cuda_launches_per_call": times[(k + "launches", tier)],
            "bound_ms": bound_ms(nbytes[k], flops[tier][k], tier),
            "bound_by": "operations" if flops[tier][k] / PEAK_FLOPS[tier] > nbytes[k] / PEAK_BYTES
            else "bytes",
            "library_ms": None,
            # the garment recipe's step: 512 rays x (64 + 80) samples, at "default"
            "garment_check": {
                "points": N_GARMENT_POINTS, "tier": "default",
                "max_abs_err": max(garment["kernel_errors"][f"{k}/explicit/{o}"][0] for o in outs),
                "max_rel_err": {ref: max(garment["kernel_errors"][f"{k}/{ref}/{o}"][1]
                                         for o in outs) for ref in ("explicit", "autograd")}},
            # tier "high" (bf16x3): its own windows of the two training paths
            "high_route": high_route,
            "high_launches_by_path": {p: launches_tier["high"][p][k] for p in ("stage1",
                                                                              "finetune")},
            "high_route_launches_by_path": {
                p: launches_tier["high"][p][f"{k}/{high_route}"] for p in ("stage1", "finetune")},
            "high_max_abs_err": max(errors[(k, "high", "explicit", o)][0] for o in outs),
            "high_max_rel_err_vs_highest": max(errors[(k, "high", "highest", o)][1] for o in outs),
            "high_rms_rel_err_one_hidden_layer": max(high_rounding["one hidden layer"][o][0]
                                                     for o in outs),
            "high_rms_rel_err_skip_net": max(high_rounding["skip net"][o][0] for o in outs),
            "high_ms": times[(k, "high")], "high_plain_ms": times[(k + "plain", "high")],
            "high_cuda_launches_per_call": times[(k + "launches", "high")],
            "high_bound_ms": bound_ms(nbytes[k], flops["high"][k], "high"),
            "high_share_of_bound": bound_ms(nbytes[k], flops["high"][k], "high")
            / times[(k, "high")],
            # tier "highest": the 3xTF32 sweeps on the main-path net, the f32
            # GEMMs on a net the sweeps refuse
            "highest_route": hroute,
            "highest_launches_by_path": {p: launches_tier["highest"][p][k]
                                         for p in ("stage1", "finetune")},
            "highest_route_launches_by_path": {
                p: launches_tier["highest"][p][f"{k}/{hroute}"] for p in ("stage1", "finetune")},
            "highest_max_abs_err": max(errors[(k, "highest", "explicit", o)][0] for o in outs),
            "highest_max_rel_err": max(errors[(k, "highest", r, o)][1] for o in outs
                                       for r in ("explicit", "autograd")),
            "highest_refused_net_max_rel_err": max(refused[(k, "highest", r, o)][1] for o in outs
                                                   for r in ("explicit", "autograd")),
            "highest_ms": times[(k, "highest")],
            "highest_plain_ms": times[(k + "plain", "highest")],
            "highest_cuda_launches_per_call": times[(k + "launches", "highest")],
            "highest_bound_ms": route_bound_ms(nbytes[k], flops["highest"][k], hroute),
            "highest_bound_f32_cores_ms": bound_ms(nbytes[k], flops["highest"][k], "highest"),
            "highest_share_of_bound": route_bound_ms(nbytes[k], flops["highest"][k], hroute)
            / times[(k, "highest")],
        })
    kernels[0]["validation_chunk"] = {
        "points": N_VAL_POINTS, "launches_per_chunk": 1,
        "max_abs_err": max(val["k1_errors"][("K1", tier, "explicit", o)][0]
                           for o in ("udf", "feat", "grad")),
        **{f"{t}_{key}": value for t in TIERS for key, value in (
            ("ms", k1_val_times[("K1", t)]), ("plain_ms", k1_val_times[("K1plain", t)]),
            ("bound_ms", bound_ms(k1_val_bytes["K1"], k1_val_flops[t]["K1"], t)))},
        "highest_route_bound_ms": route_bound_ms(k1_val_bytes["K1"],
                                                 k1_val_flops["highest"]["K1"], hroute)}
    kernels.append({
        "name": "strip_sample", "route": "cuda",
        "source": "neuraludf_tpu_torch/csrc/strip_sample.cu",
        "replaces": "neuraludf_tpu/ops/strip_sample.py:158",
        "launches": sum(by_path("K3").values()),
        "launches_by_path": by_path("K3"),
        "window_launches": {p: window[p]["launches"]["K3"] for p in window},
        "checked_at": [f"{list(K3_SHAPE)} seeded positions (finetune shape)",
                       f"{list(K3_VAL_SHAPE)} a validation chunk's positions"],
        "max_abs_err": k3_errors["plain"],
        "ms": k3_times["K3"], "plain_ms": k3_times["K3plain"],
        "bound_ms": bound_ms(k3_bytes, k3_flops, "highest"),
        "bound_by": "operations" if k3_flops / PEAK_FLOPS["highest"] > k3_bytes / PEAK_BYTES
        else "bytes",
        "library_ms": k3_times["K3library"],
        "validation_chunk": {
            "shape": list(K3_VAL_SHAPE), "launches_per_chunk": 1,
            "max_abs_err": val["k3_errors"]["plain"], "ms": k3_val_times["K3"],
            "plain_ms": k3_val_times["K3plain"], "library_ms": k3_val_times["K3library"],
            "bound_ms": bound_ms(k3_val_bytes, k3_val_flops, "highest")},
    })
    jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "neuraludf_tpu"))
    if jax_modules:
        raise AssertionError(f"the port imported JAX or the JAX package: {jax_modules[:5]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
