#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build ``neuraludf_tpu_torch/csrc/fused_distance.cu`` and
   ``csrc/strip_sample.cu`` for sm_90a, both nvcc processes started together;
3. kernels K1 (fused distance forward) and K2 (its second-order backward)
   at the main path's width (58,368 points, the 8x256 net of
   ``confs/synthetic_smoke.conf``, its ``abs`` head), both tiers, against the
   explicit plain version and the autograd plain version, and K2 twice on
   the same inputs for bit-equal W̄ and b̄; then the same for the ``square``
   and ``sdf`` heads at 4,096 points, and for the ``abs`` head at 5,000
   points (not a multiple of the 128-row tile) and at 300 (one partly empty
   tile of K1);
4. the synthetic sphere scene (16 views, 600x800) with the port's generator;
5. one training loss and its gradients on a small batch through the kernels
   (tier "highest") against the plain autograd path;
6. the stage-1 main path: ``Runner.train`` on ``confs/synthetic_smoke.conf``
   at full width for a few windows, launch counts of K1 and K2 read around
   it; its last checkpoint is what the finetune starts from;
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
10. ``[mesh]`` on the stage-1 runner's field (its 200-step state): the
    MeshUDF grid at 64³ on the card against the same on the CPU; the CLI's
    closing extraction (``extract_udf_mesh`` at 512³, world space, distance
    threshold ratio 5) with the CUDA-event time and peak memory of the grid
    fill and the host-clock time of each stage; ``validate_mesh`` at 256³;
    an incremental extraction at 256³ against its full fill; the Chamfer
    distance of the 512³ mesh to the sphere's surface (a record, no bound);
11. CUDA-event times of K1, K2, K3, their plain versions and K3's library
    call; the host-clock time and the profile of a steady step of each path.

It prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. It imports
nothing of the JAX package. Build outputs (the CUDA kernels, the
marching-cubes engine), the scene and the meshes go under ``build/``.
"""

from __future__ import annotations

import dataclasses
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
N_TIMED_STEPS = 20
REPS = 10  # kernel launches per timing

# Published peaks of one H100 SXM (dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth.
PEAK_FLOPS = {"default": 989e12, "highest": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances, as max |kernel - reference| / max |reference| per output.
# "highest" against the explicit version: the same f32 arithmetic, summed in
# another order. "default" against the explicit version at the same tier:
# both round every matmul operand, and the sigma(100a) and q that the reverse
# sweep reads back, to bf16; but an activation that differs by an f32 ulp (the
# kernels use the fast exp, log and divide) may round to the neighbouring bf16
# value (2^-8 relative), and the second-order terms amplify that. Against the
# f32 autograd version, "default" carries bf16's whole error.
TOL = {
    ("highest", "explicit"): 1e-4,
    ("highest", "autograd"): 1e-4,
    ("default", "explicit"): 2e-2,
    ("default", "autograd"): 1e-1,
}
TOL_STEP = 1e-3  # small-batch loss and gradients, kernels ("highest") vs plain
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
# The mesh phase. The CLI's closing extraction is at 512³
# (--final_mesh_resolution); validate_mesh and the incremental check at the
# runner's default 256³; the card-against-CPU grid at 64³.
MESH_RES, MESH_CHECK_RES, MESH_PARITY_RES = 512, 256, 64
# Grid on the card against the CPU, both true f32 (TF32 off): udf absolute,
# normals absolute where both are nonzero, and the band (udf < 2 voxel) may
# differ only within 1e-6 of its edge.
TOL_GRID = {"udf": 1e-5, "normals": 1e-4, "band_edge": 1e-6}
# Chamfer of the 512³ mesh to 200,000 points of the sphere, unit scale: the
# mesh sampled every 0.002 (half a 512³ voxel), distances over 0.1 dropped,
# precision and recall at 0.005 and 0.01.
CHAMFER = {"downsample_density": 0.002, "max_dist": 0.1, "thresh1": 0.005, "thresh2": 0.01}


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


def kernel_flops(ucfg, n: int) -> dict:
    """Operations K1 and K2 must do over n points: 2 per multiply-add of
    their matrix products at the true (unpadded) widths.

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
    k1 = full + one_col
    k2 = full + tangent + one_col + full + full + one_col
    return {"K1": 2.0 * n * k1, "K2": 2.0 * n * k2}


def check_kernels(ucfg, dev, n_points: int = N_POINTS):
    """K1 and K2 against both plain versions, each tier, with the head of
    ucfg.udf_type; returns the errors and the inputs."""
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
    xg = x.clone().requires_grad_(True)
    wg = [w.detach().clone().requires_grad_(True) for w in ws]
    bg = [b.detach().clone().requires_grad_(True) for b in bs]
    ref_out = fd.plain_autograd(xg, wg, bg, ucfg)
    ref_grads = torch.autograd.grad(ref_out, [xg] + wg + bg, grad_outputs=(ubar, fbar, gbar))
    flat = lambda ts: torch.cat([t.reshape(-1) for t in ts])
    ref_bwd = (ref_grads[0], flat(ref_grads[1:1 + len(ws)]), flat(ref_grads[1 + len(ws):]))
    ref_out = tuple(t.detach() for t in ref_out)

    def true_layout(bwd):
        """(x̄, W̄, b̄) with the padding dropped: the padded columns' outputs
        are softplus100(0) != 0, so W̄'s padded rows hold values nobody reads."""
        ws_bar, bs_bar = fd.unpack(bwd[1], bwd[2], lay)
        return bwd[0], flat(ws_bar), flat(bs_bar)

    names_fwd, names_bwd = ("udf", "feat", "grad"), ("xbar", "wbar", "bbar")
    errors = {}
    for tier in ("highest", "default"):
        k_fwd = fd.fused_forward(x, wflat, bflat, lay, tier)
        torch.cuda.synchronize()
        raw_bwd = fd.fused_backward(x, wflat, bflat, lay, tier, ubar, fbar, gbar)
        torch.cuda.synchronize()
        again = fd.fused_backward(x, wflat, bflat, lay, tier, ubar, fbar, gbar)
        if not all(torch.equal(a, b) for a, b in zip(raw_bwd, again)):
            raise AssertionError(f"K2 ({tier}) is not bit-reproducible from run to run")
        k_bwd = true_layout(raw_bwd)
        with torch.no_grad():
            e_fwd = fd.explicit_forward(x, wflat, bflat, lay, tier)
            e_bwd = true_layout(fd.explicit_backward(x, wflat, bflat, lay, tier,
                                                     ubar, fbar, gbar))
        for ref_name, rf, rb in (("explicit", e_fwd, e_bwd), ("autograd", ref_out, ref_bwd)):
            tol = TOL[(tier, ref_name)]
            for kname, outs, refs, names in (("K1", k_fwd, rf, names_fwd),
                                              ("K2", k_bwd, rb, names_bwd)):
                for name, a, b in zip(names, outs, refs):
                    err, rel = rel_err(a, b)
                    errors[(kname, tier, ref_name, name)] = (err, rel)
                    log(f"  {kname} {lay.head:6s} {tier:8s} vs {ref_name:8s} {name:5s} "
                        f"max_abs_err={err:.3e} rel={rel:.3e} tol={tol:.0e}")
    bad = [(k, v) for k, v in errors.items() if v[1] > TOL[(k[1], k[2])]]
    if bad:
        raise AssertionError(f"kernel outputs outside tolerance: {bad}")
    inputs = dict(x=x, wflat=wflat, bflat=bflat, lay=lay, ubar=ubar, fbar=fbar, gbar=gbar,
                  n_weights=sum(t.numel() for t in ws + bs))
    return errors, inputs


def check_small_step(cfg, dataset, dev):
    """One loss and its gradients on a 64-ray batch: the kernels (tier
    'highest') against the plain autograd path, same params and draws."""
    from neuraludf_tpu_torch.render.renderer import UDFRenderer
    from neuraludf_tpu_torch.train import step as tstep
    from neuraludf_tpu_torch.train.runner import init_params

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=64))
    sched = {"cos_anneal_ratio": 0.5, "flip_saturation": 0.0, "color_base_weight": 0.01,
             "color_weight": 1.0, "color_pixel_weight": 0.0, "color_patch_weight": 0.0,
             "mask_weight": 0.0, "igr_ns_weight": 0.0, "sparse_weight": 0.0, "igr_weight": 0.1}
    from neuraludf_tpu_torch.ops import fused_distance as fd

    results = []
    launched = (fd.fused_forward.launches, fd.fused_backward.launches)
    for core, prec in (("on", "highest"), ("off", "highest")):
        ucfg = dataclasses.replace(cfg.model.udf_network, fused_core=core, fused_precision=prec)
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, udf_network=ucfg))
        params = init_params(torch.Generator().manual_seed(1), c, dev)
        loss_fn = tstep.build_loss_fn(c, UDFRenderer(c.model))
        gen = torch.Generator(device=dev).manual_seed(2)
        total, _ = loss_fn(params, dataset.scene, 3, sched, gen)
        grads = tstep.param_grads(total, params)
        results.append((total.detach(), grads))
        if core == "on" and (fd.fused_forward.launches - launched[0] != 1
                             or fd.fused_backward.launches - launched[1] != 1):
            raise AssertionError("fused_core='on' did not run K1 and K2 once each")
    (l_k, g_k), (l_p, g_p) = results
    err = abs(float(l_k) - float(l_p)) / abs(float(l_p))
    worst = max(rel_err(g_k[p], g_p[p])[1] for p in g_p if p[0] == "udf")
    log(f"  loss kernels={float(l_k):.6f} plain={float(l_p):.6f} rel={err:.2e}; "
        f"udf grads worst rel={worst:.2e} tol={TOL_STEP:.0e}")
    if not (err <= TOL_STEP and worst <= TOL_STEP):
        raise AssertionError("the kernels' training loss or gradients disagree with the plain path")


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
    """K3 against its plain version and the library call; returns the
    errors and the inputs."""
    from neuraludf_tpu_torch.ops import strip_sample as ss

    images, gx, gy = k3_inputs(scene, dev)
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
    if not 0.2 < share < 1.0:
        raise AssertionError(f"K3 check: in-image share {share}, both sides must be hit")
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
    verts_w, faces = load_ply(path)
    sm = runner.dataset.scale_mats_np[0]
    verts = ((verts_w - sm[:3, 3][None]) / sm[0, 0]).astype(np.float32)
    voxel = 2.0 / (MESH_RES - 1)
    if len(faces) == 0 or not np.isfinite(verts).all():
        raise AssertionError(f"the {MESH_RES}³ mesh is empty or has a non-finite vertex")
    residual = float(np.abs(grid.query_udf_at(runner.params, ucfg, verts)).mean())
    out["extract"] = {"verts": len(verts), "faces": len(faces), "total_s": total_s,
                      "peak_gib": peak, "mean_abs_udf": residual, **timings}
    log(f"[mesh] extract_udf_mesh {MESH_RES}³: {len(verts)} vertices, {len(faces)} faces in "
        f"{total_s:.1f} s (host clock: " + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items())
        + f"); peak device memory {peak:.2f} GiB; mean |udf| at the vertices {residual:.2e} "
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


def time_strip_sample(k3in, card):
    """CUDA-event times of K3, its plain version and the library call, and
    the bytes and operations K3 must move and do on these inputs."""
    from neuraludf_tpu_torch.ops import strip_sample as ss

    images, gx, gy = k3in["images"], k3in["gx"], k3in["gy"]
    n = gx.numel()
    nbytes = images.numel() * 4 + 2 * n * 4 + 3 * n * 4 + n  # images, gx, gy; colours, mask
    flops = K3_FLOPS_PER_POSITION * n
    with torch.no_grad():
        times = {"K3": cuda_ms(lambda: ss.strip_sample(images, gx, gy)),
                 "K3plain": cuda_ms(lambda: ss.strip_sample_plain(images, gx, gy), 3),
                 "K3library": cuda_ms(lambda: library_sample(images, gx, gy))}
    log(f"[time] K3 kernel {times['K3']:.3f} ms  plain {times['K3plain']:.3f} ms  library "
        f"(F.grid_sample) {times['K3library']:.3f} ms  bound "
        f"{bound_ms(nbytes, flops, 'highest'):.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP f32) at {n} positions  [{card}]")
    return times, nbytes, flops


def time_kernels(ucfg, kin, card):
    """CUDA-event times of K1, K2 and their explicit plain versions, both
    tiers, at the main path's shapes; with the work each must do."""
    from neuraludf_tpu_torch.ops import fused_distance as fd

    x, wflat, bflat, lay = kin["x"], kin["wflat"], kin["bflat"], kin["lay"]
    ub, fb, gb = kin["ubar"], kin["fbar"], kin["gbar"]
    flops = kernel_flops(ucfg, N_POINTS)
    n_w = kin["n_weights"] * 4  # the true (unpadded) weights and biases
    nbytes = {"K1": x.numel() * 4 + n_w + N_POINTS * (ucfg.d_out + 3) * 4,
              "K2": (x.numel() + ub.numel() + fb.numel() + gb.numel()) * 4 + n_w
              + x.numel() * 4 + n_w}
    times = {}
    with torch.no_grad():
        for tier in ("default", "highest"):
            times[("K1", tier)] = cuda_ms(lambda: fd.fused_forward(x, wflat, bflat, lay, tier))
            times[("K2", tier)] = cuda_ms(
                lambda: fd.fused_backward(x, wflat, bflat, lay, tier, ub, fb, gb))
            times[("K1plain", tier)] = cuda_ms(
                lambda: fd.explicit_forward(x, wflat, bflat, lay, tier), 3)
            times[("K2plain", tier)] = cuda_ms(
                lambda: fd.explicit_backward(x, wflat, bflat, lay, tier, ub, fb, gb), 3)
    calls = {"K1": lambda tier: fd.fused_forward(x, wflat, bflat, lay, tier),
             "K2": lambda tier: fd.fused_backward(x, wflat, bflat, lay, tier, ub, fb, gb)}
    for tier in ("default", "highest"):
        for k in ("K1", "K2"):
            bound = bound_ms(nbytes[k], flops[k], tier)
            times[(k + "launches", tier)] = cuda_launches(lambda: calls[k](tier))
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            calls[k](tier)
            torch.cuda.synchronize()
            mem = (torch.cuda.max_memory_allocated() - held) / 2**20
            log(f"[time] {k} {tier:8s} kernel {times[(k, tier)]:.3f} ms  plain "
                f"{times[(k + 'plain', tier)]:.3f} ms  bound {bound:.4f} ms "
                f"({100 * bound / times[(k, tier)]:.1f}% of it reached; "
                f"{flops[k] / 1e9:.1f} GFLOP, {nbytes[k] / 1e6:.1f} MB)  "
                f"{times[(k + 'launches', tier)]} CUDA launches, {mem:.0f} MiB of outputs and "
                f"scratch a call  [{card}]")
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


def steady_body(runner):
    """The step body and schedule values of the runner's current iteration."""
    s = runner._schedules_at(runner.iter_step)
    return runner.step_body(s), dataclasses.asdict(s)


def time_step(runner, card) -> float:
    """Host-clock time of a steady training step, ended by a synchronize."""
    body, sched = steady_body(runner)
    run = lambda i: body(runner.params, runner.opt_state, runner.dataset.scene,
                         i % runner.dataset.n_images, sched, runner.generator)
    run(0)
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(N_TIMED_STEPS):
        run(i)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / N_TIMED_STEPS * 1e3
    log(f"[time] {runner.cfg.general.expname}: steady training step {step_ms:.2f} ms = "
        f"{runner.cfg.train.batch_size / step_ms * 1e3:.0f} rays/s  [{card}]")
    return step_ms


def profile_step(runner, n_steps: int = 5, top: int = 14) -> dict:
    """Device time by kernel over a few steady steps (torch.profiler), and
    the share of the window the device was busy. Returns kernel name ->
    (ms per step, launches per step)."""
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
    for head in sorted(set(fd.HEADS) - {ucfg.udf_type}):  # the heads the main path does not run
        log(f"[kernels] K1/K2 with the '{head}' head at N={N_OTHER_HEADS}")
        check_kernels(dataclasses.replace(ucfg, udf_type=head), dev, N_OTHER_HEADS)
    for n in N_RAGGED:
        log(f"[kernels] K1/K2 at N={n}: a partly empty row tile")
        check_kernels(ucfg, dev, n)
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

    t0 = time.time()
    log(f"[mesh] on the stage-1 field ({runner.iter_step} steps)")
    check_mesh(runner, card)
    log(f"[mesh] ok in {time.time() - t0:.1f} s")

    times, nbytes, flops = time_kernels(ucfg, kin, card)
    k3_times, k3_bytes, k3_flops = time_strip_sample(k3in, card)
    profiles = []
    for r in (runner, ft_runner):
        time_step(r, card)
        profiles.append(profile_step(r))
    profile_difference(*profiles)
    torch.cuda.reset_peak_memory_stats()
    time_step(ft_runner, card)
    log(f"[memory] finetune step: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")

    tier = ucfg.fused_precision  # the main paths' tier
    kernels = []
    for k, name, line in (("K1", "fused_distance_fwd", 226), ("K2", "fused_distance_bwd", 252)):
        outs = ("udf", "feat", "grad") if k == "K1" else ("xbar", "wbar", "bbar")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "neuraludf_tpu_torch/csrc/fused_distance.cu",
            "replaces": f"neuraludf_tpu/ops/fused_distance.py:{line}",
            "launches": launches_stage1[k] + launches_ft[k],
            "launches_by_path": {"stage1": launches_stage1[k], "finetune": launches_ft[k]},
            "max_abs_err": max(errors[(k, tier, "explicit", o)][0] for o in outs),
            "ms": times[(k, tier)], "plain_ms": times[(k + "plain", tier)],
            "cuda_launches_per_call": times[(k + "launches", tier)],
            "bound_ms": bound_ms(nbytes[k], flops[k], tier),
            "bound_by": "operations" if flops[k] / PEAK_FLOPS[tier] > nbytes[k] / PEAK_BYTES
            else "bytes",
            "library_ms": None,
        })
    kernels.append({
        "name": "strip_sample", "route": "cuda",
        "source": "neuraludf_tpu_torch/csrc/strip_sample.cu",
        "replaces": "neuraludf_tpu/ops/strip_sample.py:158",
        "launches": launches_ft["K3"],
        "launches_by_path": {"stage1": 0, "finetune": launches_ft["K3"]},
        "max_abs_err": k3_errors["plain"],
        "ms": k3_times["K3"], "plain_ms": k3_times["K3plain"],
        "bound_ms": bound_ms(k3_bytes, k3_flops, "highest"),
        "bound_by": "operations" if k3_flops / PEAK_FLOPS["highest"] > k3_bytes / PEAK_BYTES
        else "bytes",
        "library_ms": k3_times["K3library"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
