#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build ``neuraludf_tpu_torch/csrc/fused_distance.cu`` for sm_90a;
3. kernels K1 (fused distance forward) and K2 (its second-order backward)
   at the main path's width (58,368 points, the 8x256 net of
   ``confs/synthetic_smoke.conf``, its ``abs`` head), both tiers, against the
   explicit plain version and the autograd plain version; then the same
   for the ``square`` and ``sdf`` heads at 4,096 points;
4. the synthetic sphere scene (16 views, 600x800) with the port's generator;
5. one training loss and its gradients on a small batch through the kernels
   (tier "highest") against the plain autograd path;
6. the main path: ``Runner.train`` on ``confs/synthetic_smoke.conf`` at full
   width for a few windows, launch counts of K1 and K2 read around it;
7. CUDA-event times of K1, K2 and their plain versions, and the host-clock
   time of a steady training step.

It prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. It imports
nothing of the JAX package. Build outputs and the scene go under ``build/``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"
CONF = ROOT / "confs" / "synthetic_smoke.conf"

N_POINTS = 512 * 114  # rays x (64 + 50 up-sampled) samples of one training step
N_OTHER_HEADS = 4096  # points for the heads the main path does not use
N_WINDOWS = 4  # training windows on the main path (50 iterations each)
N_TIMED_STEPS = 20
REPS = 10  # kernel launches per timing

# Published peaks of one H100 SXM (dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth.
PEAK_FLOPS = {"default": 989e12, "highest": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances, as max |kernel - reference| / max |reference| per output.
# "highest" against the explicit version: the same f32 arithmetic, summed in
# another order. "default" against the explicit version at the same tier:
# both round every matmul operand to bf16, but an activation that differs by
# an f32 ulp may round to the neighbouring bf16 value (2^-8 relative), and
# the second-order terms amplify that. Against the f32 autograd version,
# "default" carries bf16's whole error.
TOL = {
    ("highest", "explicit"): 1e-4,
    ("highest", "autograd"): 1e-4,
    ("default", "explicit"): 2e-2,
    ("default", "autograd"): 1e-1,
}
TOL_STEP = 1e-3  # small-batch loss and gradients, kernels ("highest") vs plain


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
        k_bwd = true_layout(fd.fused_backward(x, wflat, bflat, lay, tier, ubar, fbar, gbar))
        torch.cuda.synchronize()
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


def train_main_path(runner, cfg, exp_dir, fd):
    """Runner.train with the kernels' launch counts set to 0 just before and
    read just after; checks the loss and that K1/K2 ran in every step."""
    fd.fused_forward.launches = fd.fused_backward.launches = 0
    t0 = time.time()
    runner.train()
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = {"K1": fd.fused_forward.launches, "K2": fd.fused_backward.launches}
    n_steps = runner.iter_step
    log_path = exp_dir / cfg.general.expname / "logs" / "metrics.jsonl"
    losses = [json.loads(line)["loss"] for line in log_path.read_text().splitlines()][-n_steps:]
    means = [sum(losses[i:i + 50]) / 50 for i in range(0, n_steps, 50)]
    log(f"[train] {n_steps} steps in {train_s:.1f} s; launches {launches}; "
        f"window mean losses {['%.5f' % m for m in means]}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite training loss")
    if launches["K1"] != n_steps or launches["K2"] != n_steps:
        raise AssertionError(f"K1/K2 did not run once in every step: {launches}, {n_steps} steps")
    if not means[-1] <= means[0]:
        raise AssertionError(f"training loss did not decrease: window means {means}")
    return launches


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
    for tier in ("default", "highest"):
        for k in ("K1", "K2"):
            log(f"[time] {k} {tier:8s} kernel {times[(k, tier)]:.3f} ms  plain "
                f"{times[(k + 'plain', tier)]:.3f} ms  "
                f"bound {bound_ms(nbytes[k], flops[k], tier):.4f} ms "
                f"({flops[k] / 1e9:.1f} GFLOP, {nbytes[k] / 1e6:.1f} MB)  [{card}]")
    return times, nbytes, flops


def bound_ms(nbytes: float, flops: float, tier: str) -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[tier]) * 1e3


def time_step(runner, card) -> float:
    """Host-clock time of a steady training step, ended by a synchronize."""
    body, sched = runner.step_body(), dataclasses.asdict(runner._schedules_at(runner.iter_step))
    run = lambda i: body(runner.params, runner.opt_state, runner.dataset.scene,
                         i % runner.dataset.n_images, sched, runner.generator)
    run(0)
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(N_TIMED_STEPS):
        run(i)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / N_TIMED_STEPS * 1e3
    log(f"[time] steady training step {step_ms:.2f} ms = "
        f"{runner.cfg.train.batch_size / step_ms * 1e3:.0f} rays/s  [{card}]")
    return step_ms


def profile_step(runner, n_steps: int = 5, top: int = 14) -> None:
    """Device time by kernel over a few steady steps (torch.profiler), and
    the share of the window the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    body, sched = runner.step_body(), dataclasses.asdict(runner._schedules_at(runner.iter_step))
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
        return
    log(f"[profile] per step: {sum(r[1] for r in rows):.0f} kernel launches, device busy "
        f"{busy:.2f} ms of {wall_ms / n_steps:.2f} ms wall (idle share "
        f"{1 - busy * n_steps / wall_ms:.2f}, under the profiler)")
    for ms, count, key in rows[:top]:
        log(f"  {ms:8.3f} ms  x{count:<6.0f} {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    if not (ROOT / "neuraludf_tpu_torch").is_dir() or not CONF.is_file():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 references stay true f32
    torch.backends.cudnn.allow_tf32 = False

    from neuraludf_tpu_torch import config as config_mod
    from neuraludf_tpu_torch.data.synthetic import generate_scene
    from neuraludf_tpu_torch.ops import fused_distance as fd
    from neuraludf_tpu_torch.train.runner import Runner

    dev = torch.device("cuda:0")
    card = card_line()
    log(f"[card] {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.time()
    lib = fd.library()
    log(f"[build] fused_distance.cu -> {lib._name} in {time.time() - t0:.1f} s")

    scene_dir = BUILD / "smoke_scene" / "sphere"
    exp_dir = BUILD / "smoke_exp"
    cfg = config_mod.load(str(CONF), case="sphere", dataset__data_dir=str(scene_dir),
                          general__base_exp_dir=str(exp_dir),
                          train__end_iter=50 * N_WINDOWS)
    ucfg = cfg.model.udf_network
    log(f"[config] udf net {ucfg.n_layers}x{ucfg.d_hidden}, skip {ucfg.skip_in}, "
        f"fused_precision={ucfg.fused_precision}, batch {cfg.train.batch_size}")

    t0 = time.time()
    log(f"[kernels] K1/K2 at N={N_POINTS} against the plain versions")
    errors, kin = check_kernels(ucfg, dev)
    for head in sorted(set(fd.HEADS) - {ucfg.udf_type}):  # the heads the main path does not run
        log(f"[kernels] K1/K2 with the '{head}' head at N={N_OTHER_HEADS}")
        check_kernels(dataclasses.replace(ucfg, udf_type=head), dev, N_OTHER_HEADS)
    log(f"[kernels] ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    if not (scene_dir / "cameras.npz").is_file():
        generate_scene(str(scene_dir), kind="sphere", n_views=16, H=600, W=800)
    log(f"[scene] sphere, 16 views 600x800 in {time.time() - t0:.1f} s")

    runner = Runner(cfg, device=dev, seed=0)
    log(f"[data] {runner.dataset.n_images} views {runner.dataset.H}x{runner.dataset.W} loaded")

    t0 = time.time()
    check_small_step(cfg, runner.dataset, dev)
    log(f"[step-parity] ok in {time.time() - t0:.1f} s")

    launches = train_main_path(runner, cfg, exp_dir, fd)
    times, nbytes, flops = time_kernels(ucfg, kin, card)
    time_step(runner, card)
    profile_step(runner)

    tier = ucfg.fused_precision  # the main path's tier
    kernels = []
    for k, name, line in (("K1", "fused_distance_fwd", 226), ("K2", "fused_distance_bwd", 252)):
        outs = ("udf", "feat", "grad") if k == "K1" else ("xbar", "wbar", "bbar")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "neuraludf_tpu_torch/csrc/fused_distance.cu",
            "replaces": f"neuraludf_tpu/ops/fused_distance.py:{line}",
            "launches": launches[k],
            "max_abs_err": max(errors[(k, tier, "explicit", o)][0] for o in outs),
            "ms": times[(k, tier)], "plain_ms": times[(k + "plain", tier)],
            "bound_ms": bound_ms(nbytes[k], flops[k], tier),
            "bound_by": "operations" if flops[k] / PEAK_FLOPS[tier] > nbytes[k] / PEAK_BYTES
            else "bytes",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
