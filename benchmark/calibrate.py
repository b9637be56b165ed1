"""Readings that the limits of ``correct`` are set from, on the card.

    python benchmark/calibrate.py --workload <cell> [--seeds 1 2 ...] \
        [--control-seeds 1 2 3] [--fault <fault> --fault-seeds 1 2 3] \
        [--f32-port | --meshes | --regime [--own-init] [--from-zero]] [--out <file>]

For each seed, in one process (the scene is loaded once): the port's set-up
and first window as a run makes them, and the five numbers of
``harness.check`` against the plain reference (the lower readings). For
each control seed, the control: the plain reference with every network
product's operands in fp8 (e4m3 forward, e5m2 cotangents, each under a
per-tensor scale; the step below the configuration's bf16 operands), put in
the port's place and held to the f32 reference on the same inputs (the
upper readings). ``--fault`` plants one of ``harness.faults`` under the
timed path: ``half_batch`` (half of every batch left out, the loss's means
taken over the rest), ``unchanged`` (a step that leaves the state as it
was), ``k2_layer`` (K2 returns one layer's weight cotangents doubled) or,
in a campaign, ``crossed_scans`` (scan 1 reads scan 0's scene), and reads
it on ``--fault-seeds``. ``--f32-port`` is the witness: the port with
every product in f32 (the model's ``port_in_f32``), no sound run. One JSON
line a reading, with the worst leaves of each gap (for a look at what a reading comes
from) and the raw readings of both sides. In a campaign each number is the
worst scan's, ``worst_scan`` names it, ``scans`` holds every scan's
numbers, and the leaves and raw readings are lists, one a scan; its seeds
share the scans' loaded scenes (``shared_datasets``).
``--meshes`` reads a cell with a crossing (``"crossings"``) at its own
size instead: set-up, then the runner's own windows up to and through the
first one that runs the periodic actions, and the numbers of that crossing
(``check.crossing_numbers``: ``mesh_gap``, ``udf_mesh_gap``, ``image_gap``,
the lower readings); on each control seed the control's in the program's
place (``control_numbers``: the reference's grid and render in fp8, each
through the program's comparison; the upper readings) and the reference's
own grid in f32 (the classic mesh's interpolation floor); with ``--fault``
(``moved_mesh``, ``moved_udf_mesh``, ``altered_image``) the program's
numbers on ``--fault-seeds`` with the fault planted. Each line says whether
each side passes the cell's limits (``check.judge``).
``--regime`` looks at which field a crossing cell's training reaches one
window before its crossing (``regime``: the median and least distance, and
the shares of a 128^3 grid of the object's box within two grid steps of the
surface and under the classic mesh's threshold; a thin surface has small
shares, a field collapsed to a thick band large ones, a field lifted off
u = 0 none): the start's, the port's, and from the same start on draws from
the seed the plain reference's (f32, TF32 off); ``--own-init`` draws every weight from
the run's seed (no ``fixed_init_seed``), ``--from-zero`` starts at
iteration 0 (the port alone).
The benchmark's own runs run none of this.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import models  # noqa: E402
from harness import cells, check, images, meshes, session  # noqa: E402
from harness.faults import CONTROL, FAULTS  # noqa: E402


def plain(r):
    """A side's readings with its leaf paths joined, for JSON."""
    return {"losses": r["losses"], "terms": r.get("terms"),
            **{k: {"/".join(p): v for p, v in r[k].items()} for k in ("grads", "change")}}


@contextlib.contextmanager
def shared_datasets(loaded):
    """Inside, the campaign runner's scans take their scenes from ``loaded``
    (data directory and device -> the port's ``Dataset``), each loaded at
    its first use; a run loads them anew."""
    from neuraludf_tpu_torch.parallel import multi_scan

    original = multi_scan.Dataset

    def dataset(conf, device):
        key = (conf.data_dir, str(device))
        if key not in loaded:
            loaded[key] = original(conf, device)
        return loaded[key]

    multi_scan.Dataset = dataset
    try:
        yield
    finally:
        multi_scan.Dataset = original


def readings(cell, seeds, control_seeds, device, out, tag="program", extra=None):
    from neuraludf_tpu_torch.data.dataset import Dataset

    dataset, loaded = None, {}
    model = models.for_cell(cell)
    campaign = session.scans(cell.workload) > 1
    one = (lambda xs: xs) if campaign else (lambda xs: xs[0])
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="udfcal-") as exp_dir:
            if campaign:
                with shared_datasets(loaded):
                    setup = session.build(cell, seed, device, exp_dir, extra=extra)
            else:
                if dataset is None:
                    spec = session.scene_spec(cell.conf_path)
                    scene_dir, _ = session.scene.ensure_scene(spec)
                    cfg = session._load_cfg(cell.conf_path, exp_dir, str(scene_dir))
                    dataset = Dataset(cfg.dataset, device)
                setup = session.build(cell, seed, device, exp_dir, dataset=dataset, extra=extra)
            firsts, dirs, reference_s = setup.firsts, setup.scene_dirs, setup.reference_s
            ports = [session.program_side(f) for f in firsts]
            del setup
            session._free()
            with session.exact_f32():
                refs = [session.reference_side(cell, f, d, device, exp_dir)
                        for f, d in zip(firsts, dirs)]
                numbers, worst = check.compare_scans(ports, refs, model)
                line = {"workload": cell.name, "seed": seed, tag: numbers, "start_s": reference_s}
                if campaign:
                    line["worst_scan"] = worst
                    line["scans"] = {tag: [check.compare(p, r, model)
                                           for p, r in zip(ports, refs)]}
                line["worst_leaves"] = one([check.leaf_gaps(p, r) for p, r in zip(ports, refs)])
                line["raw"] = {tag: one([plain(p) for p in ports]),
                               "ref": one([plain(r) for r in refs])}
                if seed in control_seeds:
                    ctls = [session.reference_side(cell, f, d, device, exp_dir, rounding=CONTROL)
                            for f, d in zip(firsts, dirs)]
                    line["control"], ctl_worst = check.compare_scans(ctls, refs, model)
                    if campaign:
                        line["scans"]["control"] = [check.compare(c, r, model)
                                                    for c, r in zip(ctls, refs)]
                        line["control_worst_scan"] = ctl_worst
                    line["raw"]["control"] = one([plain(c) for c in ctls])
            print(json.dumps(line), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            session._free()


def control_numbers(model, cfg, event, scene_dir, device, seed):
    """The control of a crossing, in the program's place: the classic mesh
    of the reference's grid in the control's types (``meshes.control_gap``)
    and its render of the validation view in those types, cut to uint8 as
    the runner writes it, each through the program's comparison."""
    t, res = meshes.CLASSIC.search(event["meshes"]["classic"].name).groups()
    out = meshes.control_gap(model, cfg, event["state"][model.DISTANCE_NET], float(t), int(res),
                             device, CONTROL, seed)
    colour, pixel = images.reference(model, cfg, event, scene_dir, device)
    with model.rounded(*CONTROL):
        parts = [p for p in images.reference(model, cfg, event, scene_dir, device)
                 if p is not None]
    out.update(images.gap(np.concatenate([images.levels(p) for p in parts]), colour, pixel))
    return out


def mesh_readings(cell, seeds, control_seeds, device, out, tag="program"):
    """``--meshes`` (module docstring): one JSON line a seed, with whether
    each side's numbers pass the cell's limits (``check.judge``)."""
    model = models.for_cell(cell)
    limits = cell.workload["limits"]
    passes = lambda numbers: check.judge(numbers, {k: limits[k] for k in numbers if k in limits})
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="udfcal-") as exp_dir:
            setup = session.build(cell, seed, device, exp_dir)
            runner, periodic = setup.runner, setup.periodic
            for _ in range(8):  # windows up to and through the first that makes meshes
                if any("state" in e for e in periodic.events):
                    break
                session.train_windows(runner, 1)
            event = next((e for e in periodic.events if "state" in e), None)
            if event is None:
                raise ValueError(f"{cell.name}: no window of the first 8 made meshes")
            scene_dir = setup.scene_dir
            cfg = model.load_config(cell.conf_path, **session.overrides(exp_dir, str(scene_dir)))
            line = {"workload": cell.name, "seed": seed, "iter": event["iter"],
                    "periodic_s": event["seconds"], "image": event["image"][0].name}
            del setup, runner
            session._free()
            with session.exact_f32():
                line[tag] = check.crossing_numbers(model, cfg, event, scene_dir, device)
                line[f"{tag}_correct"] = passes(line[tag])
                if seed in control_seeds:
                    line["control"] = control_numbers(model, cfg, event, scene_dir, device, seed)
                    line["control_correct"] = passes(line["control"])
                    t, res = meshes.CLASSIC.search(event["meshes"]["classic"].name).groups()
                    line["f32_grid"] = meshes.control_gap(
                        model, cfg, event["state"][model.DISTANCE_NET], float(t), int(res),
                        device, None, seed)
            print(json.dumps(line), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            del periodic, event
            session._free()


THRESHOLD = 0.005  # the classic mesh's level (``Runner.validate_mesh``'s default)


def regime(model, cfg, params, device, res: int = 128):
    """The median and least distance over a res^3 grid of the object's box,
    and the shares of it within two grid steps of u = 0 and under the classic
    mesh's threshold (``THRESHOLD``) (``--regime``)."""
    axis = torch.linspace(-meshes.BOX, meshes.BOX, res, device=device)
    pts = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    with session.exact_f32():
        u = meshes.values(model, cfg, params, pts, device)
    step = 2 * meshes.BOX / (res - 1)
    return {"u_med": float(u.median()), "u_min": float(u.min()),
            "band_share": float((u < 2 * step).float().mean()),
            "thresh_share": float((u < THRESHOLD).float().mean())}


def reference_follow(cell, model, start, scene_dir, device, exp_dir, seed, first, k):
    """The plain reference's parameters after k stage-1 iterations from
    ``start`` at iteration ``first``, in f32 with TF32 off, on draws from the
    seed and in ``Runner.train``'s view order, with the runner's rule for
    beta's trainability."""
    cfg = model.load_config(cell.conf_path, **session.overrides(exp_dir, str(scene_dir)))
    idxs = session.image_indices(int(session.scene_spec(cell.conf_path)["views"]), first, k)
    flags = {f: start[f] for f in ("beta_trainable", "variance_trainable")}
    beta_flag = True
    with session.exact_f32():
        scene_t = model.load_scene(scene_dir, idxs, device)
        draws = model.make_draws(cfg, scene_t["images"].shape[:3], k,
                                 seed + session.SETUP_STREAM, device)
        params, opt = session._ref_state({**start, "opt": None}, device, model)
        body = model.step_body(cfg, blending=False)
        for w0 in range(0, k, session.WINDOW):
            n = min(session.WINDOW, k - w0)
            rows = torch.as_tensor(model.schedule_rows(
                cfg, first + w0, n, finetune=False,
                reg_weights_schedule=session.reg_weights(cell.workload), flags=flags),
                device=device)
            ms = [body(params, opt, scene_t, int(idxs[w0 + j]), rows[j], noise=draws[w0 + j])
                  for j in range(n)]
            for m in ms:
                var, beta = float(m["variance"]), float(m["beta"])
                if not math.isfinite(float(m["loss"])):
                    raise FloatingPointError("the reference's loss is not finite")
                if var < 2 * beta and var < 0.01 and beta_flag and flags["variance_trainable"]:
                    flags["beta_trainable"], beta_flag = True, False
    return params


def regime_readings(cell, seeds, device, out, own_init: bool, from_zero: bool):
    """``--regime`` (module docstring): one JSON line a seed."""
    wl = dict(cell.workload)
    if own_init:
        wl.pop("fixed_init_seed", None)
    if from_zero:
        wl["start_iter"] = 0
    cell = dataclasses.replace(cell, workload=wl)
    model = models.for_cell(cell)
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="udfcal-") as exp_dir:
            setup = session.build(cell, seed, device, exp_dir)
            runner, first = setup.runner, setup.first["start_iter"]
            cfg = model.load_config(cell.conf_path,
                                    **session.overrides(exp_dir, str(setup.scene_dir)))
            before = cfg.train.val_freq - session.WINDOW  # the window before the crossing
            line = {"workload": cell.name, "seed": seed, "own_init": own_init, "from": first,
                    "start": regime(model, cfg, setup.first["start"]["params"][model.DISTANCE_NET],
                                    device)}
            session.train_windows(runner, (before - runner.iter_step) // session.WINDOW)
            line.update(at=runner.iter_step,
                        program=regime(model, cfg, runner.params[model.DISTANCE_NET], device))
            start, scene_dir = setup.first["start"], setup.scene_dir
            del setup, runner
            session._free()
            if not from_zero:
                params = reference_follow(cell, model, start, scene_dir, device, exp_dir, seed,
                                          first, before - first)
                line["reference"] = regime(model, cfg, params[model.DISTANCE_NET], device)
                del params
            print(json.dumps(line), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            session._free()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=tuple(FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--f32-port", action="store_true",
                   help="the witness: the port with every product in f32 (not a sound run)")
    p.add_argument("--meshes", action="store_true",
                   help="the meshes' readings of a cell with a crossing")
    p.add_argument("--regime", action="store_true",
                   help="the field's regime one window before a crossing cell's crossing")
    p.add_argument("--own-init", action="store_true", help="with --regime: no fixed_init_seed")
    p.add_argument("--from-zero", action="store_true", help="with --regime: from iteration 0")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    model = models.for_cell(cell)
    dev = torch.device("cuda:0")
    if args.regime:
        regime_readings(cell, args.seeds, dev, args.out, args.own_init, args.from_zero)
        return 0
    if args.meshes:
        mesh_readings(cell, args.seeds, set(args.control_seeds), dev, args.out)
        if args.fault:
            FAULTS[args.fault](model)
            mesh_readings(cell, args.fault_seeds, set(), dev, args.out, tag=args.fault)
        return 0
    if args.f32_port:
        model.port_in_f32()
        readings(cell, args.seeds, set(args.control_seeds), dev, args.out, tag="f32_port",
                 extra=model.F32_OVERRIDES)
        return 0
    readings(cell, args.seeds, set(args.control_seeds), dev, args.out)
    if args.fault:
        FAULTS[args.fault](model)
        readings(cell, args.fault_seeds, set(), dev, args.out, tag=args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
