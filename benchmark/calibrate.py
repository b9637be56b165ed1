"""Readings that the limits of ``correct`` are set from, on the card.

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--fault <fault> --fault-seeds 1 2 3] \
        [--f32-port] [--out <file>]

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
it on ``--fault-seeds``. ``--f32-port`` is the witness: the
port with every product in f32, no sound run. One JSON line a reading,
with the worst leaves of each gap (for a look at what a reading comes
from) and the raw readings of both sides. In a campaign each number is the
worst scan's, ``worst_scan`` names it, ``scans`` holds every scan's
numbers, and the leaves and raw readings are lists, one a scan; its seeds
share the scans' loaded scenes (``shared_datasets``).
The benchmark's own runs run none of this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness import cells, check, session  # noqa: E402
from harness.faults import CONTROL, FAULTS  # noqa: E402


def plain(r):
    """A side's readings with its leaf paths joined, for JSON."""
    return {"losses": r["losses"], "terms": r.get("terms"),
            **{k: {"/".join(p): v for p, v in r[k].items()} for k in ("grads", "change")}}


def port_in_f32():
    """The witness: the port with every product in f32 (its networks'
    precision policy at ``highest``; the cell's fused tier is set by
    ``--f32-port`` through the configuration)."""
    from neuraludf_tpu_torch.nets import mlp

    for role in mlp.PRECISION_POLICY:
        mlp.PRECISION_POLICY[role] = "highest"


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
                numbers, worst = check.compare_scans(ports, refs)
                line = {"workload": cell.name, "seed": seed, tag: numbers, "start_s": reference_s}
                if campaign:
                    line["worst_scan"] = worst
                    line["scans"] = {tag: [check.compare(p, r) for p, r in zip(ports, refs)]}
                line["worst_leaves"] = one([check.leaf_gaps(p, r) for p, r in zip(ports, refs)])
                line["raw"] = {tag: one([plain(p) for p in ports]),
                               "ref": one([plain(r) for r in refs])}
                if seed in control_seeds:
                    ctls = [session.reference_side(cell, f, d, device, exp_dir, rounding=CONTROL)
                            for f, d in zip(firsts, dirs)]
                    line["control"], ctl_worst = check.compare_scans(ctls, refs)
                    if campaign:
                        line["scans"]["control"] = [check.compare(c, r)
                                                    for c, r in zip(ctls, refs)]
                        line["control_worst_scan"] = ctl_worst
                    line["raw"]["control"] = one([plain(c) for c in ctls])
            print(json.dumps(line), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            session._free()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=tuple(FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--f32-port", action="store_true",
                   help="the witness: the port with every product in f32 (not a sound run)")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    dev = torch.device("cuda:0")
    if args.f32_port:
        port_in_f32()
        readings(cell, args.seeds, set(args.control_seeds), dev, args.out, tag="f32_port",
                 extra={"model__udf_network__fused_precision": "highest"})
        return 0
    readings(cell, args.seeds, set(args.control_seeds), dev, args.out)
    if args.fault:
        FAULTS[args.fault]()
        readings(cell, args.fault_seeds, set(), dev, args.out, tag=args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
