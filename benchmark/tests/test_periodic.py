"""A cell's start iteration (``"start_iter"``) and the runner's periodic
actions (``"crossings"``): the cell ``dtu.periodic`` loads from its files;
a start iteration moves the view order, the port's schedule rows and the
reference's rows alike; a tiny run from a start iteration on the CPU holds
exactly one crossing of ``val_freq`` in its measured window, none in
set-up, and is correct, and a run that crosses where its cell wants none
is not; the crossing's image and meshes are held to the reference, and an
answer altered there, or the control in the program's place, fails;
``periodic_s`` reads the crossing window's time less the others' median;
the profiled crossing of a traced run times each action."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import HERE, tiny_conf
from harness import cells, check, main, session

torch.set_num_threads(2)

LIMITS = {"loss_gap": 1e-4, "eikonal_gap": 1e-4, "grad_gap": 1e-4, "udf_grad_gap": 1e-4,
          "change_gap": 1e-3}
MESH_RES = 24  # the tiny run's meshes: the runner's own calls, at a resolution a CPU test holds
# at MESH_RES: mesh_gap sound 6.1e-4 .. 1.1e-3, the fp8 control 5.8e-3 .. 9.5e-3; udf_mesh_gap
# sound 2.3e-4 .. 8.0e-4, moved_udf_mesh 1.5e-2 .. 1.9e-2
TINY_MESH_LIMIT = 3e-3
TINY_IMAGE_LIMIT = 1.0  # levels: sound 0 (the port's CPU path is f32), control 2.2 .. 3.1
TINY_CROSSING = {"mesh_gap": TINY_MESH_LIMIT, "udf_mesh_gap": TINY_MESH_LIMIT,
                 "image_gap": TINY_IMAGE_LIMIT}


def test_the_periodic_cell_loads_from_its_files():
    bench = cells.load_benchmark()
    cell = cells.load_cell("dtu.periodic", bench)
    wl = cell.workload
    assert (session.start_iter(wl), session.crossings(wl), wl["stage"]) == (2300, 1, "stage1")
    actions = ("validate", "validate_mesh", "extract_udf_mesh")
    assert {m.name for m in cell.per_layer} == {
        "kernels_per_step", "device_idle_share", "step_mfu", "periodic_s", "periodic_busy_share",
        *(f"periodic_{kind}_s.{a}" for kind in ("host", "device") for a in actions)}
    assert {"mesh_gap", "udf_mesh_gap", "image_gap"} <= set(wl["limits"])
    entry = next(w for w in bench["workloads"] if w["name"] == "dtu.periodic")
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    from neuraludf_tpu_torch import config as port_config

    cfg = port_config.load(str(cell.conf_path))
    w = session.WINDOW
    # set-up: 2,300 .. 2,400; the measured window's second runner window ends at 2,500
    assert not session.periodic_hits(cfg, 2300 + w, w)
    assert not session.periodic_hits(cfg, 2300 + 2 * w, w)
    assert not session.periodic_hits(cfg, 2400 + w, w)
    assert session.periodic_hits(cfg, 2500, w) == ["val_freq", "val_mesh_freq"]
    assert not session.periodic_hits(cfg, 4950, w)  # the next is at 5,000


def test_every_other_cell_starts_at_iteration_0_and_crosses_nothing():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        if w["name"] != "dtu.periodic":
            wl = cells.load_cell(w["name"], bench).workload
            assert session.start_iter(wl) == 0 and session.crossings(wl) == 0


@pytest.fixture(scope="module")
def periodic_bench(tmp_path_factory):
    """The tiny cells with a start iteration: ``tiny.start30`` (the tiny
    stage 1 from iteration 30), ``tiny.periodic`` (val_freq 300, from
    iteration 100, one crossing wanted) and ``tiny.unwanted`` (the same,
    none wanted)."""
    from conftest import write_tiny_bench

    root = tmp_path_factory.mktemp("periodic")
    here = write_tiny_bench(root)
    (here / "configs" / "tinyv.conf").write_text(tiny_conf("tinyv", val=300))
    extra = {"tiny.start30": {"conf": "tiny.conf", "start_iter": 30},
             "tiny.periodic": {"conf": "tinyv.conf", "start_iter": 100, "crossings": 1,
                               "limits": {**LIMITS, **TINY_CROSSING}},
             "tiny.unwanted": {"conf": "tinyv.conf", "start_iter": 100}}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, wl in extra.items():
        (here / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": "tiny", "stage": "stage1", "limits": LIMITS, **wl}))
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": name.split(".", 1)[1], "chips": 1, "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return here


def test_a_start_iteration_moves_the_views_and_both_sides_rows(periodic_bench, tmp_path):
    from neuraludf_tpu_torch.train import schedules as port_sched

    cell = cells.load_cell("tiny.start30", here=periodic_bench)
    dev = torch.device("cpu")
    setup = session.build(cell, 2**31 + 41, dev, str(tmp_path), cache=tmp_path / "scenes")
    first, runner, model = setup.first, setup.runner, setup.model
    k = check.FOLLOW
    assert first["start_iter"] == 30 and runner.iter_step == 30 + session.WINDOW
    n_img = runner.dataset.n_images
    assert first["idxs"].tolist() == session.image_indices(n_img, 30, k).tolist()
    assert first["idxs"].tolist() != session.image_indices(n_img, 0, k).tolist()
    flags = {f: first["start"][f] for f in ("beta_trainable", "variance_trainable")}
    port_rows = lambda at: port_sched.schedule_rows([
        port_sched.compute_step_schedules(
            at + j, runner.cfg.train, *(getattr(runner.cfg.color_loss, c) for c in (
                "color_base_weight", "color_weight", "color_pixel_weight", "color_patch_weight")),
            is_finetune=False, reg_weights_schedule=False, same_lr=runner.cfg.train.same_lr,
            **flags) for j in range(k)])
    ref_cfg = model.load_config(cell.conf_path, **session.overrides(str(tmp_path), "."))
    ref_rows = lambda at: model.schedule_rows(ref_cfg, at, k, finetune=False,
                                              reg_weights_schedule=False, flags=flags)
    assert np.array_equal(np.asarray(port_rows(30)), np.asarray(ref_rows(30)))
    assert not np.array_equal(np.asarray(ref_rows(30)), np.asarray(ref_rows(0)))
    # the rows the first window ran are the reference's at 30, and the sides agree
    ref = session.reference_side(cell, first, setup.scene_dir, dev, str(tmp_path))
    numbers = check.compare(session.program_side(first), ref, model)
    assert set(numbers.values()) == {0.0}


def _small_meshes(monkeypatch):
    from neuraludf_tpu_torch.train.runner import Runner

    for name in ("validate_mesh", "extract_udf_mesh"):
        original = getattr(Runner, name)
        monkeypatch.setattr(Runner, name, lambda self, *a, _f=original, **kw:
                            _f(self, *a, **{**kw, "resolution": MESH_RES}))


def _run(periodic_bench, tmp_path, name, seconds=3.0):
    cell = cells.load_cell(name, here=periodic_bench)
    return main.measure(cell, 2**31 + 43, seconds, False, torch.device("cpu"), time.time(),
                        cache=tmp_path / "scenes")


def test_a_run_from_a_start_iteration_crosses_val_freq_once(periodic_bench, tmp_path,
                                                             monkeypatch, capsys):
    _small_meshes(monkeypatch)
    seen = {}
    load = cells.load_reader

    def spy(name, here=cells.HERE):
        reader = load(name, here)

        class Spy:
            @staticmethod
            def read(ctx):
                seen.update(ends=ctx.ends, crossed=ctx.crossed)
                return reader.read(ctx)

        return Spy

    monkeypatch.setattr(cells, "load_reader", spy)
    res = _run(periodic_bench, tmp_path, "tiny.periodic")
    err = capsys.readouterr().err
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert err.count("periodic actions at iteration") == 1
    assert "periodic actions at iteration 300: val_freq, val_mesh_freq" in err
    assert seen["crossed"][:2] == [False, True] and sum(seen["crossed"]) == 1
    times = np.diff([0.0] + seen["ends"])
    plain = np.median([t for t, c in zip(times, seen["crossed"]) if not c])
    got = cells.load_reader("periodic_s").read(SimpleNamespace(**seen))
    assert got == pytest.approx(times[1] - plain)
    # the image and the meshes were read back against the reference
    readings = res["readings"]
    assert readings["mesh_verts"] > 0 and readings["udf_mesh_verts"] > 0
    assert readings["mesh_res"] == MESH_RES and readings["image_pixels"] == 2 * 7 * 10
    for name, limit in TINY_CROSSING.items():
        assert 0.0 <= res["checks"][name]["value"] < limit


def test_a_crossing_the_cell_does_not_want_fails_it(periodic_bench, tmp_path, monkeypatch):
    _small_meshes(monkeypatch)
    res = _run(periodic_bench, tmp_path, "tiny.unwanted")
    assert not res["correct"] and res["failed"] == res["attempted"]
    assert "not 0" in " ".join(res["checks"]["failed_steps"]["why"])


@pytest.mark.parametrize("fault, number", [("moved_mesh", "mesh_gap"),
                                           ("moved_udf_mesh", "udf_mesh_gap"),
                                           ("altered_image", "image_gap")])
def test_an_answer_altered_at_the_crossing_is_caught(periodic_bench, tmp_path, monkeypatch,
                                                     fault, number):
    """An answer altered where it is produced: a mesh half a grid step off,
    the validation image 8 levels brighter."""
    import models
    from harness import faults

    _small_meshes(monkeypatch)
    faults.FAULTS[fault](models.load(models.DEFAULT), monkeypatch.setattr)
    res = _run(periodic_bench, tmp_path, "tiny.periodic")
    assert not res["correct"]
    assert res["checks"][number]["value"] > TINY_CROSSING[number]


def _crossed(periodic_bench, tmp_path, seed):
    """A tiny set-up trained through its first crossing: (setup, event,
    the reference's configuration)."""
    cell = cells.load_cell("tiny.periodic", here=periodic_bench)
    setup = session.build(cell, seed, torch.device("cpu"), str(tmp_path),
                          cache=tmp_path / "scenes")
    while not setup.periodic.events:
        session.train_windows(setup.runner, 1)
    cfg = setup.model.load_config(cell.conf_path, **session.overrides(str(tmp_path), "."))
    return setup, setup.periodic.events[0], cfg


def test_the_crossing_control_fails(periodic_bench, tmp_path, monkeypatch):
    """The control in the program's place: the reference's own grid in fp8
    at the meshes' resolution (its crossings of the threshold) and its
    render of the validation view in fp8, each through the program's
    comparison, fail the limits that the program and the reference's f32
    grid keep."""
    import calibrate
    from harness import meshes

    _small_meshes(monkeypatch)
    setup, event, cfg = _crossed(periodic_bench, tmp_path, 2**31 + 44)
    model, dev = setup.model, torch.device("cpu")
    program = check.crossing_numbers(model, cfg, event, setup.scene_dir, dev)
    t = float(meshes.CLASSIC.search(event["meshes"]["classic"].name).group(1))
    plain = meshes.control_gap(model, cfg, event["state"][model.DISTANCE_NET], t, MESH_RES, dev,
                               None, 1)
    control = calibrate.control_numbers(model, cfg, event, setup.scene_dir, dev, 1)
    assert check.judge(program, TINY_CROSSING) and plain["mesh_gap"] < TINY_MESH_LIMIT
    assert control["mesh_gap"] > TINY_MESH_LIMIT and control["image_gap"] > TINY_IMAGE_LIMIT
    assert not check.judge(control, {k: TINY_CROSSING[k] for k in control if k in TINY_CROSSING})


def test_the_profiled_crossing_times_each_action(periodic_bench, tmp_path, monkeypatch):
    """``profile_crossing`` runs the runner's periodic actions once more at
    the crossing's iteration, into a directory of its own, each action
    under a profiler, and leaves the runner as it was; on the CPU no device
    operation runs, so the device readers find nothing."""
    _small_meshes(monkeypatch)
    setup, event, _ = _crossed(periodic_bench, tmp_path, 2**31 + 45)
    runner = setup.runner
    it, where, n = runner.iter_step, runner.base_exp_dir, len(setup.periodic.events)
    out = main.profile_crossing(runner, event["iter"], str(tmp_path / "profiled"),
                                torch.device("cpu"))
    assert set(out) == {"validate", "validate_mesh", "extract_udf_mesh"}
    assert all(a["host_s"] > 0 and a["ops"] == 0 for a in out.values())
    assert (runner.iter_step, runner.base_exp_dir) == (it, where)
    assert not {"validate", "validate_mesh", "extract_udf_mesh"} & set(vars(runner))
    again = setup.periodic.events[n:]
    assert len(again) == 1 and again[0]["iter"] == event["iter"]
    assert again[0]["image"][0].parent.parent == tmp_path / "profiled"
    ctx = SimpleNamespace(crossing=out)
    for a in out:
        assert cells.load_reader(f"periodic_host_s.{a}").read(ctx) == out[a]["host_s"]
        assert cells.load_reader(f"periodic_device_s.{a}").read(ctx) is None
    assert cells.load_reader("periodic_busy_share").read(ctx) is None
    busy = {"validate": {"host_s": 2.0, "device_s": 1.0, "ops": 9},
            "extract_udf_mesh": {"host_s": 2.0, "device_s": 0.5, "ops": 3}}
    assert cells.load_reader("periodic_busy_share").read(
        SimpleNamespace(crossing=busy)) == pytest.approx(37.5)
    assert cells.load_reader("periodic_device_s.validate").read(
        SimpleNamespace(crossing=busy)) == 1.0


@pytest.mark.parametrize("ends, crossed, want", [
    ([1.0, 17.0, 18.0, 19.0, 20.5], [False, True, False, False, False], 15.0),
    ([1.0, 2.0, 3.0], [False, False, False], None),
    ([16.0], [True], None),
    ([1.0, 2.0, 18.0, 19.1], [False, False, True, False], 15.0)])
def test_periodic_s_is_the_crossing_less_the_median_window(ends, crossed, want):
    got = cells.load_reader("periodic_s", HERE).read(SimpleNamespace(ends=ends, crossed=crossed))
    assert got == pytest.approx(want) if want is not None else got is None


def test_fixed_init_seed_fixes_every_net():
    """``fixed_init_seed`` draws every network, the distance network's too,
    from its own seed in every run; a workload without the key draws every
    weight from the run's seed."""
    import models
    from reference import config as ref_config

    model = models.load(models.DEFAULT)
    cfg = ref_config.load(str(HERE / "configs" / "dtu.conf"))
    wl = {"fixed_init_seed": 7}
    a, b = (session.seeded_weights(model, cfg, wl, s, "cpu") for s in (2**31 + 1, 2**31 + 2))
    fixed = dict(check.flat_leaves(model.init_weights(cfg, 7, "cpu")))
    own = dict(check.flat_leaves(model.init_weights(cfg, 2**31 + 1, "cpu")))
    assert [p for p, _ in check.flat_leaves(a)] == list(own)
    for (path, t), (_, u) in zip(check.flat_leaves(a), check.flat_leaves(b)):
        assert torch.equal(t, u) and torch.equal(t, fixed[path])
    assert any(not torch.equal(fixed[p], own[p]) for p in own if p[0] == model.DISTANCE_NET)
    plain = session.seeded_weights(model, cfg, {}, 2**31 + 1, "cpu")
    assert all(torch.equal(t, own[p]) for p, t in check.flat_leaves(plain))
    assert cells.load_cell("dtu.periodic").workload["fixed_init_seed"] == 3100000002
