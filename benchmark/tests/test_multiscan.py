"""The campaign cell (``"scans": S`` in a workload file): its files load,
a tiny campaign of two scans runs on the CPU through the port's
``MultiScanRunner`` to a correct result with S rays a step for every scan,
each fault that a campaign can have fails it (scan 1 reading scan 0's
scene; a state left unchanged; half of every batch), and the one-scan
cells read what they read before: the view order of RandomState(0) and the
radius-0.5 scene's directory name."""

import time

import numpy as np
import pytest
import torch

import models
from harness import cells, faults, main, scene, session

torch.set_num_threads(2)

MULTI_LAYER = {"kernels_per_step", "device_idle_share", "step_mfu"}


def test_the_campaign_cell_loads_from_its_files():
    bench = cells.load_benchmark()
    cell = cells.load_cell("dtu.multiscan4", bench)
    wl = cell.workload
    assert session.scans(wl) == 4 and cell.config == "dtu" and wl["stage"] == "stage1"
    assert {m.name for m in cell.per_layer} == MULTI_LAYER
    specs = session.scan_specs(cell)
    assert [s["radius"] for s in specs] == [0.5, 0.4, 0.45, 0.55]
    dirs = [scene.scene_dir(s) for s in specs]
    assert len(set(dirs)) == 4
    assert dirs[0] == scene.scene_dir(session.scene_spec(cell.conf_path))  # dtu.stage1's scene
    entry = next(w for w in bench["workloads"] if w["name"] == "dtu.multiscan4")
    assert entry["chips"] == 1 and len(entry["why"]) <= 200


@pytest.mark.parametrize("radius, name", [(None, "sphere_49v_1200x1600_f1800"),
                                          (0.5, "sphere_49v_1200x1600_f1800"),
                                          (0.4, "sphere_49v_1200x1600_f1800_r0.4"),
                                          (0.55, "sphere_49v_1200x1600_f1800_r0.55")])
def test_a_scene_dir_gains_a_radius_only_off_half(radius, name):
    spec = {"kind": "sphere", "views": 49, "height": 1200, "width": 1600, "focal": 1800}
    if radius is not None:
        spec["radius"] = radius
    assert scene.scene_dir(spec, scene.CACHE) == scene.CACHE / name


def test_a_garment_takes_no_radius():
    with pytest.raises(ValueError):
        scene.scene_dir({"kind": "garment", "views": 8, "height": 300, "width": 400,
                         "focal": 346, "radius": 0.4})


@pytest.mark.parametrize("n_img, start, k", [(12, 0, 30), (49, 0, 50), (49, 1150, 50)])
def test_image_indices_default_to_random_state_0(n_img, start, k):
    rng = np.random.RandomState(0)  # Runner.train's order, written out
    perm, want = rng.permutation(n_img), []
    for step in range(start + k):
        if step >= start:
            want.append(perm[step % n_img])
        if (step + 1) % n_img == 0:
            perm = rng.permutation(n_img)
    assert session.image_indices(n_img, start, k).tolist() == [int(v) for v in want]
    assert not np.array_equal(session.image_indices(n_img, start, k, np.random.RandomState(1)),
                              want)


def test_a_radius_shrinks_the_sphere(tmp_path):
    from reference.png import read_png

    hits = {}
    for r in (0.4, 0.5):
        scene.generate_scene(str(tmp_path / f"r{r}"), kind="sphere", n_views=3, H=30, W=40,
                             focal=45.0, radius=r)
        hits[r] = [int((read_png(str(tmp_path / f"r{r}" / "mask" / f"{i:03d}.png"))
                        [..., 0] > 0).sum()) for i in range(3)]
    assert all(0 < a < b for a, b in zip(hits[0.4], hits[0.5]))


def run(tiny_bench, tmp_path, seed=2**31 + 13):
    cell = cells.load_cell("tiny.multiscan2", here=tiny_bench)
    return main.measure(cell, seed, 0.5, False, torch.device("cpu"), time.time(),
                        cache=tmp_path / "scenes")


def test_a_campaign_run_is_correct(tiny_bench, tmp_path, monkeypatch):
    seen = {}
    load = cells.load_reader

    def spy(name, here=cells.HERE):
        reader = load(name, here)

        class Spy:
            @staticmethod
            def read(ctx):
                seen.update(ctx.window)
                return reader.read(ctx)

        return Spy

    monkeypatch.setattr(cells, "load_reader", spy)
    res = run(tiny_bench, tmp_path)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= session.WINDOW
    assert seen["steps"] == res["attempted"] and seen["rays"] == res["attempted"] * 2 * 16
    assert set(res["readings"]["worst_scan"]) == {"loss_gap", "eikonal_gap", "udf_gap",
                                                  "color_gap", "grad_gap", "udf_grad_gap",
                                                  "change_gap"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["crossed_scans", "unchanged", "half_batch"])
def test_a_campaign_fault_is_caught(tiny_bench, tmp_path, monkeypatch, fault):
    faults.FAULTS[fault](models.load(models.DEFAULT), monkeypatch.setattr)
    res = run(tiny_bench, tmp_path)
    assert not res["correct"]
    if fault == "crossed_scans":  # scan 0 is sound: the worst scan is the crossed one
        assert res["readings"]["worst_scan"]["loss_gap"] == 1
        assert res["checks"]["loss_gap"]["value"] > 1e-3
