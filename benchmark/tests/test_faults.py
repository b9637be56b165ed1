"""A run on the CPU at a tiny size, past the look for a card, with the timed
path sound and with faults planted underneath it: ``correct`` must come
out true once and false for each fault a training cell can have (a step
that leaves its state unchanged; half of the batch left out, the means
taken over the rest; K2 returning one layer's weight cotangents doubled:
``harness.faults``; a campaign's own faults are in ``test_multiscan.py``). The control, the plain reference in fp8 put in the
port's place, must fail the tiny cell's limits as well. One chip's cells
have no exchange between chips, and a training step no token, to alter."""

import time

import pytest
import torch

import models
from harness import cells, check, faults, main, session

torch.set_num_threads(2)


def run(tiny_bench, tmp_path, name="tiny.stage1", seed=2**31 + 11):
    cell = cells.load_cell(name, here=tiny_bench)
    return main.measure(cell, seed, 0.5, False, torch.device("cpu"), time.time(),
                        cache=tmp_path / "scenes")


def test_sound_run_is_correct(tiny_bench, tmp_path):
    res = run(tiny_bench, tmp_path)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 50
    assert list(res)[-1] == "checks"
    assert {"rays_per_s", "peak_mem_gib", "setup_s"} <= set(res["metrics"])


def test_unchanged_state_is_caught(tiny_bench, tmp_path, monkeypatch):
    faults.FAULTS["unchanged"](models.load(models.DEFAULT), monkeypatch.setattr)
    res = run(tiny_bench, tmp_path)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] >= 0.99


def test_half_batch_is_caught(tiny_bench, tmp_path, monkeypatch):
    faults.FAULTS["half_batch"](models.load(models.DEFAULT), monkeypatch.setattr)
    res = run(tiny_bench, tmp_path)
    assert not res["correct"]


@pytest.mark.parametrize("name", ["tiny.stage1", "tiny.finetune"])
def test_a_k2_layer_fault_is_caught(tiny_bench, tmp_path, monkeypatch, name):
    faults.FAULTS["k2_layer"](models.load(models.DEFAULT), monkeypatch.setattr)
    res = run(tiny_bench, tmp_path, name)
    assert not res["correct"]
    assert res["checks"]["udf_grad_gap"]["value"] >= 0.1


@pytest.mark.parametrize("name", ["tiny.stage1", "tinyg.stage1", "tiny.finetune",
                                  "tiny.multiscan2"])
def test_the_control_fails(tiny_bench, tmp_path, name):
    cell = cells.load_cell(name, here=tiny_bench)
    dev = torch.device("cpu")
    setup = session.build(cell, 2**31 + 12, dev, str(tmp_path), cache=tmp_path / "scenes")
    refs, ctls = [], []
    for first, scene_dir in zip(setup.firsts, setup.scene_dirs):
        refs.append(session.reference_side(cell, first, scene_dir, dev, str(tmp_path)))
        ctls.append(session.reference_side(cell, first, scene_dir, dev, str(tmp_path),
                                           rounding=faults.CONTROL))
    ports = [session.program_side(f) for f in setup.firsts]
    assert set(check.compare_scans(ports, refs, setup.model)[0].values()) == {0.0}
    assert not check.judge(check.compare_scans(ctls, refs, setup.model)[0], cell.workload["limits"])
