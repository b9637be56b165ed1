"""The loader, the result line and the check for JAX, on the CPU."""

import json
import sys

import pytest

from conftest import HERE
from harness import cells, main

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_real_cells_load_by_name():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"], bench)
        assert cell.conf_path.is_file() and cell.config == w["config"]
        assert {m.name for m in cell.end_to_end} == {"rays_per_s", "peak_mem_gib", "setup_s"}
        listed = {m["name"] for m in bench["per_layer"] if w["name"] in m["workloads"]}
        assert {m.name for m in cell.per_layer} == listed
        assert {"kernels_per_step", "device_idle_share", "step_mfu"} <= listed
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.load_reader(m.name).read)
    for c in bench["configs"]:
        assert (HERE.parent / c["file"]).is_file()


def test_a_cell_added_as_files_alone_is_found(tiny_bench):
    bench = json.loads((tiny_bench.parent / "BENCHMARK.json").read_text())
    cell = cells.load_cell("tinyg.stage1", bench, here=tiny_bench)
    assert cell.workload["reg_weights_schedule"] is True
    assert cell.conf_path == tiny_bench / "configs" / "tinyg.conf"
    assert cells.load_reader("step_mfu", tiny_bench).read
    with pytest.raises(KeyError):
        cells.load_cell("nope.stage1", bench, here=tiny_bench)


@pytest.mark.parametrize("name", ["a b", "a,b", "a/b", "../x", ".hidden", "-x", "μs", "",
                                  "x" * 65, "tab\tname"])
def test_bad_names_are_refused(name):
    with pytest.raises(ValueError):
        cells.check_name(name)


@pytest.mark.parametrize("unit", ["tokens per second", "µs", "", "x" * 17, "a,b"])
def test_bad_units_are_refused(unit):
    with pytest.raises(ValueError):
        cells.check_unit(unit)


@pytest.mark.parametrize("ok", ["dtu.stage1", "rays_per_s", "A-1_b.c", "0x"])
def test_good_names_pass(ok):
    assert cells.check_name(ok) == ok


@pytest.mark.parametrize("unit", ["rays/s", "GiB", "%", "kernels", "s"])
def test_good_units_pass(unit):
    assert cells.check_unit(unit) == unit


def result(trace=False):
    out = {"correct": True, "attempted": 100, "failed": 0,
           "metrics": {"rays_per_s": {"value": 1.5, "unit": "rays/s"}},
           "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                      "memory_peak_bytes": 1}}
    if trace:
        out["breakdown"] = {"device_ops": [["k", 0.1]], "idle_gaps": [["h", 0.01]]}
    out["checks"] = {"loss_gap": {"value": 1e-4, "limit": 1e-2}}
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_holds_the_contract_keys(capsys, trace):
    assert main.emit(result(trace)) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want  # checks comes last
    assert err.strip().splitlines()[-1] == "loss_gap 0.0001 limit 0.01"


@pytest.mark.parametrize("name, bad", [
    ("jax.numpy", True), ("jax", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("neuraludf_tpu.ops", True), ("neuraludf_tpu", True), ("neuraludf_tpu_torch.ops", False),
    ("neuraludf_tpu_torch", False), ("jaxtyping", False), ("reference.step", False)])
def test_forbidden_modules_compare_whole_top_level_names(name, bad):
    assert main.forbidden_modules([name]) == ([name] if bad else [])


def test_a_loaded_jax_package_withholds_the_result(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "neuraludf_tpu.ops", object())
    assert main.emit(result()) == 3
    out, err = capsys.readouterr()
    assert out == "" and "neuraludf_tpu.ops" in err


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main.main(["--workload", "dtu.stage1", "--seed", "3000000000", "--seconds", "1",
                    "--trace", "0"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""


def test_process_start_is_before_now():
    import time

    assert 0 <= time.time() - main.process_start() < 3600 * 24 * 365


def test_the_finetune_starts_from_the_reference(tiny_bench, tmp_path):
    """A finetune cell's start is the plain reference's stage-1 steps from
    the seeded weights, made before the port's set-up and handed to it."""
    import torch

    from harness import check, session

    cell = cells.load_cell("tiny.finetune", here=tiny_bench)
    dev = torch.device("cpu")
    setup = session.build(cell, 2**31 + 31, dev, str(tmp_path), cache=tmp_path / "scenes")
    start = setup.first["start"]
    assert start["opt"] is not None and setup.reference_s > 0
    seeded = dict(check.flat_leaves(setup.model.init_weights(setup.cfg, 2**31 + 31, dev)))
    made = dict(check.flat_leaves(start["params"]))
    assert any(not torch.equal(made[k], seeded[k]) for k in made)  # the steps moved it
    for k, t in setup.first["p0"].items():  # the port began where the reference ended
        assert torch.equal(t, made[k])
    counts = [float(t) for path, t in check.flat_leaves(start["opt"]) if path[-1] == "t"]
    assert max(counts) == cell.workload["setup_steps"]  # Adam's steps of the start
