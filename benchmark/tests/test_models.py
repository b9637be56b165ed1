"""Models are found by name: a configuration names its model
(``benchmark { model = <m> }``), ``models/<m>.py`` gives the interface,
and NeuralUDF is the default. A second model is added to a copy of the
benchmark folder with new files and new ``BENCHMARK.json`` entries alone:
its cell builds and runs on the CPU, reads what the same cell of the
default model reads, and no file that was there changes."""

import hashlib
import json
import shutil
import time

import pytest
import torch

import models
from conftest import HERE, tiny_conf
from harness import cells, main, session

torch.set_num_threads(2)

LIMITS = {"loss_gap": 1e-4, "eikonal_gap": 1e-4, "grad_gap": 1e-4, "udf_grad_gap": 1e-4,
          "change_gap": 1e-3}


def test_the_real_configurations_are_neuraludfs():
    for conf in sorted((HERE / "configs").glob("*.conf")):
        assert models.name_of(conf) == models.DEFAULT == "neuraludf"
    m = models.load(models.DEFAULT)
    assert all(hasattr(m, n) for n in models.INTERFACE)
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        assert models.for_cell(cells.load_cell(w["name"], bench)) is m


@pytest.mark.parametrize("text, name", [
    ("scene { kind = sphere }\n", "neuraludf"),
    ("scene { kind = sphere }\nbenchmark { model = neus }\n", "neus"),
    ("benchmark {\n  model = \"neus_2\"\n}\n", "neus_2")])
def test_a_configuration_names_its_model(tmp_path, text, name):
    path = tmp_path / "c.conf"
    path.write_text(text)
    assert models.name_of(path) == name


def test_a_module_without_the_interface_is_refused(tmp_path):
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "half.py").write_text("NAME = 'half'\n")
    with pytest.raises(TypeError):
        models.load("half", tmp_path)
    with pytest.raises(ValueError):
        models.load("../x", tmp_path)


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_second_model_is_added_with_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    here = root / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(HERE.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    bench_before = json.loads((root / "BENCHMARK.json").read_text())

    # the new model: models/second.py (here a copy of NeuralUDF's module under
    # another name), a configuration naming it, a workload, entries
    source = (here / "models" / "neuraludf.py").read_text()
    (here / "models" / "second.py").write_text(source.replace('NAME = "neuraludf"',
                                                              'NAME = "second"'))
    (here / "configs" / "tiny.conf").write_text(tiny_conf("tiny"))
    (here / "configs" / "second.conf").write_text(tiny_conf("tiny")
                                                  + "benchmark { model = second }\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, config, conf in (("tiny.stage1", "tiny", "tiny.conf"),
                               ("second.stage1", "second", "second.conf")):
        (here / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": config, "conf": conf, "stage": "stage1", "limits": LIMITS}))
        bench["workloads"].append({"name": name, "config": config, "traffic": "stage1",
                                   "chips": 1, "why": "tiny"})
        bench["configs"].append({"name": config, "source": "tiny",
                                 "file": f"benchmark/configs/{conf}", "reduced": [],
                                 "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    dev = torch.device("cpu")
    readings = {}
    for name in ("tiny.stage1", "second.stage1"):
        cell = cells.load_cell(name, here=here)
        model = models.for_cell(cell)
        assert model.NAME == name.split(".")[0].replace("tiny", "neuraludf")
        setup = session.build(cell, 2**31 + 51, dev, str(tmp_path / name),
                              cache=tmp_path / "scenes")
        assert setup.model is model
        ref = session.reference_side(cell, setup.first, setup.scene_dir, dev,
                                     str(tmp_path / name))
        readings[name] = (session.program_side(setup.first), ref)
    assert readings["second.stage1"] == readings["tiny.stage1"]

    res = main.measure(cells.load_cell("second.stage1", here=here), 2**31 + 52, 0.5, False,
                       dev, time.time(), cache=tmp_path / "scenes")
    assert res["correct"] and res["failed"] == 0

    after = _digests(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {"BENCHMARK.json"}  # and there only entries were added
    bench_after = json.loads((root / "BENCHMARK.json").read_text())
    for key, entries in bench_before.items():
        if isinstance(entries, list):
            assert bench_after[key][:len(entries)] == entries
        else:
            assert bench_after[key] == entries
    assert set(after) - set(before) == {
        "benchmark/models/second.py", "benchmark/configs/tiny.conf",
        "benchmark/configs/second.conf", "benchmark/workloads/tiny.stage1.json",
        "benchmark/workloads/second.stage1.json"}
