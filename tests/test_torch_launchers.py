"""The port's training launchers (``scripts/torch_train_*.sh``) against the
JAX package's (``scripts/train_*.sh``): given the same flags, each runs
``python -m`` with the same arguments, the module apart, and passes ``-g``
on as ``--gpu``; then the port's CLI parses those arguments into the JAX
CLI's configuration and ``Runner`` options."""

import dataclasses
import os
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
LAUNCHERS = ("dtu", "dtu_ft", "garment", "garment_ft")
SHIM = """#!/bin/sh
for a in "$@"; do printf '%s\\n' "$a"; done > "$RECORD"
"""


def recorded_argv(script: Path, flags, tmp_path) -> list:
    """The arguments ``script`` gives ``python``, read from a shim first on
    PATH."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    shim = bin_dir / "python"
    shim.write_text(SHIM)
    shim.chmod(0o755)
    record = tmp_path / f"{script.stem}.args"
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}", RECORD=str(record))
    subprocess.run(["bash", str(script)] + flags, cwd=ROOT, env=env, check=True, timeout=60)
    return record.read_text().splitlines()


def flags_of(name: str) -> list:
    flags = ["-c", "scan24", "-lr", "3e-4", "--learning_rate_geo", "2e-5", "-g", "1"]
    return flags + (["-s", "0.002"] if name.startswith("garment") else [])


def cli_run(package: str, argv, monkeypatch) -> dict:
    """``main(argv)`` of a package's CLI with its Runner replaced by a
    recorder: the configuration and the Runner's options."""
    import importlib

    cli = importlib.import_module(f"{package}.cli")
    runner_mod = importlib.import_module(f"{package}.train.runner")
    seen = {}

    class Stop(Exception):
        pass

    def recorder(cfg, mode="train", **kw):
        seen.update(cfg=dataclasses.asdict(cfg), mode=mode, **kw)
        raise Stop

    monkeypatch.setattr(runner_mod, "Runner", recorder)
    if package == "neuraludf_tpu_torch":
        monkeypatch.setattr(runner_mod, "default_device", lambda gpu=0: f"cuda:{gpu}")
    with pytest.raises(Stop):
        cli.main(argv)
    return seen


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_matches_jax_launcher(tmp_path, monkeypatch, name):
    flags = flags_of(name)
    jax_argv = recorded_argv(ROOT / "scripts" / f"train_{name}.sh", flags, tmp_path)
    port_argv = recorded_argv(ROOT / "scripts" / f"torch_train_{name}.sh", flags, tmp_path)
    assert jax_argv[:2] == ["-m", "neuraludf_tpu.cli"]
    assert port_argv[:2] == ["-m", "neuraludf_tpu_torch.cli"]
    assert port_argv[-2:] == ["--gpu", "1"]  # the JAX launcher drops -g
    assert port_argv[2:-2] == jax_argv[2:]
    for flag, value in (("--case", "scan24"), ("--learning_rate", "3e-4"),
                        ("--learning_rate_geo", "2e-5")):
        assert jax_argv[jax_argv.index(flag) + 1] == value
    if name.startswith("garment"):
        assert jax_argv[jax_argv.index("--sparse_weight") + 1] == "0.002"

    jax_run = cli_run("neuraludf_tpu", jax_argv[2:], monkeypatch)
    port_run = cli_run("neuraludf_tpu_torch", port_argv[2:], monkeypatch)
    assert port_run.pop("device") == "cuda:1"
    # the confs list the JAX package among the sources to snapshot: equal fields
    assert port_run == jax_run
    train = port_run["cfg"]["train"]
    assert (train["learning_rate"], train["learning_rate_geo"]) == (3e-4, 2e-5)
    assert port_run["is_finetune"] == name.endswith("_ft")


def test_launcher_without_flags_keeps_the_conf(tmp_path):
    """Only the case given: no learning rate, sparse weight or --gpu passed."""
    argv = recorded_argv(ROOT / "scripts" / "torch_train_garment.sh", ["-c", "skirt"], tmp_path)
    assert argv == ["-m", "neuraludf_tpu_torch.cli", "--conf", "./confs/udf_garment_blending.conf",
                    "--case", "skirt", "--threshold", "0.005", "--resolution", "128",
                    "--vis_ray", "--reg_weights_schedule"]
