"""Several processes in the port (``neuraludf_tpu_torch/parallel/multihost.py``)
on the CPU, over gloo on localhost:

- two processes of ``python -m neuraludf_tpu_torch.parallel.multihost
  --self-test --device cpu`` (a ray-parallel step, which checks itself
  against the single step, then a ray-parallel window, which checks itself
  against the single window) agree on the losses and on the updated
  parameters;
- the multi-scan command line with ``--multihost``: two processes train
  their round-robin shares of three scans, and every scan's checkpoint and
  mesh is written;
- ``shard_scans`` partitions as the JAX package's does;
- ``initialize`` refuses a partly set launcher environment, and the CLI's
  ``--multihost`` goes through it.

Each spawned group has a deadline; a group that outlives it is killed and
the test fails.
"""

import os
import re
import socket
import subprocess
import sys

import pytest

from neuraludf_tpu.data.synthetic import generate_scene
from neuraludf_tpu.parallel.multihost import shard_scans as j_shard_scans
from neuraludf_tpu_torch import cli
from neuraludf_tpu_torch.parallel import multihost
from test_torch_multi_scan import hocon_text
from test_torch_window import small_raw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 240  # a group of two small processes takes ~10-20 s


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(args, world: int = 2, cwd: str = ROOT) -> list:
    """``python <args>`` as ranks 0..world-1 of one group; their outputs.
    Kills the group and fails past DEADLINE_S or when a rank fails."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable] + args, cwd=cwd, env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=DEADLINE_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"the process group did not finish in {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_self_test_ranks_agree():
    outs = run_group(["-m", "neuraludf_tpu_torch.parallel.multihost", "--self-test",
                      "--device", "cpu"])
    rows = {}
    for out in outs:
        m = re.search(r"MULTIHOST_OK process=(\d+) loss=(\S+) single=(\S+) window_loss=(\S+) "
                      r"single_window_loss=(\S+) digest=(\S+) single_digest=(\S+) "
                      r"max_param_diff=(\S+) world=(\d+)", out)
        assert m, out[-3000:]
        rows[int(m.group(1))] = tuple(float(m.group(k)) for k in range(2, 10))
    assert set(rows) == {0, 1} and rows[0][7] == 2
    # every rank forms the whole batch's loss and makes the same updates
    assert rows[0] == rows[1], rows


def test_multi_scan_cli_over_two_processes(tmp_path):
    """Three scans over two processes: rank 0 trains scans 0 and 2, rank 1
    scan 1, each ends in its closing mesh, and both wait at the barrier."""
    for case in ("a", "b", "c"):
        generate_scene(str(tmp_path / "scenes" / case), kind="sphere", n_views=4, H=40, W=48,
                       focal=64.0)
    raw = small_raw(str(tmp_path / "scenes" / "CASE_NAME"), str(tmp_path / "exp"), end_iter=2,
                    freq=2)
    conf = tmp_path / "multi.conf"
    conf.write_text(hocon_text(raw))
    out = tmp_path / "out"
    outs = run_group(["-m", "neuraludf_tpu_torch.parallel.train_multi_scan", "--multihost",
                      "--device", "cpu", "--conf", str(conf), "--cases", "a", "b", "c",
                      "--end_iter", "2", "--out_dir", str(out), "--final_mesh_resolution", "16"])
    assert "training 2 scans" in outs[0] and "training 1 scans" in outs[1]
    for case in ("a", "b", "c"):
        assert os.listdir(out / case / "checkpoints") == ["ckpt_000002.ckpt"]
        assert os.listdir(out / case / "udf_meshes") == ["udf_res16_step2.ply"]


@pytest.mark.parametrize("n_scans,world", [(8, 3), (8, 8), (1, 2), (5, 2), (7, 4)])
def test_shard_scans_partitions_like_jax(n_scans, world):
    dirs = [f"scan{i}" for i in range(n_scans)]
    parts = [multihost.shard_scans(dirs, r, world) for r in range(world)]
    assert parts == [j_shard_scans(dirs, r, world) for r in range(world)]
    assert sorted(sum(parts, [])) == sorted(dirs)
    assert max(map(len, parts)) - min(map(len, parts)) <= 1


def test_partial_environment_raises(monkeypatch):
    for name in multihost.ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR and MASTER_PORT and RANK and WORLD_SIZE"):
        multihost.initialize("cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="MASTER_PORT and WORLD_SIZE not set"):
        multihost.initialize("cpu")
    # the CLI's --multihost joins the group first, and so raises the same
    with pytest.raises(ValueError, match="MASTER_PORT"):
        cli.main(["--mode", "train", "--multihost", "--case", "sphere", "--conf",
                  os.path.join(ROOT, "confs", "synthetic_smoke.conf")])
