"""On the card: one short run of a real cell end to end, through the
command the driver runs. Skips where there is no CUDA device (decided
inside the test)."""

import json
import subprocess
import sys

import pytest

from conftest import HERE


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_of_a_cell_is_correct(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "garment.stage1",
                          "--seed", str(2**31 + 21 + trace), "--seconds", "2", "--trace",
                          str(trace)], cwd=HERE.parent, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
