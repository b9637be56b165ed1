"""The benchmark of neuraludf_tpu_torch on one H100: one cell, one run.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. See ``harness/main.py``.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]  # the harness, and the port at the checkout's root
# every cache of a run stays at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = os.path.join(HERE, ".cache", sub)

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
