"""Build the host marching-cubes engine of ``mesh/csrc/`` (g++ -> shared
object), the counterpart of ``neuraludf_tpu/mesh/build.py``.

The sources are a copy of the JAX package's, compiled with the same flags,
so one grid gives bit-identical meshes in both engines (another ``-march``
or ``-ffp-contract`` would change FMA contraction). The library goes to
``build/mesh/libudf_mc_<hash>.so``, keyed on a hash of all four sources, at
first use. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("udf_mc.cpp", "lewiner.cpp")
HEADERS = ("lewiner.h", "lewiner_luts.h")
BUILD = Path(__file__).resolve().parents[2] / "build" / "mesh"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _target() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    return BUILD / f"libudf_mc_{digest.hexdigest()[:16]}.so"


def ensure_built() -> Path:
    """The engine's library, compiled first if no library of these sources
    exists. Concurrent builds write their own temporary file and the last
    rename wins."""
    out = _target()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, *(str(CSRC / s) for s in SOURCES), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on the marching-cubes engine ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out
