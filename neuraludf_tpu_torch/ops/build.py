"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
by ``nvcc`` for sm_90a into ``build/kernels/lib<name>_<hash>.so`` (the hash
is of the source and of the headers ``csrc/*.cuh``, so an edited source or
header is rebuilt) and loaded with ctypes.
The callers set the argument types of the functions they call. A failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    cand = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return cand


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # what a source may include
        h.update(header.read_bytes())
    return BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"


def compile_sources(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` that has no library yet, one nvcc
    process each, all started together; returns name -> library path. The
    ``-Xptxas -v`` report goes to ``ptxas_<name>_<hash>.log`` beside it."""
    targets = {name: _target(name) for name in names}
    running = []
    for name, out in targets.items():
        if out.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        running.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in running:  # wait for all, so that none is left running
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, out)
        out.with_name(f"ptxas_{out.stem[3:]}.log").write_text(err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    return ctypes.CDLL(str(compile_sources([name])[name]))
