"""ctypes bindings for the host marching-cubes engine (``csrc/udf_mc.cpp``),
the counterpart of ``neuraludf_tpu/mesh/mc.py``."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from .build import ensure_built

ALGORITHMS = {"tets": 0, "lewiner": 1}

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_OUTPUTS = [ctypes.POINTER(_F32P), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(_I32P), ctypes.POINTER(ctypes.c_int64)]
_DIMS = [ctypes.c_int64] * 3


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(ensure_built()))
    lib.udf_mc.restype = ctypes.c_int
    lib.udf_mc.argtypes = [_F32P, _F32P, *_DIMS, ctypes.c_float, ctypes.c_int32, *_OUTPUTS]
    lib.classic_mc.restype = ctypes.c_int
    lib.classic_mc.argtypes = [_F32P, *_DIMS, ctypes.c_float, ctypes.c_int32, *_OUTPUTS]
    lib.mesh_free.restype = None
    lib.mesh_free.argtypes = [_F32P, _I32P]
    return lib


def _algorithm(name: str) -> int:
    if name not in ALGORITHMS:
        raise ValueError(f"unknown marching-cubes algorithm {name!r}; one of {sorted(ALGORITHMS)}")
    return ALGORITHMS[name]


def _grid(a: np.ndarray, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 3 or min(a.shape) < 2:
        raise ValueError(f"{what} must be a 3-D grid of at least 2 points a side, "
                         f"got shape {a.shape}")
    return a


def _run(fn, *args) -> Tuple[np.ndarray, np.ndarray]:
    """Call an engine entry point, copy its mesh out and free it."""
    verts_p, faces_p = _F32P(), _I32P()
    nverts, nfaces = ctypes.c_int64(), ctypes.c_int64()
    ret = fn(*args, ctypes.byref(verts_p), ctypes.byref(nverts),
             ctypes.byref(faces_p), ctypes.byref(nfaces))
    if ret != 0:
        raise RuntimeError(f"marching-cubes engine {fn.__name__} returned {ret}")
    nv, nf = nverts.value, nfaces.value
    try:
        verts = (np.ctypeslib.as_array(verts_p, shape=(nv, 3)).copy() if nv
                 else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(faces_p, shape=(nf, 3)).copy() if nf
                 else np.zeros((0, 3), np.int32))
    finally:
        _lib().mesh_free(verts_p, faces_p)
    return verts, faces


def marching_cubes_udf(udf: np.ndarray, grads: np.ndarray, voxel_size: float,
                       algorithm: str = "tets"):
    """Gradient-aware MC on an unsigned field.

    udf: [N0,N1,N2] float32 (>=0); grads: [N0,N1,N2,3] float32 (the negated
    normalized gradient, pointing toward the surface). Returns (verts [V,3]
    in grid-index units, faces [F,3]).

    algorithm: 'tets' (marching tetrahedra, ambiguity-free default) or
    'lewiner' (Lewiner-table topology with face/interior saddle tests).
    """
    algo = _algorithm(algorithm)
    udf = _grid(udf, "udf")
    grads = np.ascontiguousarray(grads, np.float32)
    if grads.shape != udf.shape + (3,):
        raise ValueError(f"grads must have shape {udf.shape + (3,)}, got {grads.shape}")
    return _run(_lib().udf_mc, udf.ctypes.data_as(_F32P), grads.ctypes.data_as(_F32P),
                *udf.shape, ctypes.c_float(voxel_size), ctypes.c_int32(algo))


def marching_cubes_classic(grid: np.ndarray, isovalue: float, algorithm: str = "tets"):
    """Classic iso-surface extraction (value < isovalue is inside).
    Returns (verts [V,3] in grid-index units, faces [F,3])."""
    algo = _algorithm(algorithm)
    grid = _grid(grid, "grid")
    return _run(_lib().classic_mc, grid.ctypes.data_as(_F32P), *grid.shape,
                ctypes.c_float(isovalue), ctypes.c_int32(algo))
