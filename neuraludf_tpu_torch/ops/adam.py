"""The Adam update of the training step as one CUDA kernel
(``csrc/adam.cu``).

It computes ``train/optim.py`` ``adam_update`` for every leaf of the tree
at once, bit for bit where the card's ``powf`` agrees with PyTorch's: two
launches an update (the element pass, then the leaves' step counts) in
place of ~33 PyTorch kernels a leaf. ``optim.adam_step`` and
``optim.flat_adam_step`` call ``fused_adam`` for CUDA tensors and keep their
plain bodies for the CPU.

A table row (``AdamLeaf``) is a leaf's parameter, gradient (None: zeros),
its ``m``, ``v`` and 0-dim ``t`` from the optimizer state, and its learning
rate and trainability: Python floats, or 0-dim tensors on the parameters'
device (a schedule row's entries, which a captured graph reads at every
replay). A float is passed by value, as PyTorch passes a Python scalar to
its kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Union

import torch

from . import build

Scalar = Union[float, torch.Tensor]


class AdamLeaf(NamedTuple):
    p: torch.Tensor
    g: Optional[torch.Tensor]
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor
    lr: Scalar
    tr: Scalar


class _Leaf(ctypes.Structure):
    """``AdamLeaf`` of ``csrc/adam.cu``: pointers, by-value scalars, size."""
    _fields_ = [(name, ctypes.c_void_p) for name in ("p", "g", "m", "v", "t", "lr", "tr")] + [
        ("lr_val", ctypes.c_float), ("tr_val", ctypes.c_float), ("n", ctypes.c_int),
        ("chunk0", ctypes.c_int), ("vec", ctypes.c_int), ("pad", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """csrc/adam.cu, built at first use, with its argument types."""
    lib = build.load("adam")
    lib.adam_update.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.adam_update.restype = ctypes.c_int
    return lib


def table_device(table: Sequence[AdamLeaf]) -> torch.device:
    """The one device of every tensor of the table. Raises ValueError on a
    mixed device, a tensor that is not float32 or not contiguous, a
    gradient or moment shaped unlike its parameter, or a step count,
    learning rate or trainability that is not one element."""
    if not table:
        raise ValueError("an Adam update of no leaves")
    dev = table[0].p.device
    for i, leaf in enumerate(table):
        shaped = {"p": leaf.p, "g": leaf.g, "m": leaf.m, "v": leaf.v}
        single = {"t": leaf.t, "lr": leaf.lr, "tr": leaf.tr}
        for name, t in (*shaped.items(), *single.items()):
            if not isinstance(t, torch.Tensor):
                continue
            if t.device != dev:
                raise ValueError(f"leaf {i}: {name} on {t.device}, the parameters on {dev}")
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"leaf {i}: {name} must be a contiguous float32 tensor, got "
                                 f"{t.dtype} (contiguous={t.is_contiguous()})")
            if name in shaped and t.shape != leaf.p.shape:
                raise ValueError(f"leaf {i}: {name} of shape {tuple(t.shape)}, the parameter "
                                 f"{tuple(leaf.p.shape)}")
            if name in single and t.numel() != 1:
                raise ValueError(f"leaf {i}: {name} must hold one element, got {tuple(t.shape)}")
        if not isinstance(leaf.t, torch.Tensor):
            raise ValueError(f"leaf {i}: t must be a tensor")
        if leaf.p.numel() >= 2 ** 31:
            raise ValueError(f"leaf {i}: {leaf.p.numel()} elements; the kernel takes < 2^31")
    return dev


class _FusedAdam:
    """The Adam kernel's entry point with its launch count (one per update,
    which is two CUDA launches for up to 128 leaves)."""

    def __init__(self):
        self.launches = 0

    @torch.no_grad()
    def __call__(self, table: Sequence[AdamLeaf]) -> bool:
        """Checks the table (``table_device``). For CUDA tensors updates
        every leaf in place (p, m, v and t) and returns True; for CPU
        tensors returns False, for the caller's plain body."""
        dev = table_device(table)
        if dev.type != "cuda":
            return False
        rows = (_Leaf * len(table))()
        for row, leaf in zip(rows, table):
            row.p, row.m, row.v, row.t = (leaf.p.data_ptr(), leaf.m.data_ptr(), leaf.v.data_ptr(),
                                          leaf.t.data_ptr())
            row.g = None if leaf.g is None else leaf.g.data_ptr()
            if isinstance(leaf.lr, torch.Tensor):
                row.lr = leaf.lr.data_ptr()
            else:
                row.lr_val = leaf.lr
            if isinstance(leaf.tr, torch.Tensor):
                row.tr = leaf.tr.data_ptr()
            else:
                row.tr_val = leaf.tr
            row.n = leaf.p.numel()
        lib = library()
        with torch.cuda.device(dev):
            rc = lib.adam_update(ctypes.addressof(rows), len(table),
                                 torch.cuda.current_stream(dev).cuda_stream)
            self.launches += 1
        if rc != 0:
            raise RuntimeError(f"adam_update failed: CUDA error {rc}")
        return True


fused_adam = _FusedAdam()
