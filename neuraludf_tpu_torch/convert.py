"""Parameters and checkpoints between the JAX package and the port.

Both keep the same nested-dict layout, so conversion moves arrays and
transposes nothing:

* linear weights are ``[d_in, d_out]`` (``x @ w + b``);
* weight-norm layers are ``{"v", "g", "b"}`` with the norm of ``v`` over
  the input axis;
* the layer before the distance net's skip is narrower, e.g. ``lin3`` is
  ``[256, 217]`` for a skip into layer 4 with a 39-wide embedding;
* Adam state is one ``{"m", "v", "t"}`` per parameter leaf.

A JAX checkpoint is a pickle of ``{"params", "opt_state", "iter_step",
"beta_trainable", "variance_trainable", "rng"}`` holding numpy arrays; the
port writes the same keys, with its generator state under ``"torch_rng"``
in place of the JAX key.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

Tree = Dict[str, Any]


def to_torch(tree: Tree, device="cpu", requires_grad: bool = False) -> Tree:
    """Nested dict of arrays -> nested dict of float32 tensors on device."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = to_torch(val, device, requires_grad)
        else:
            t = torch.tensor(np.asarray(val, np.float32), device=device)
            out[key] = t.requires_grad_(requires_grad)
    return out


def to_numpy(tree: Tree) -> Tree:
    """Nested dict of tensors -> nested dict of numpy arrays."""
    return {key: to_numpy(val) if isinstance(val, dict) else val.detach().cpu().numpy()
            for key, val in tree.items()}


def check_like(tree: Tree, ref: Tree, where: str = "") -> None:
    """Raise unless tree has ref's keys and leaf shapes."""
    if set(tree) != set(ref):
        raise ValueError(f"{where or 'params'}: keys {sorted(tree)} != {sorted(ref)}")
    for key, val in ref.items():
        sub = f"{where}/{key}"
        if isinstance(val, dict):
            check_like(tree[key], val, sub)
        elif tuple(np.shape(tree[key])) != tuple(val.shape):
            raise ValueError(f"{sub}: shape {np.shape(tree[key])} != {tuple(val.shape)}")


def params_from_jax(tree: Tree, device="cpu", like: Optional[Tree] = None) -> Tree:
    """The port's trainable parameter dict from a JAX params pytree (numpy
    or JAX arrays). With ``like`` (e.g. the port's own ``init_params``),
    keys and shapes are checked against it first."""
    if like is not None:
        check_like(tree, like)
    return to_torch(tree, device, requires_grad=True)


def opt_state_from_jax(tree: Tree, device="cpu") -> Tree:
    return to_torch(tree, device, requires_grad=False)


def load_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    """A checkpoint of the JAX trainer or of the port, with params and Adam
    state as tensors on device."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    out = dict(payload)
    out["params"] = params_from_jax(payload["params"], device)
    out["opt_state"] = opt_state_from_jax(payload["opt_state"], device)
    out["iter_step"] = int(payload["iter_step"])
    return out
