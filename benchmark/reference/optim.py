"""Adam with per-leaf step counts, three learning-rate groups and runtime
trainability gating (a frozen copy of the port's
``train/optim.py``).

The state mirrors the parameter dict: one ``{"m", "v", "t"}`` per leaf. A
leaf whose trainability scalar is 0 keeps its value, moments and step count,
like a torch parameter with ``requires_grad=False``. ``torch.optim.Adam`` is
not used: its bias correction counts steps per optimizer, not per leaf, and
it does not take the gated form below. ``adam_step`` updates leaf by leaf
(the port's ``flat_adam_step`` is the same update over the concatenated
parameters, bit for bit).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple, Union

import torch

Params = Dict[str, Any]
Scalar = Union[float, torch.Tensor]

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def leaves(tree: Params, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict, in sorted key order (the order
    of JAX's tree flattening)."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from leaves(val, path + (key,))
        else:
            yield path + (key,), val


def get_path(tree: Params, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def init_adam_state(params: Params) -> Params:
    state: Params = {}
    for path, p in leaves(params):
        node = state
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = {"m": torch.zeros_like(p, requires_grad=False),
                          "v": torch.zeros_like(p, requires_grad=False),
                          "t": torch.zeros((), dtype=torch.float32, device=p.device)}
    return state


@torch.no_grad()
def adam_update(param: torch.Tensor, grad: torch.Tensor, state: Dict[str, torch.Tensor],
                lr: Scalar, trainable: Scalar) -> None:
    """One Adam step on a single leaf, in place (param, m, v and t).
    trainable is 0 or 1; lr and trainable are floats or 0-dim tensors."""
    t = state["t"] + trainable
    m = trainable * (BETA1 * state["m"] + (1 - BETA1) * grad) + (1 - trainable) * state["m"]
    v = trainable * (BETA2 * state["v"] + (1 - BETA2) * grad ** 2) + (1 - trainable) * state["v"]
    t_safe = torch.clamp(t, min=1.0)
    m_hat = m / (1 - BETA1 ** t_safe)
    v_hat = v / (1 - BETA2 ** t_safe)
    param.copy_(param - trainable * lr * m_hat / (torch.sqrt(v_hat) + EPS))
    state["m"].copy_(m)
    state["v"].copy_(v)
    state["t"].copy_(t)


def adam_step(params: Params, grads: Dict[Tuple[str, ...], torch.Tensor], state: Params,
              lr_fn: Callable[[tuple], float], trainable_fn: Callable[[tuple], float]) -> None:
    """Adam over every leaf. grads maps a leaf path to its gradient (a
    missing or None gradient counts as zeros, as JAX would give)."""
    for path, p in leaves(params):
        g = grads.get(path)
        if g is None:
            g = torch.zeros_like(p)
        adam_update(p, g, get_path(state, path), lr_fn(path), trainable_fn(path))


def make_lr_fn(lr_geo, lr_main, lr_nerf):
    """Parameter groups: geo = the UDF net, nerf = the background, main =
    the rest."""

    def lr_fn(path_keys):
        top = path_keys[0]
        if top == "udf":
            return lr_geo
        if top == "nerf":
            return lr_nerf
        return lr_main

    return lr_fn


def make_trainable_fn(beta_cfg, variance_trainable, beta_trainable):
    """Trainability per leaf: gamma/zeta follow the static config flags,
    beta and variance the runtime scalars."""

    def fn(path_keys):
        top = path_keys[0]
        if top == "variance":
            return variance_trainable
        if top == "beta":
            leaf = path_keys[-1]
            if leaf == "beta":
                return beta_trainable
            if leaf == "gamma":
                return 1.0 if beta_cfg.requires_grad_gamma else 0.0
            if leaf == "zeta":
                return 1.0 if beta_cfg.requires_grad_zeta else 0.0
        return 1.0

    return fn
