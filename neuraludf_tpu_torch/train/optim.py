"""Adam with per-leaf step counts, three learning-rate groups and runtime
trainability gating (counterpart of ``neuraludf_tpu/train/optim.py``).

The state mirrors the parameter dict: one ``{"m", "v", "t"}`` per leaf. A
leaf whose trainability scalar is 0 keeps its value, moments and step count,
like a torch parameter with ``requires_grad=False``. ``torch.optim.Adam`` is
not used: its bias correction counts steps per optimizer, not per leaf, and
it does not take the gated form below.

Learning rates and trainability scalars are Python floats or 0-dim tensors
(a captured step graph reads them from its schedule row). For CUDA tensors
``adam_step`` and ``flat_adam_step`` run the Adam kernel (``ops/adam.py``:
every leaf in one pass, then the step counts; the same update bit for bit
where the card's ``powf`` agrees). For CPU tensors ``adam_step_plain``
updates leaf by leaf and ``flat_adam_step_plain`` computes the same update
at once over the concatenated parameters (``cfg.train.flat_adam``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple, Union

import torch

from ..ops.adam import AdamLeaf, fused_adam

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


def adam_table(params: Params, grads: Dict[Tuple[str, ...], torch.Tensor], state: Params,
               lr_fn: Callable[[tuple], Scalar], trainable_fn: Callable[[tuple], Scalar]
               ) -> List[AdamLeaf]:
    """The Adam kernel's rows, one a leaf in ``leaves`` order."""
    out = []
    for path, p in leaves(params):
        st = get_path(state, path)
        out.append(AdamLeaf(p, grads.get(path), st["m"], st["v"], st["t"], lr_fn(path),
                            trainable_fn(path)))
    return out


def adam_step(params: Params, grads: Dict[Tuple[str, ...], torch.Tensor], state: Params,
              lr_fn: Callable[[tuple], Scalar], trainable_fn: Callable[[tuple], Scalar]) -> None:
    """Adam over every leaf. grads maps a leaf path to its gradient (a
    missing or None gradient counts as zeros, as JAX would give). CUDA
    tensors go to the Adam kernel, CPU tensors to ``adam_step_plain``; a
    mixed device, a tensor not float32 or not contiguous raises."""
    if not fused_adam(adam_table(params, grads, state, lr_fn, trainable_fn)):
        adam_step_plain(params, grads, state, lr_fn, trainable_fn)


def adam_step_plain(params: Params, grads: Dict[Tuple[str, ...], torch.Tensor], state: Params,
                    lr_fn: Callable[[tuple], Scalar], trainable_fn: Callable[[tuple], Scalar]
                    ) -> None:
    """``adam_step`` as PyTorch operations, ``adam_update`` leaf by leaf."""
    for path, p in leaves(params):
        g = grads.get(path)
        if g is None:
            g = torch.zeros_like(p)
        adam_update(p, g, get_path(state, path), lr_fn(path), trainable_fn(path))


def flat_adam_step(params: Params, grads: Dict[Tuple[str, ...], torch.Tensor], state: Params,
                   lr_fn: Callable[[tuple], Scalar], trainable_fn: Callable[[tuple], Scalar]
                   ) -> None:
    """``adam_step`` over the concatenated parameters (counterpart of the JAX
    package's ``flat_adam_step``): the Adam kernel for CUDA tensors, which
    walks every leaf in one pass, ``flat_adam_step_plain`` for CPU tensors."""
    if not fused_adam(adam_table(params, grads, state, lr_fn, trainable_fn)):
        flat_adam_step_plain(params, grads, state, lr_fn, trainable_fn)


@torch.no_grad()
def flat_adam_step_plain(params: Params, grads: Dict[Tuple[str, ...], torch.Tensor],
                         state: Params, lr_fn: Callable[[tuple], Scalar],
                         trainable_fn: Callable[[tuple], Scalar]) -> None:
    """``adam_step`` as one elementwise update over the concatenated parameter
    vector, in PyTorch operations.

    Each element goes through the operations of ``adam_update`` in the same
    order and dtype, so the result is the same bit for bit; each leaf's
    step count and bias corrections are computed on its own 0-dim ``t``
    (``_foreach`` ops: one launch on the card for all leaves), then spread
    over its elements. The state keeps its per-leaf ``m``/``v``/``t``, so
    checkpoints interchange with ``adam_step``'s."""
    paths, ps = zip(*leaves(params))
    sts = [get_path(state, path) for path in paths]
    sizes = [p.numel() for p in ps]
    consts: Dict[float, torch.Tensor] = {}

    def as_tensor(v: Scalar) -> torch.Tensor:
        """v as a 0-dim f32 tensor on the parameters' device (a fill, never
        a host copy)."""
        if isinstance(v, torch.Tensor):
            return v
        if v not in consts:
            consts[v] = torch.full((), float(v), dtype=torch.float32, device=ps[0].device)
        return consts[v]

    def spread(scalars: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat([s.reshape(()).expand(n) for s, n in zip(scalars, sizes)])

    flat = lambda ts: torch.cat([t.reshape(-1) for t in ts])
    trs = [as_tensor(trainable_fn(path)) for path in paths]
    lrs = [as_tensor(lr_fn(path)) for path in paths]
    t_new = torch._foreach_add([s["t"] for s in sts], trs)
    t_safe = torch._foreach_clamp_min(t_new, 1.0)
    bc1 = torch._foreach_add(torch._foreach_neg(torch._foreach_pow(BETA1, t_safe)), 1.0)
    bc2 = torch._foreach_add(torch._foreach_neg(torch._foreach_pow(BETA2, t_safe)), 1.0)

    p_f = flat(ps)
    g_f = flat([grads.get(path) if grads.get(path) is not None else torch.zeros_like(p)
                for path, p in zip(paths, ps)])
    m_f, v_f = flat([s["m"] for s in sts]), flat([s["v"] for s in sts])
    tr_f, lr_f = spread(trs), spread(lrs)
    m = tr_f * (BETA1 * m_f + (1 - BETA1) * g_f) + (1 - tr_f) * m_f
    v = tr_f * (BETA2 * v_f + (1 - BETA2) * g_f ** 2) + (1 - tr_f) * v_f
    m_hat = m / spread(bc1)
    v_hat = v / spread(bc2)
    new_p = p_f - tr_f * lr_f * m_hat / (torch.sqrt(v_hat) + EPS)

    unflat = lambda vec, like: [x.view_as(t) for x, t in zip(vec.split(sizes), like)]
    torch._foreach_copy_(list(ps), unflat(new_p, ps))
    torch._foreach_copy_([s["m"] for s in sts], unflat(m, ps))
    torch._foreach_copy_([s["v"] for s in sts], unflat(v, ps))
    torch._foreach_copy_([s["t"] for s in sts], t_new)


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
