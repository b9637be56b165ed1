"""Linear layers as parameter dictionaries, with PyTorch-default and
geometric inits: a frozen copy of the port's ``nets/mlp.py``, every
product in f32.

Weights are stored ``[d_in, d_out]`` like the JAX package, so a forward is
``x @ w + b`` and parameters convert between the two without transposes.
Weight norm is explicit: ``W = v * g / ||v||`` with the norm over the input
axis (one norm per output unit), ``g`` initialised to ``||v||``.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# Every product of the reference is a true f32 one (the caller turns TF32
# off). Inside ``rounded(fwd, bwd)`` each operand of every network's products
# is first rounded to ``fwd`` with a per-tensor scale (the amax to the
# format's largest value), and each cotangent that reaches such an operand
# in the backward pass to ``bwd`` the same way, as a mixed-precision step
# feeds its tensor cores (fp8 training takes e4m3 forward and e5m2 for the
# gradients); the products accumulate in f32. It is the control that a
# lower precision than the configuration's must fail.
_ROUNDING: contextvars.ContextVar = contextvars.ContextVar("rounding", default=None)


@contextlib.contextmanager
def rounded(fwd: torch.dtype, bwd: torch.dtype):
    token = _ROUNDING.set((fwd, bwd))
    try:
        yield
    finally:
        _ROUNDING.reset(token)


def scaled_round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to ``dtype`` under a per-tensor scale, back in t's type."""
    amax = t.abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.bwd = bwd
        return scaled_round(t, fwd)

    @staticmethod
    def backward(ctx, g):
        return scaled_round(g, ctx.bwd), None, None


def _matmul(x: torch.Tensor, w: torch.Tensor, role: str) -> torch.Tensor:
    types = _ROUNDING.get()
    if types is not None:
        return torch.matmul(_Round.apply(x, *types), _Round.apply(w, *types))
    return torch.matmul(x, w)


def weight(p: Params) -> torch.Tensor:
    """The effective [d_in, d_out] weight of a (possibly weight-normed) layer."""
    if "v" in p:
        v = p["v"]
        return v * (p["g"][None, :] / torch.linalg.vector_norm(v, dim=0, keepdim=True))
    return p["w"]


def linear(p: Params, x: torch.Tensor, role: str = "distance") -> torch.Tensor:
    return _matmul(x, weight(p), role) + p["b"]


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus(100 x) / 100, the JAX form of torch's Softplus(beta=100)."""
    return F.softplus(100.0 * x) / 100.0


def torch_default_linear(gen: torch.Generator, d_in: int, d_out: int) -> Params:
    """W, b ~ U(-1/sqrt(d_in), 1/sqrt(d_in)) (torch nn.Linear's default)."""
    bound = 1.0 / math.sqrt(d_in)
    w = (torch.rand((d_in, d_out), generator=gen) * 2.0 - 1.0) * bound
    b = (torch.rand((d_out,), generator=gen) * 2.0 - 1.0) * bound
    return {"w": w, "b": b}


def to_weight_norm(p: Params) -> Params:
    """Re-parametrise {'w','b'} into weight-norm form {'v','g','b'}."""
    v = p["w"]
    return {"v": v, "g": torch.linalg.vector_norm(v, dim=0), "b": p["b"]}


def geometric_linear(
    gen: torch.Generator,
    d_in: int,
    d_out: int,
    layer: int,
    num_layers: int,
    dims0: int,
    skip_in,
    multires: int,
    bias: float,
    inside_outside: bool = False,
) -> Params:
    """One layer of the geometric (sphere) initialised distance MLP;
    ``layer`` indexes 0..num_layers-2 and ``dims0`` is the embedded input
    width, whose first 3 columns are the raw xyz."""
    std = math.sqrt(2) / math.sqrt(d_out)
    if layer == num_layers - 2:  # last layer: mean-shifted normal, -bias
        mean = math.sqrt(math.pi) / math.sqrt(d_in)
        if inside_outside:
            mean, bias_val = -mean, bias
        else:
            bias_val = -bias
        w = mean + 0.0001 * torch.randn((d_in, d_out), generator=gen)
        b = torch.full((d_out,), bias_val)
    elif multires > 0 and layer == 0:
        # identity-xyz rows get a normal init; PE rows start at zero
        w = torch.zeros((d_in, d_out))
        w[:3, :] = torch.randn((3, d_out), generator=gen) * std
        b = torch.zeros((d_out,))
    elif multires > 0 and layer in skip_in:
        # skip layer: zero the PE part of the re-injected embedding
        w = torch.randn((d_in, d_out), generator=gen) * std
        w[-(dims0 - 3):, :] = 0.0
        b = torch.zeros((d_out,))
    else:
        w = torch.randn((d_in, d_out), generator=gen) * std
        b = torch.zeros((d_out,))
    return {"w": w, "b": b}
