"""Helpers whose gradients follow the JAX package's, and that a CUDA graph
can hold.

``torch.clamp`` passes the whole gradient to an input that equals a bound;
``jnp.clip`` (a ``maximum`` then a ``minimum``) passes half of it. Ties are
common in the renderer (``1 - alpha`` rounds to exactly 1 where alpha is
tiny), so the port clips the way JAX does.

``torch.cumprod``'s backward tests its input for zeros on the host (an
``item()``, which a captured step graph cannot hold); ``cumprod_nonzero``
takes the formula that test picks for inputs without zeros, which are all
the renderer has.
"""

from __future__ import annotations

import torch


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """jnp.clip: maximum(x, lo) then minimum(., hi), half the gradient at ties.
    A bound given as a number becomes a 0-dim tensor by a fill on x's device,
    not by a host copy (a captured step graph may not copy from the host)."""
    if lo is not None:
        x = torch.maximum(x, _bound(lo, x))
    if hi is not None:
        x = torch.minimum(x, _bound(hi, x))
    return x


def _bound(v, x: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(x.dtype)
    return torch.full((), v, dtype=x.dtype, device=x.device)


class _CumprodNonzero(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        # torch.cumprod's backward where no input is 0: the reversed
        # cumulative sum of out * grad, over x
        return (out * grad).flip(-1).cumsum(-1).flip(-1) / x


def cumprod_nonzero(x: torch.Tensor) -> torch.Tensor:
    """torch.cumprod over the last axis of an x with no zero element (the
    renderer's factors are at least 1e-7), with a backward that reads
    nothing on the host."""
    return _CumprodNonzero.apply(x)
