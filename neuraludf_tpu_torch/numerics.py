"""Elementwise helpers whose gradients follow the JAX package's.

``torch.clamp`` passes the whole gradient to an input that equals a bound;
``jnp.clip`` (a ``maximum`` then a ``minimum``) passes half of it. Ties are
common in the renderer (``1 - alpha`` rounds to exactly 1 where alpha is
tiny), so the port clips the way JAX does.
"""

from __future__ import annotations

import torch


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """jnp.clip: maximum(x, lo) then minimum(., hi), half the gradient at ties."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype, device=x.device))
    return x
