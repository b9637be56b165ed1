"""NeRF positional encoding (a frozen copy of the port's
``nets/embedder.py``).

Identity concat + [sin(f·x), cos(f·x)] per log-spaced frequency f = 2^k,
k = 0..multires-1, each applied to the full input vector.
"""

from __future__ import annotations

import torch


def embed_dim(multires: int, input_dims: int = 3) -> int:
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """x: [..., d] -> [..., d*(1+2*multires)], ordered
    [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]."""
    if multires <= 0:
        return x
    feats = [x]
    for k in range(multires):
        xb = x * float(2.0 ** k)
        feats.append(torch.sin(xb))
        feats.append(torch.cos(xb))
    return torch.cat(feats, dim=-1)
