"""The cells' initial weights, made on the device from the run's seed.

A model lists its linear layers (``models/<m>.py`` ``layers``), and
``init_layers`` draws them the published way: the geometric sphere init of
a distance MLP (``kind`` 'geometric'), PyTorch's default elsewhere, weight
norm with ``g = ||v||`` where a layer has it. Every draw comes from one
``torch.Generator`` on the device in two calls, one buffer of normal draws
and one of uniform draws for every layer, sliced layer by layer. The same
tensors go to the port (copied into its parameters) and to the plain
reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from .check import put

Params = Dict[str, Any]


def init_layers(layers: List[Tuple[tuple, str, int, int, dict]], seed: int, device) -> Params:
    """The layers (path, kind, d_in, d_out, extra), in their order, as plain
    tensors on ``device``. A geometric layer's ``extra`` gives its ``layer``
    index, the net's ``num_layers``, its embedding width ``d0``,
    ``multires``, ``skip_in``, ``bias`` and ``inside_outside``; ``wn`` a
    weight-normed layer."""
    n_normal = sum(d_in * d_out for _, kind, d_in, d_out, _ in layers if kind == "geometric")
    n_uniform = sum(d_in * d_out + d_out for _, kind, d_in, d_out, _ in layers
                    if kind == "default")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn((max(n_normal, 1),), generator=gen, device=device)
    uniform = torch.rand((max(n_uniform, 1),), generator=gen, device=device) * 2.0 - 1.0
    params: Params = {}
    pn = pu = 0
    for path, kind, d_in, d_out, ex in layers:
        if kind == "geometric":
            z = normal[pn:pn + d_in * d_out].reshape(d_in, d_out)
            pn += d_in * d_out
            l, num_layers, d0 = ex["layer"], ex["num_layers"], ex["d0"]
            std = math.sqrt(2) / math.sqrt(d_out)
            b = torch.zeros((d_out,), device=device)
            if l == num_layers - 2:  # last layer: mean-shifted normal, -bias
                mean = math.sqrt(math.pi) / math.sqrt(d_in)
                mean, bias_val = ((-mean, ex["bias"]) if ex["inside_outside"]
                                  else (mean, -ex["bias"]))
                w = mean + 0.0001 * z
                b = torch.full((d_out,), bias_val, device=device)
            elif ex["multires"] > 0 and l == 0:  # identity-xyz rows only
                w = torch.zeros((d_in, d_out), device=device)
                w[:3] = z[:3] * std
            elif ex["multires"] > 0 and l in ex["skip_in"]:  # the re-injected PE rows at zero
                w = z * std
                w[-(d0 - 3):] = 0.0
            else:
                w = z * std
        else:
            bound = 1.0 / math.sqrt(d_in)
            w = uniform[pu:pu + d_in * d_out].reshape(d_in, d_out) * bound
            pu += d_in * d_out
            b = uniform[pu:pu + d_out] * bound
            pu += d_out
        leaf = ({"v": w.contiguous(), "g": torch.linalg.vector_norm(w, dim=0), "b": b.clone()}
                if ex.get("wn") else {"w": w.contiguous(), "b": b.clone()})
        put(params, path, leaf)
    return params


def scalar(value: float, device) -> torch.Tensor:
    """A configured scalar parameter, shape [1]."""
    return torch.full((1,), float(value), device=device)
