"""The cells' initial weights, made on the device from the run's seed.

The init is the published one (the geometric sphere init of the distance
MLP, PyTorch's default for the colour net and the background NeRF, weight
norm with ``g = ||v||``, the configured scalars), drawn from one
``torch.Generator`` on the device in two calls: one buffer of normal draws
and one of uniform draws for every leaf, sliced leaf by leaf. The same
tensors go to the port (copied into its parameters) and to the plain
reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from reference.embedder import embed_dim
from reference.fields import _residual_dims, distance_dims

from .check import put

Params = Dict[str, Any]


def _layers(cfg) -> List[Tuple[tuple, str, int, int, dict]]:
    """(path, kind, d_in, d_out, extra) of every linear layer, in a fixed
    order. kind is 'geometric' or 'default'."""
    out = []
    u = cfg.model.udf_network
    dims, d0 = distance_dims(u)
    n = len(dims)
    for l in range(n - 1):
        d_out = dims[l + 1] - dims[0] if (l + 1) in u.skip_in else dims[l + 1]
        kind = "geometric" if u.geometric_init else "default"
        out.append((("udf", f"lin{l}"), kind, dims[l], d_out,
                    {"layer": l, "num_layers": n, "d0": d0, "wn": u.weight_norm}))
    r = cfg.model.rendering_network
    dims_base, dims_main = _residual_dims(r)
    for key, ds in (("main", dims_main), ("base", dims_base)):
        for l in range(len(ds) - 1):
            out.append((("color", key, f"lin{l}"), "default", ds[l], ds[l + 1],
                        {"wn": r.weight_norm}))
    nf = cfg.model.nerf
    input_ch = embed_dim(nf.multires, nf.d_in) if nf.multires > 0 else 3
    input_ch_view = embed_dim(nf.multires_view, nf.d_in_view) if nf.multires_view > 0 else 3
    for i in range(nf.D):
        d_in = input_ch if i == 0 else (nf.W + input_ch if (i - 1) in nf.skips else nf.W)
        out.append((("nerf", "pts", f"lin{i}"), "default", d_in, nf.W, {}))
    out.append((("nerf", "views", "lin0"), "default", input_ch_view + nf.W, nf.W // 2, {}))
    out.append((("nerf", "feature"), "default", nf.W, nf.W, {}))
    out.append((("nerf", "alpha"), "default", nf.W, 1, {}))
    out.append((("nerf", "rgb"), "default", nf.W // 2, 3, {}))
    return out


def init_weights(cfg, seed: int, device) -> Params:
    """Every parameter of the step, as plain tensors on ``device``."""
    layers = _layers(cfg)
    n_normal = sum(d_in * d_out for _, kind, d_in, d_out, _ in layers if kind == "geometric")
    n_uniform = sum(d_in * d_out + d_out for _, kind, d_in, d_out, _ in layers
                    if kind == "default")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn((max(n_normal, 1),), generator=gen, device=device)
    uniform = torch.rand((max(n_uniform, 1),), generator=gen, device=device) * 2.0 - 1.0
    u = cfg.model.udf_network
    inside_outside = u.udf_type == "sdf" and u.inside_outside
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
                mean, bias_val = (-mean, u.bias) if inside_outside else (mean, -u.bias)
                w = mean + 0.0001 * z
                b = torch.full((d_out,), bias_val, device=device)
            elif u.multires > 0 and l == 0:  # identity-xyz rows only
                w = torch.zeros((d_in, d_out), device=device)
                w[:3] = z[:3] * std
            elif u.multires > 0 and l in u.skip_in:  # the re-injected PE rows at zero
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
    one = lambda v: torch.full((1,), float(v), device=device)
    params["variance"] = {"variance": one(cfg.model.variance_network.init_val)}
    bc = cfg.model.beta_network
    params["beta"] = {"beta": one(bc.init_var_beta), "gamma": one(bc.init_var_gamma),
                      "zeta": one(bc.init_var_zeta)}
    return params
