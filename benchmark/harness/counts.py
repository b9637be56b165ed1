"""The work of the networks a model shares, counted from their shapes: the
distance MLP under the fused distance op (K1, K2) and the NeRF++
background. A model's whole step is counted in its module
(``models/<m>.py``: ``step_flops``, ``fd_rows``) from these.

Every count is of the algorithm's work, 2 operations per multiply-add of a
matrix product at the published (unpadded) widths, counted once whatever
precision tier runs it: the extra passes that the ``high`` (bf16x3) or
``highest`` (3xTF32) tiers make of a product are how a tier computes, not
work, so a roofline or MFU read against this count measures the
implementation. Left out: elementwise work (activations, the renderer's
compositing, the losses, the projector's warps), Adam's update, reductions,
sorting and the sampler K3, all of them far below the products' share of
operations. The conf keys each count reads are named in its docstring.

Peaks are the published dense figures of one H100 SXM (NVIDIA's data
sheet, at the 700 W power limit): 989 TFLOP/s in bf16 on the tensor cores,
the ``default`` tier's operand type; 67 TFLOP/s in f32 on the CUDA cores,
the price of ``highest``'s function; 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_FLOPS = {"default": 989e12, "high": 989e12, "highest": 67e12}
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
F32 = 4


def pe_dim(multires: int, d: int) -> int:
    return d * (1 + 2 * multires) if multires > 0 else d


def udf_widths(u) -> List[Tuple[int, int]]:
    """(d_in, d_out) of every linear layer of the distance MLP, from
    ``model.udf_network`` {d_in, multires, d_hidden, n_layers, skip_in,
    d_out}: the embedding is d_in (1 + 2 multires) wide, and a layer before
    a skip gives d_hidden minus the embedding (it is re-injected)."""
    d0 = pe_dim(u.multires, u.d_in)
    dims = [d0] + [u.d_hidden] * u.n_layers + [u.d_out]
    return [(dims[l], dims[l + 1] - d0 if (l + 1) in u.skip_in else dims[l + 1])
            for l in range(u.n_layers + 1)]


def udf_passes(u) -> Dict[str, int]:
    """Multiply-adds a point of the distance MLP's passes: ``full`` (every
    output column), ``one_col`` (the head's udf column only: a value pass,
    or a pass seeded by the head's cotangent on the udf), ``no_col`` (the
    head not read: the tangent of an ``abs`` head)."""
    widths = udf_widths(u)
    full = sum(k * m for k, m in widths)
    head_in, head_out = widths[-1]
    return {"full": full, "one_col": full - head_in * head_out + head_in,
            "no_col": full - head_in * head_out}


def fd_macs(u) -> Dict[str, int]:
    """Multiply-adds a point of K1 and K2, the fused distance op and its
    second-order backward. K1: the forward pass (udf, feature) and the
    gradient sweep seeded at the udf column. K2: the primal and tangent
    forward passes, the reverse sweeps of the primal and tangent
    cotangents, and the two weight cotangents (``udf_type`` picks whether
    the tangent reads the head: only ``square`` does)."""
    p = udf_passes(u)
    tangent = p["one_col"] if u.udf_type == "square" else p["no_col"]
    k1 = p["full"] + p["one_col"]
    k2 = (p["full"] + tangent) + (p["one_col"] + p["full"]) + (p["full"] + p["one_col"])
    return {"K1": k1, "K2": k2}


def udf_weights(u) -> int:
    """True weights and biases of the distance MLP."""
    return sum(k * m + m for k, m in udf_widths(u))


def fd_bytes(u, rows: int) -> Dict[str, int]:
    """Bytes K1 and K2 must move at ``rows`` points, each input read once
    and each output written once, in f32: K1 reads x [rows, 3] and the
    weights and writes (udf, feature, gradient) [rows, d_out + 3]; K2 reads
    x and the three cotangents [rows, 1 + (d_out - 1) + 3] and the weights,
    and writes x̄ [rows, 3] and the weight cotangents."""
    n_w = udf_weights(u) * F32
    x = rows * 3 * F32
    k1 = x + n_w + rows * (u.d_out + 3) * F32
    k2 = x + rows * (u.d_out + 3) * F32 + n_w + x + n_w
    return {"K1": k1, "K2": k2}


def nerf_widths(nf) -> List[Tuple[int, int]]:
    """(d_in, d_out) of the NeRF++ layers, from ``model.nerf`` {d_in,
    multires, d_in_view, multires_view, D, W, skips}: D point layers with
    the embedding re-injected after each skip, the density head, the
    feature layer, the view layer and the colour head."""
    ch = pe_dim(nf.multires, nf.d_in)
    ch_view = pe_dim(nf.multires_view, nf.d_in_view)
    out = [(ch if i == 0 else (nf.W + ch if (i - 1) in nf.skips else nf.W), nf.W)
           for i in range(nf.D)]
    return out + [(nf.W, 1), (nf.W, nf.W), (nf.W + ch_view, nf.W // 2), (nf.W // 2, 3)]


def roofline_s(flops: float, nbytes: float, tier: str) -> float:
    """The least time the chip needs: the larger of the operations over the
    tier's peak and the bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[tier], nbytes / PEAK_BYTES)
