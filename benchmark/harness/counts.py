"""The work of a training step, counted from the configuration's shapes.

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


def _pe_dim(multires: int, d: int) -> int:
    return d * (1 + 2 * multires) if multires > 0 else d


def udf_widths(u) -> List[Tuple[int, int]]:
    """(d_in, d_out) of every linear layer of the distance MLP, from
    ``model.udf_network`` {d_in, multires, d_hidden, n_layers, skip_in,
    d_out}: the embedding is d_in (1 + 2 multires) wide, and a layer before
    a skip gives d_hidden minus the embedding (it is re-injected)."""
    d0 = _pe_dim(u.multires, u.d_in)
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


def samples_per_ray(r) -> Dict[str, int]:
    """Samples a ray, from ``model.udf_renderer`` {n_samples, n_importance,
    up_sample_steps, upsampling_type, n_outside}: ``fg``, the foreground
    samples the distance op sees; ``valued``, the no-grad value
    evaluations of the up-sampling (the uniform samples, then each round's
    new ones but the last round's); ``nerf``, the background NeRF's samples
    (all foreground ones and the outside ones), 0 without a background."""
    if r.n_importance <= 0:
        fg, valued = r.n_samples, 0
    elif r.upsampling_type == "classical":
        per = r.n_importance // r.up_sample_steps
        fg = r.n_samples + per * r.up_sample_steps
        valued = r.n_samples + per * (r.up_sample_steps - 1)
    elif r.upsampling_type == "mix":
        per = r.n_importance // (r.up_sample_steps + 1)
        fg = r.n_samples + per * (r.up_sample_steps + 1)
        valued = r.n_samples + per * r.up_sample_steps
    else:
        raise ValueError(r.upsampling_type)
    return {"fg": fg, "valued": valued, "nerf": fg + r.n_outside if r.n_outside > 0 else 0}


def nerf_widths(nf) -> List[Tuple[int, int]]:
    """(d_in, d_out) of the NeRF++ layers, from ``model.nerf`` {d_in,
    multires, d_in_view, multires_view, D, W, skips}: D point layers with
    the embedding re-injected after each skip, the density head, the
    feature layer, the view layer and the colour head."""
    ch = _pe_dim(nf.multires, nf.d_in)
    ch_view = _pe_dim(nf.multires_view, nf.d_in_view)
    out = [(ch if i == 0 else (nf.W + ch if (i - 1) in nf.skips else nf.W), nf.W)
           for i in range(nf.D)]
    return out + [(nf.W, 1), (nf.W, nf.W), (nf.W + ch_view, nf.W // 2), (nf.W // 2, 3)]


def color_widths(rc) -> List[Tuple[int, int]]:
    """(d_in, d_out) of the two-stage colour net, from
    ``model.rendering_network`` {d_in, d_feature, d_hidden, n_layers,
    d_out, blending_cand_views, multires_view, mode}: the base stage reads
    the point and the feature, the main stage the view direction's
    embedding, the base colour and the base's last hidden layer, and adds
    the blending logits to its output."""
    base = [rc.d_in - 3 + rc.d_feature] + [rc.d_hidden] * rc.n_layers + [rc.d_out]
    main = [rc.d_hidden + rc.d_out + 3] + [rc.d_hidden] * rc.n_layers + [
        rc.d_out + rc.blending_cand_views]
    if rc.multires_view > 0 and rc.mode != "no_view_dir":
        main[0] += _pe_dim(rc.multires_view, 3) - 3
    return ([(base[i], base[i + 1]) for i in range(len(base) - 1)]
            + [(main[i], main[i + 1]) for i in range(len(main) - 1)])


def step_flops(cfg) -> Dict[str, float]:
    """Model operations of one training step, by part, and their ``total``:

    * ``upsampling``: the no-grad value passes of the up-sampling, the udf
      column only (``one_col``), batch x ``valued`` points;
    * ``K1``, ``K2``: the fused distance op and its backward at batch x
      ``fg`` rows (``fd_macs``);
    * ``nerf``: the background NeRF forward and backward at batch x
      ``nerf`` points; the backward is the weight cotangents of every
      layer and the input cotangents of every layer but the first (the
      embedding of fixed points needs none): 3x the forward less the first
      layer's input cotangent;
    * ``color``: the colour net forward and backward at batch x ``fg``
      points, 3x the forward (its inputs carry the distance field's
      feature, so every input cotangent is needed).

    Reads ``train.batch_size`` and the keys of the functions above."""
    batch = cfg.train.batch_size
    u, r = cfg.model.udf_network, cfg.model.udf_renderer
    s = samples_per_ray(r)
    fg_rows = batch * s["fg"]
    fd = fd_macs(u)
    out = {
        "upsampling": 2.0 * batch * s["valued"] * udf_passes(u)["one_col"],
        "K1": 2.0 * fg_rows * fd["K1"],
        "K2": 2.0 * fg_rows * fd["K2"],
        "nerf": 0.0,
        "color": 2.0 * fg_rows * 3 * sum(k * m for k, m in color_widths(
            cfg.model.rendering_network)),
    }
    if s["nerf"]:
        widths = nerf_widths(cfg.model.nerf)
        fwd = sum(k * m for k, m in widths)
        first_in = widths[0][0] * widths[0][1]
        out["nerf"] = 2.0 * batch * s["nerf"] * (3 * fwd - first_in)
    out["total"] = sum(out.values())
    return out


def fd_rows(cfg) -> int:
    """Rows the distance op sees a step: batch x foreground samples."""
    return cfg.train.batch_size * samples_per_ray(cfg.model.udf_renderer)["fg"]


def roofline_s(flops: float, nbytes: float, tier: str) -> float:
    """The least time the chip needs: the larger of the operations over the
    tier's peak and the bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[tier], nbytes / PEAK_BYTES)
