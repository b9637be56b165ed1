"""fd_bwd_roofline (layer: ops and kernels), in %: as fd_fwd_roofline, for
the op's second-order backward (K2), timed around the autograd backward of
``distance_value_feat_grad_fused`` with cotangents on all three outputs."""

from harness import counts


def read(ctx):
    u = ctx.model.distance_cfg(ctx.cfg)
    rows = ctx.model.fd_rows(ctx.cfg)
    least = counts.roofline_s(2.0 * rows * counts.fd_macs(u)["K2"],
                              counts.fd_bytes(u, rows)["K2"], u.fused_precision)
    return 100.0 * least / (ctx.fd_op_ms()["bwd"] / 1e3)
