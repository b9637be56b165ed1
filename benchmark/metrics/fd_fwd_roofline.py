"""fd_fwd_roofline (layer: ops and kernels), in %: the least time the chip
needs for the fused distance op's forward work (K1) at the cell's rows, the
larger of its operations over the tier's peak and its bytes over 3.35 TB/s
(``harness.counts``), over the measured time of the port's op entry
``distance_value_feat_grad_fused`` (CUDA events around a CUDA graph of
warm calls, as the window runs the op: no host gap between launches; the
runner's parameters and tier). It reads the same work whatever implements
the op."""

from harness import counts


def read(ctx):
    u = ctx.model.distance_cfg(ctx.cfg)
    rows = ctx.model.fd_rows(ctx.cfg)
    least = counts.roofline_s(2.0 * rows * counts.fd_macs(u)["K1"],
                              counts.fd_bytes(u, rows)["K1"], u.fused_precision)
    return 100.0 * least / (ctx.fd_op_ms()["fwd"] / 1e3)
