"""render_bwd_ms (layer: renderer and nets), in ms: as render_fwd_ms, the
kernels of the backward pass (span ``step.grad``, on the caller's and on
autograd's threads), less the fused op's backward (``op.fd_bwd``: K2)."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx, ("step.grad",))
