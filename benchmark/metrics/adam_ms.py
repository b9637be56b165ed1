"""adam_ms (layer: training window), in ms: as render_fwd_ms, the kernels of
the Adam update (span ``step.adam``)."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx, ("step.adam",))
