"""k3_path_ms (layer: ops and kernels), in ms: as render_fwd_ms, the kernels
under K3's entry on its CUDA path (span ``op.strip_sample``: the layout
copy of the source views and the sampler); a blending cell's."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx, ("op.strip_sample",))
