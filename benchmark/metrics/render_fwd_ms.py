"""render_fwd_ms (layer: renderer and nets), in ms: device milliseconds a
step of the kernels launched under the step's spans ``step.sample``,
``step.render`` and ``step.loss``, less those under the ops' spans
(``op.fd_fwd``: the fused distance op, K1; ``op.strip_sample``: K3), over
EAGER_STEPS eager steps of ``Runner.train`` under the profiler
(``harness.spans``, run (B)). A kernel goes to the innermost span that
holds its launch."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx, ("step.sample", "step.render", "step.loss"))
