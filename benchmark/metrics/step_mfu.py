"""step_mfu (layer: device, the whole step), in %: the step's model
operations (the model's ``step_flops``, ``models/<m>.py``; NeuralUDF's:
the up-sampling value passes, K1, K2, the background NeRF and the colour
net with their backward, each multiply-add 2 operations, counted once
whatever the tier; times the
workload's ``scans`` in a campaign, whose step is an iteration of every
scan) over the step time of the measured, unprofiled window times the H100
SXM's dense bf16 peak, 989 TFLOP/s (the ``default`` tier's operand type).
It still bounds a gain after a later change has taken a kernel off the
path."""

from harness import counts


def read(ctx):
    flops = ctx.model.step_flops(ctx.cfg)["total"] * ctx.cell.workload.get("scans", 1)
    return 100.0 * flops / (ctx.step_s * counts.PEAK_BF16)
