"""kernels_per_step (layer: training window): device operations a replayed
step runs (kernels, and the copies and fills the device runs; in a
campaign a step is an iteration of every scan), counted by torch.profiler
over the traced windows of Runner.train (MultiScanRunner.train). Fusing the
renderer's chain and the casts lowers it."""


def read(ctx):
    if ctx.trace is None or ctx.trace.n_device_ops == 0:
        return None
    return ctx.trace.n_device_ops / ctx.profiled_steps
