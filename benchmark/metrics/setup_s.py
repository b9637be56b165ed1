"""setup_s: seconds from the process's start to the first timed step:
imports, the build or cached load of the kernels, the scene, the seeded
weights, the first window (two eager warm-up steps, the capture of the
window's graph, its replays) and one window of the runner's host loop."""


def read(ctx):
    return ctx.setup_s
