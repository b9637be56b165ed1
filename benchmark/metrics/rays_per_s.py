"""rays_per_s: training rays completed over the measured window, batch x
steps over the seconds from the window's start to the synchronize after
its last step. Users feel it as GPU-hours per reconstructed scan."""


def read(ctx):
    return ctx.window["rays"] / ctx.window["seconds"]
