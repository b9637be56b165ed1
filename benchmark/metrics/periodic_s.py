"""periodic_s (layer: runner), in s: the seconds that the runner's periodic
actions add to the measured window (``Runner._periodic_actions`` at a
multiple of ``val_freq`` and ``val_mesh_freq``: the validation render, the
classic mesh and the MeshUDF mesh): the time of each runner window that ran
them less the median time of the measured window's other runner windows,
from the window ends of the same run (``ctx.ends``, ``ctx.crossed``). None
where no window, or every window, ran them."""

import statistics


def read(ctx):
    if not any(ctx.crossed) or all(ctx.crossed):
        return None
    times = [b - a for a, b in zip([0.0] + ctx.ends[:-1], ctx.ends)]
    plain = statistics.median(t for t, c in zip(times, ctx.crossed) if not c)
    return sum(t - plain for t, c in zip(times, ctx.crossed) if c)
