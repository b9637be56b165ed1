"""window_idle_share (layer: training window), in %: as runner_idle_share,
the device's idle that waits on the training window's host work (spans
``window.call``, ``window.draws``, ``window.replay``). Gaps between the
kernels of one replayed graph, and gaps whose next operation was already
launched, as between replays while the host runs ahead, are the device's
own and not counted,
nor is idle while the profiler takes its buffers."""

from harness import spans


def read(ctx):
    return spans.idle_share(ctx, "window")
