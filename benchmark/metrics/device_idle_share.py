"""device_idle_share (layer: device), in %: the share of the traced span
(the first device operation to the last, over the traced windows of
Runner.train, the runner's host work between windows included) that no
device operation covers. Busy time is the union of the operations'
intervals, never their sum."""


def read(ctx):
    if ctx.trace is None or ctx.trace.span_us <= 0:
        return None
    return 100.0 * ctx.trace.idle_share
