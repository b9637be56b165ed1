"""periodic_busy_share (layer: runner), in %: the share of the runner's
periodic actions' host seconds in which the device ran an operation, over
the profiled crossing of a traced run (``main.profile_crossing``: the
actions run once more after the traced windows, each under a profiler of its
own; busy time is the union of each action's device operations' intervals,
never their sum). None where the run profiled no crossing, or the device ran
nothing in it."""


def read(ctx):
    actions = (ctx.crossing or {}).values()
    if not actions or not sum(a["ops"] for a in actions):
        return None
    return 100.0 * sum(a["device_s"] for a in actions) / sum(a["host_s"] for a in actions)
