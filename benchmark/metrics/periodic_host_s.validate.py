"""periodic_host_s.validate (layer: runner), in s: the host seconds of the
validation render (``Runner.validate``) in the profiled crossing of a traced
run (``main.profile_crossing``: synchronized at both ends, under the
profiler). None where the run profiled no crossing."""


def read(ctx):
    action = (ctx.crossing or {}).get("validate")
    return action["host_s"] if action else None
