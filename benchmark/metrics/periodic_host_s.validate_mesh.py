"""periodic_host_s.validate_mesh (layer: runner), in s: the host seconds of the
classic mesh (``Runner.validate_mesh``) in the profiled crossing of a traced
run (``main.profile_crossing``: synchronized at both ends, under the
profiler). None where the run profiled no crossing."""


def read(ctx):
    action = (ctx.crossing or {}).get("validate_mesh")
    return action["host_s"] if action else None
