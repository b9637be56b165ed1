"""periodic_host_s.extract_udf_mesh (layer: runner), in s: the host seconds of
the MeshUDF mesh (``Runner.extract_udf_mesh``) in the profiled crossing of a
traced run (``main.profile_crossing``: synchronized at both ends, under the
profiler). None where the run profiled no crossing."""


def read(ctx):
    action = (ctx.crossing or {}).get("extract_udf_mesh")
    return action["host_s"] if action else None
