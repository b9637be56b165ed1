"""periodic_device_s.validate_mesh (layer: runner), in s: the union of the
device operations' intervals of the classic mesh (``Runner.validate_mesh``)
in the profiled crossing of a traced run (``main.profile_crossing``). None
where the run profiled no crossing, or the action ran no device operation."""


def read(ctx):
    action = (ctx.crossing or {}).get("validate_mesh")
    return action["device_s"] if action and action["ops"] else None
