"""periodic_device_s.validate (layer: runner), in s: the union of the device
operations' intervals of the validation render (``Runner.validate``) in the
profiled crossing of a traced run (``main.profile_crossing``). None where
the run profiled no crossing, or the action ran no device operation."""


def read(ctx):
    action = (ctx.crossing or {}).get("validate")
    return action["device_s"] if action and action["ops"] else None
