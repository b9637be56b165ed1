"""runner_idle_share (layer: runner), in %: the device's idle time in one
profiled window of ``Runner.train`` (``harness.spans``, run (B): the host
span of its ``runner.window``, less the union of the device operations in
it) that waits on the runner's own spans (``runner.*``: its self time, the
schedules, the fetch, the log, the periodic actions), over that window. An
idle stretch whose next operation had not been launched when it began goes
to the innermost span on the main thread through its middle; one whose next
operation had been, or shares its launch with the one before it (inside one
replayed graph), is the device's own, and one whose middle falls in the
profiler's buffer request is the profiler's: neither is counted."""

from harness import spans


def read(ctx):
    return spans.idle_share(ctx, "runner")
