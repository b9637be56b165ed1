"""runner_host_ms (layer: runner), in ms: host milliseconds a step that
``Runner.train`` spends outside the training window, the fetch and the
periodic actions: the self time of the span ``runner.window`` plus
``runner.schedules`` (views, schedules, their rows to the device) and
``runner.log`` (the JSONL rows, ``_post_step_host``), over one window of
``Runner.train`` with the port's spans on and no profiler
(``harness.spans``, run (A)). Only from a window that replayed every unit."""

from harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("runner.window", "runner.schedules", "runner.log"))
