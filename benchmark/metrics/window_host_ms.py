"""window_host_ms (layer: training window), in ms: host milliseconds a step
of ``TrainWindow.__call__``'s own work besides the graph's launch: the
draws and their staging into the graph's buffers (span ``window.draws``,
its shortest call times its calls, so that waits for the device's queue
are left out) and the rest of the call (``window.call``'s self time: the
graph's binding check and the metric rows' copy) (``harness.spans``, run
(A))."""

from harness import spans


def read(ctx):
    draws = spans.host_ms(ctx, ("window.draws",), "work")
    call = spans.host_ms(ctx, ("window.call",), "self")
    return None if draws is None or call is None else draws + call
