"""metric_wait_ms (layer: runner), in ms: host milliseconds a step blocked in
``runner.fetch``, the transfer of a window's metric rows to the host, which
waits for the window's last step on the device (``harness.spans``, run
(A)). Near 0, the host, not the device, sets the pace."""

from harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("runner.fetch",), "total")
