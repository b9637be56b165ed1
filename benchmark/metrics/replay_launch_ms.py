"""replay_launch_ms (layer: training window), in ms: host milliseconds a step
that launching the step's CUDA graph (span ``window.replay``) takes into a
queue with room: the shortest replay times the replays, over the steps
(``harness.spans``, run (A)). What the replays take beyond it is the host
waiting for the device's queue, which reads the device's time, not the
launch's; the readers' ``spans`` line prints both."""

from harness import spans


def read(ctx):
    return spans.host_ms(ctx, ("window.replay",), "work")
