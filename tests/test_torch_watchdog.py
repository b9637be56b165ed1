"""The port's StallWatchdog (``neuraludf_tpu_torch/utils/watchdog.py``):
it fires after warn_s of silence, beat() resets it, and it re-warns per
additional warn_s, not per poll (counterparts of tests/test_watchdog.py,
with timers of tenths of a second)."""

import time

from neuraludf_tpu_torch.utils.watchdog import StallWatchdog


def test_watchdog_fires_and_resets():
    warns = []
    wd = StallWatchdog(warn_s=0.3, tag_fn=lambda: "iter 42",
                       on_warn=lambda s, tag: warns.append((s, tag)), poll_s=0.05).start()
    try:
        # heartbeats keep it quiet
        for _ in range(4):
            time.sleep(0.1)
            wd.beat()
        assert warns == []

        # silence: one warning per warn_s of stall
        time.sleep(0.45)
        assert len(warns) == 1
        assert warns[0][0] >= 0.3
        assert warns[0][1] == "iter 42"

        # a beat resets it; no immediate warning again
        wd.beat()
        time.sleep(0.15)
        assert len(warns) == 1
    finally:
        wd.stop()


def test_watchdog_disabled():
    def fail(s, tag):
        raise AssertionError("must not warn")

    wd = StallWatchdog(warn_s=0, on_warn=fail, poll_s=0.01).start()
    time.sleep(0.1)
    wd.stop()


def test_watchdog_rewarns_each_period():
    warns = []
    wd = StallWatchdog(warn_s=0.2, on_warn=lambda s, t: warns.append(s), poll_s=0.05).start()
    try:
        time.sleep(0.7)
        assert len(warns) >= 2  # at ~0.2 s and ~0.4 s (poll jitter tolerated)
    finally:
        wd.stop()
