"""Stall watchdog (counterpart of ``neuraludf_tpu/utils/watchdog.py``).

A training process whose device work stops completing (a hung kernel, a
lost card, a deadlocked collective) blocks its host thread in the next
device-to-host transfer and says nothing. A thread cannot unblock it, but it
can say that the run is stuck, since when and at what iteration, so that an
operator or a wrapper script can look at the card and resume from the latest
checkpoint (a resumed run continues the same random stream).
``Runner.train`` beats it once per training window.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)


class StallWatchdog:
    """Warn (repeatedly) when `beat()` hasn't been called for `warn_s`.

    Usage:
        wd = StallWatchdog(warn_s=600, tag_fn=lambda: f"iter {step}")
        wd.start()
        try:
            for ...:
                dispatch(); wd.beat()
        finally:
            wd.stop()
    """

    def __init__(
        self,
        warn_s: float,
        tag_fn: Optional[Callable[[], str]] = None,
        on_warn: Optional[Callable[[float, str], None]] = None,
        poll_s: Optional[float] = None,
    ) -> None:
        self.warn_s = float(warn_s)
        self._tag_fn = tag_fn or (lambda: "")
        self._on_warn = on_warn or self._default_warn
        self._poll_s = poll_s if poll_s is not None else min(60.0, self.warn_s / 4)
        self._stop = threading.Event()
        self._last = time.monotonic()
        self._warned_at = 0.0  # stall length at the last warning
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_warn(stalled_s: float, tag: str) -> None:
        log.warning(
            "no training window has finished for %.0f s%s: the device work may "
            "be hung. Check the card from a new process; if it answers, kill "
            "this one and resume from the latest checkpoint.",
            stalled_s, f" ({tag})" if tag else "",
        )

    def beat(self) -> None:
        self._last = time.monotonic()
        self._warned_at = 0.0

    def start(self) -> "StallWatchdog":
        if self.warn_s <= 0:  # disabled
            return self
        self._thread = threading.Thread(
            target=self._run, name="stall-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._poll_s + 1.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            stalled = time.monotonic() - self._last
            # re-warn each additional warn_s of stall, not every poll
            if stalled >= self.warn_s and stalled - self._warned_at >= self.warn_s:
                self._warned_at = stalled
                try:
                    tag = self._tag_fn()
                except Exception:  # the tag must never kill the watchdog
                    tag = "?"
                self._on_warn(stalled, tag)
