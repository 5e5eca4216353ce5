"""Step watchdog — a copy of `repro.ft.watchdog` for the port: detects a hung
step (dead collective / lost host) and runs an emergency action (checkpoint
+ abort) so the job can be rescheduled instead of burning the reservation.

Usage:
    wd = Watchdog(timeout_s=600, on_timeout=emergency_checkpoint)
    for step in ...:
        with wd.armed(step):
            run_step()

The serving engine arms the same watchdog as a per-step heartbeat
(`ServingEngine(stall_timeout_s=...)`): a step that overruns the deadline
fires `stall_suspected` telemetry + a flight-recorder dump while the step
keeps running — on the serving side the watchdog observes, never kills.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional


class Watchdog:
    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[int], None]] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.fired = False
        self.fires = 0                       # lifetime deadline misses
        self.fired_step: Optional[int] = None   # most recent missed step
        self._timer: Optional[threading.Timer] = None

    def _fire(self, step: int) -> None:
        self.fired = True
        self.fires += 1
        self.fired_step = step
        if self.on_timeout is not None:
            self.on_timeout(step)

    @contextlib.contextmanager
    def armed(self, step: int):
        self._timer = threading.Timer(self.timeout_s, self._fire, args=(step,))
        self._timer.daemon = True
        self._timer.start()
        try:
            yield
        finally:
            self._timer.cancel()
