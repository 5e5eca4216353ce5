"""Straggler detection — a copy of `repro.ft.straggler` for the port:
per-step timing statistics with outlier flagging.

On a multi-host deployment each host feeds its local step wall time; the
report flags hosts whose EWMA exceeds the fleet median by `threshold`.
Mitigation hooks (the launcher wires these): emit a warning, exclude the
host from the next elastic re-mesh, or trigger an emergency checkpoint.
The single-host trainer exercises the same statistics on one stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerReport:
    step: int
    median_s: float
    slowest: Dict[str, float]     # host -> ewma seconds (only flagged hosts)
    flagged: bool


class StepTimer:
    def __init__(self, ewma_alpha: float = 0.2, threshold: float = 1.5):
        self.alpha = ewma_alpha
        self.threshold = threshold
        self.ewma: Dict[str, float] = {}
        self._t0: Optional[float] = None
        self.history: List[float] = []

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, host: str = "host0") -> float:
        dt = time.perf_counter() - self._t0
        prev = self.ewma.get(host, dt)
        self.ewma[host] = (1 - self.alpha) * prev + self.alpha * dt
        self.history.append(dt)
        return dt

    def observe(self, host_times: Dict[str, float]) -> None:
        """Feed one step's wall time per host (from an all-gather of times)."""
        for h, dt in host_times.items():
            prev = self.ewma.get(h, dt)
            self.ewma[h] = (1 - self.alpha) * prev + self.alpha * dt

    def report(self, step: int) -> StragglerReport:
        if not self.ewma:
            return StragglerReport(step, 0.0, {}, False)
        med = float(np.median(list(self.ewma.values())))
        slow = {h: t for h, t in self.ewma.items()
                if med > 0 and t > self.threshold * med}
        return StragglerReport(step, med, slow, bool(slow))
