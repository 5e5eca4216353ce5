"""Flight recorder: a bounded ring of the engine's recent steps, dumped
to JSON when something goes wrong — a copy of `repro.serving.recorder` for
the port.

Production incidents on a serving replica usually leave nothing behind:
the process dies (crash), a unit retires (Hamun-style stuck-at fault),
or an SLO burns — and the postmortem summary only says *that* it
happened, not what the steps leading up to it looked like.  The
`FlightRecorder` keeps the last N `StepRecord`s + the trace events and
`health()` snapshot of each step in a `deque` ring, and `trigger()`
writes the whole ring as one deterministic JSON document on:

- fault retirement (`slot_retired` / `page_retired`, engine-detected),
- SLO breach transitions (forwarded from the `SLOTracker`),
- a watchdog-suspected stall (`stall_suspected`),
- SIGUSR1 (`install_signal_handler`), and
- an unhandled exception (`install_excepthook`).

Dumps are canonical JSON (sorted keys, NaN scrubbed), so under
`VirtualClock` two identical runs produce byte-identical dump files —
pinned in tests.  The recorder is pure observation: it never feeds a
value back into scheduling, so enabling it is token-identical.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import signal
import sys
from typing import Deque, List, Optional

from repro_torch.serving.telemetry import dumps_deterministic
from repro_torch.serving.tracing import NULL_TRACER


class FlightRecorder:
    """Bounded ring of per-step engine state with triggered JSON dumps.

    `steps` bounds the ring (and therefore memory); `max_dumps` bounds
    how many dump files one run can write, so a breach storm cannot
    fill a disk.  The engine injects its tracer (`recorder.tracer = ...`)
    so each ring entry carries exactly the trace events its step
    produced."""

    def __init__(self, steps: int = 256, *, out_dir: str = ".",
                 prefix: str = "flight", max_dumps: int = 8):
        if steps < 1:
            raise ValueError(f"ring must hold >= 1 step, got {steps}")
        self.steps = int(steps)
        self.out_dir = out_dir
        self.prefix = prefix
        self.max_dumps = int(max_dumps)
        self.tracer = NULL_TRACER          # engine injects its tracer
        self.dumps: List[str] = []         # paths written, in order
        self.triggers: List[dict] = []     # every trigger, capped or not
        self._ring: Deque[dict] = collections.deque(maxlen=self.steps)
        self._ev_idx = 0                   # tracer.events consumed so far

    # ------------------------------------------------------------ ring
    def record_step(self, step_no: int, record, health: dict) -> None:
        """Append one step to the ring.  `record` is the step's
        `StepRecord`; `health` the engine's `health()` snapshot."""
        entry = {"step": step_no,
                 "record": dataclasses.asdict(record),
                 "health": health}
        if self.tracer.enabled:
            self._ev_idx, tail = self.tracer.events_since(self._ev_idx)
            entry["events"] = list(tail)
        self._ring.append(entry)

    def __len__(self) -> int:
        return len(self._ring)

    # ---------------------------------------------------------- dumps
    def doc(self, reason: str, step: Optional[int] = None,
            **attrs) -> dict:
        return {"version": 1, "reason": reason, "trigger_step": step,
                "attrs": attrs, "n_entries": len(self._ring),
                "ring_steps": self.steps, "entries": list(self._ring)}

    def trigger(self, reason: str, step: Optional[int] = None,
                **attrs) -> Optional[str]:
        """Dump the ring; returns the path written, or None once
        `max_dumps` is reached (the trigger is still logged)."""
        self.triggers.append({"reason": reason, "step": step, **attrs})
        if len(self.dumps) >= self.max_dumps:
            return None
        name = f"{self.prefix}-{len(self.dumps):03d}-{reason}.json"
        path = os.path.join(self.out_dir, name)
        text = dumps_deterministic(self.doc(reason, step, **attrs))
        with open(path, "w", encoding="utf-8") as f:
            f.write(text + "\n")
        self.dumps.append(path)
        if self.tracer.enabled:
            # basename only: keeps traces (and later ring entries, which
            # embed these events) byte-identical across output directories
            self.tracer.instant("flight_dump", reason=reason, file=name)
        return path

    # ------------------------------------------------- process hooks
    def install_signal_handler(self, signum: int = signal.SIGUSR1) -> None:
        """SIGUSR1 -> dump: `kill -USR1 <pid>` snapshots a live replica
        without stopping it.  Main-thread only (signal module rule)."""

        def _on_signal(_sig, _frame):
            self.trigger("sigusr1")

        signal.signal(signum, _on_signal)

    def install_excepthook(self) -> None:
        """Dump on an unhandled exception, then chain to the previous
        excepthook so default traceback printing still happens."""
        prev = sys.excepthook

        def _hook(exc_type, exc, tb):
            try:
                self.trigger("crash", error=repr(exc))
            finally:
                prev(exc_type, exc, tb)

        sys.excepthook = _hook
