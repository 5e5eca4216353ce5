"""Structured tracing for the serving engine.

The :class:`Tracer` records two kinds of structured events:

* **Component spans** — per-step timings of engine phases (``schedule``,
  ``prefill``, ``decode``, ``sample``, ``install``, ``page``, ``prefix``,
  ``bookkeep``).  The engine drains the per-step accumulation via
  :meth:`Tracer.step_components` and stores it on ``StepRecord.component_s``.
* **Request lifecycle spans** — one span per scheduling phase of each
  request (``queued`` → ``prefilling`` → ``running`` → ``finished`` /
  ``preempted``), driven by :meth:`Tracer.request_phase`.

Both are clocked by an injectable ``clock`` callable.  Pass a
``VirtualClock`` (see :mod:`repro_torch.serving.metrics`) to make traces from
``drive_simulated`` runs fully deterministic — the virtual clock only
advances between steps, so two identical runs produce byte-identical
trace files.  Pass ``time.perf_counter`` (the default) for real wall-time
breakdowns.

Export is Chrome-trace-format JSON (the ``traceEvents`` array form),
loadable in ``chrome://tracing`` or https://ui.perfetto.dev.  Component
spans live under pid 0 with one tid per component; request lifecycle
spans live under pid 1 with one tid per request id.

When tracing is disabled use :data:`NULL_TRACER`: every method is a
no-op that allocates no event objects, so instrumented code paths can
call it unconditionally.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "TRACE_COMPONENTS",
    "REQUEST_PHASES",
]

# Canonical component names, in display order.  The engine may emit spans
# for any subset per step; consumers should treat missing components as 0.
TRACE_COMPONENTS: Tuple[str, ...] = (
    "schedule",
    "install",
    "prefill",
    "decode",
    "sample",
    "page",
    "prefix",
    "bookkeep",
)

# Request lifecycle phases.  ``finished`` / ``preempted`` / ``rejected``
# are terminal markers: they close the current span without opening one.
REQUEST_PHASES: Tuple[str, ...] = (
    "queued",
    "prefilling",
    "running",
    "finished",
    "preempted",
    "rejected",
)

_TERMINAL_PHASES = frozenset(("finished", "rejected"))


class _NullSpan:
    """Reusable no-op context manager shared by every NullTracer call."""

    __slots__ = ()

    def __enter__(self):  # pragma: no cover - trivial
        return self

    def __exit__(self, *exc):  # pragma: no cover - trivial
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every method is a cheap no-op.

    All methods return shared singletons and allocate nothing, so leaving
    instrumentation calls in hot paths is free when tracing is off.  Use
    the module-level :data:`NULL_TRACER` instance rather than constructing
    new ones.
    """

    __slots__ = ()

    enabled = False

    def span(self, component: str, **attrs):
        return _NULL_SPAN

    def instant(self, name: str, **attrs) -> None:
        return None

    def counter(self, name: str, value: float, **attrs) -> None:
        return None

    def request_phase(self, rid: str, phase: str, **attrs) -> None:
        return None

    def step_components(self) -> Dict[str, float]:
        return {}

    def events_since(self, index: int):
        return 0, []

    def request_timeline(self, rid: str) -> str:
        return ""

    def export_chrome_trace(self, path: str) -> None:  # pragma: no cover
        raise RuntimeError("tracing is disabled; no events to export")


NULL_TRACER = NullTracer()


class _Span:
    """Context manager recording one component span on exit."""

    __slots__ = ("_tracer", "_component", "_attrs", "_t0")

    def __init__(self, tracer: "Tracer", component: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self._component = component
        self._attrs = attrs
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        self._tracer._end_span(self._component, self._t0, self._attrs)
        return False


class Tracer:
    """Structured event recorder with Chrome-trace JSON export.

    Parameters
    ----------
    clock:
        0-arg callable returning seconds.  Defaults to
        ``time.perf_counter``.  Pass a ``VirtualClock`` for deterministic
        traces from simulated runs.
    """

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        if clock is None:
            import time

            clock = time.perf_counter
        self._clock = clock
        # Chrome trace events, in emission order.
        self.events: List[Dict[str, Any]] = []
        # Per-step component-duration accumulator (seconds), drained by
        # the engine at the end of each step via step_components().
        self._step_acc: Dict[str, float] = {}
        # rid -> (phase, t0) for the currently-open lifecycle span.
        self._open_phase: Dict[str, Tuple[str, float]] = {}
        # rid -> list of (phase, t0, t1) closed lifecycle spans.
        self._timelines: Dict[str, List[Tuple[str, float, float]]] = {}
        self._t_origin = self._clock()

    # ------------------------------------------------------------------
    # component spans

    def span(self, component: str, **attrs) -> _Span:
        """Open a component span; use as ``with tracer.span("decode"):``."""
        return _Span(self, component, attrs)

    def _end_span(self, component: str, t0: float, attrs: Dict[str, Any]) -> None:
        t1 = self._clock()
        dur = t1 - t0
        self._step_acc[component] = self._step_acc.get(component, 0.0) + dur
        ev: Dict[str, Any] = {
            "name": component,
            "ph": "X",
            "pid": 0,
            "tid": component,
            "ts": self._us(t0),
            "dur": round((t1 - t0) * 1e6, 3),
        }
        if attrs:
            ev["args"] = attrs
        self.events.append(ev)

    def step_components(self) -> Dict[str, float]:
        """Return and reset the per-step component-duration accumulator."""
        acc = self._step_acc
        self._step_acc = {}
        return acc

    def events_since(self, index: int):
        """The event tail appended since `index`, plus the new cursor —
        how the flight recorder slices each step's events into its ring
        without copying the whole log every step."""
        return len(self.events), self.events[index:]

    # ------------------------------------------------------------------
    # instants and counters

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration event (e.g. an eviction or verdict)."""
        ev: Dict[str, Any] = {
            "name": name,
            "ph": "i",
            "s": "g",
            "pid": 0,
            "tid": "events",
            "ts": self._us(self._clock()),
        }
        if attrs:
            ev["args"] = attrs
        self.events.append(ev)

    def counter(self, name: str, value: float, **attrs) -> None:
        """Record a counter sample (rendered as a track in Perfetto)."""
        args = {"value": value}
        args.update(attrs)
        self.events.append(
            {
                "name": name,
                "ph": "C",
                "pid": 0,
                "ts": self._us(self._clock()),
                "args": args,
            }
        )

    # ------------------------------------------------------------------
    # request lifecycle

    def request_phase(self, rid: str, phase: str, **attrs) -> None:
        """Transition request ``rid`` into ``phase``.

        Closes the previously open phase span (if any) and opens a span
        for the new phase.  Terminal phases (``finished``, ``rejected``)
        only close; ``preempted`` both closes the prior phase and opens a
        ``queued``-like ``preempted`` span that the next phase closes.
        """
        now = self._clock()
        prev = self._open_phase.pop(rid, None)
        if prev is not None:
            prev_phase, t0 = prev
            self._emit_phase(rid, prev_phase, t0, now)
        if phase in _TERMINAL_PHASES:
            # Zero-duration marker so terminal state is visible in trace.
            ev: Dict[str, Any] = {
                "name": phase,
                "ph": "i",
                "s": "t",
                "pid": 1,
                "tid": rid,
                "ts": self._us(now),
            }
            if attrs:
                ev["args"] = attrs
            self.events.append(ev)
            self._timelines.setdefault(rid, []).append((phase, now, now))
            return
        self._open_phase[rid] = (phase, now)
        if attrs:
            # Mark phase entry attrs (e.g. chunk index) as an instant.
            self.events.append(
                {
                    "name": f"{phase}:enter",
                    "ph": "i",
                    "s": "t",
                    "pid": 1,
                    "tid": rid,
                    "ts": self._us(now),
                    "args": attrs,
                }
            )

    def _emit_phase(self, rid: str, phase: str, t0: float, t1: float) -> None:
        self.events.append(
            {
                "name": phase,
                "ph": "X",
                "pid": 1,
                "tid": rid,
                "ts": self._us(t0),
                "dur": round((t1 - t0) * 1e6, 3),
            }
        )
        self._timelines.setdefault(rid, []).append((phase, t0, t1))

    def request_timeline(self, rid: str) -> str:
        """One-line summary of a request's phase history so far.

        Includes the currently-open phase (duration up to now).  Used for
        preemption / requeue log lines so livelock reports are debuggable
        from output alone.
        """
        parts: List[str] = []
        for phase, t0, t1 in self._timelines.get(rid, []):
            parts.append(f"{phase}={t1 - t0:.3f}s")
        cur = self._open_phase.get(rid)
        if cur is not None:
            phase, t0 = cur
            parts.append(f"{phase}={self._clock() - t0:.3f}s*")
        return " ".join(parts) if parts else "(no spans)"

    # ------------------------------------------------------------------
    # export

    def _us(self, t: float) -> float:
        """Seconds-since-origin -> microseconds, rounded for stable JSON."""
        return round((t - self._t_origin) * 1e6, 3)

    def chrome_trace_doc(self) -> Dict[str, Any]:
        """Build the Chrome trace format document (Perfetto-loadable)."""
        meta: List[Dict[str, Any]] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 0,
                "args": {"name": "engine"},
            },
            {
                "name": "process_name",
                "ph": "M",
                "pid": 1,
                "args": {"name": "requests"},
            },
        ]
        # Chrome trace tids must be integers; map string tids stably by
        # first appearance and emit thread_name metadata.
        tid_map: Dict[Tuple[int, str], int] = {}
        next_tid: Dict[int, int] = {0: 0, 1: 0}

        def map_tid(pid: int, tid: Any) -> int:
            key = (pid, str(tid))
            if key not in tid_map:
                tid_map[key] = next_tid[pid]
                next_tid[pid] += 1
                meta.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": tid_map[key],
                        "args": {"name": str(tid)},
                    }
                )
            return tid_map[key]

        out: List[Dict[str, Any]] = []
        for ev in self.events:
            ev = dict(ev)
            if "tid" in ev:
                ev["tid"] = map_tid(ev["pid"], ev["tid"])
            out.append(ev)
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def to_chrome_json(self) -> str:
        """Return the Chrome-trace JSON document as a string."""
        return (
            json.dumps(self.chrome_trace_doc(), separators=(",", ":"), sort_keys=True)
            + "\n"
        )

    def export_chrome_trace(self, path: str) -> None:
        """Write events as Chrome trace format JSON (Perfetto-loadable)."""
        with open(path, "w") as f:
            f.write(self.to_chrome_json())
