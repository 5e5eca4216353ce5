"""Live telemetry plane: streaming quantiles, SLO burn-rate tracking,
and standard exporters (Prometheus text exposition + JSONL events) — a
copy of `repro.serving.telemetry` (numpy and the standard library) for the
port, whose artifacts equal the reference's byte for byte.

Everything the engine measured before this module is *postmortem*:
`EngineMetrics.summary()` walks whole-run sample lists at exit.  The
router/cluster tier (ROADMAP) needs a *live* per-replica signal, so this
module keeps O(1)-memory streaming views instead:

- `P2Quantile` — the Jain & Chlamtac P-squared estimator: one quantile
  tracked with five markers, O(1) update, no stored samples.  Exact for
  the first five observations, convergent after.
- `SlidingWindow` — fixed-size ring over the last N samples with exact
  `np.percentile` quantiles (so results are *exact* whenever the stream
  is no longer than the window) — the "recent behaviour" view.
- `StreamStat` — one metric's live view: sliding window + lifetime P²
  p50/p95.
- `SLOConfig`/`SLOTracker` — declared p95 targets evaluated as SRE-style
  burn rates over a short and a long indicator window; transitions emit
  `slo_breach` / `slo_recover`.
- `EngineTelemetry` — the per-engine aggregator fed by the step loop:
  TTFT / worst-ITL / queue-wait / latency windows per tenant and global,
  queue-depth / free-pages / prefix-hit windows per step, the SLO
  tracker, and an optional append-mode JSONL event stream.
- `prometheus_text` / `PromEndpoint` — text exposition from the typed
  `MetricsRegistry` (+ live windows), as a textfile or a stdlib
  `http.server` endpoint.
- `validate_prometheus_text` / `validate_events_jsonl` — format checkers
  used by CI (`python -m repro_torch.serving.telemetry --prom ...
  --events ...`).

All of it is observation-only: enabling telemetry must never change a
token the engine emits (asserted in tests and bench part 10).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import re
import threading
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.request import Request
from repro_torch.serving.tracing import NULL_TRACER


def _nan() -> float:
    return float("nan")


def _jsonable(v):
    """NaN/Inf -> None so every exported document is strict JSON."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def dumps_deterministic(doc: dict) -> str:
    """Canonical JSON used for every telemetry artifact: sorted keys,
    compact separators, NaN scrubbed — byte-identical across runs when
    the inputs are (which under `VirtualClock` they are)."""
    return json.dumps(_jsonable(doc), sort_keys=True,
                      separators=(",", ":"))


# ------------------------------------------------------------ quantiles
class P2Quantile:
    """Streaming quantile via the P-squared algorithm (Jain & Chlamtac,
    CACM 1985): five markers whose heights approximate the running
    p-quantile, adjusted with a piecewise-parabolic fit.  O(1) memory and
    time per observation; exact (sorted-sample percentile) until the
    fifth sample arrives."""

    __slots__ = ("p", "count", "_q", "_n", "_np", "_dn")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile p must be in (0, 1), got {p}")
        self.p = float(p)
        self.count = 0
        self._q: List[float] = []       # marker heights
        self._n: List[float] = []       # marker positions (1-based)
        self._np: List[float] = []      # desired positions
        self._dn = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if self.count <= 5:
            self._q.append(x)
            self._q.sort()
            if self.count == 5:
                p = self.p
                self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._np = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p,
                            3.0 + 2.0 * p, 5.0]
            return
        q, n = self._q, self._n
        # locate the cell, extending the extreme markers if needed
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._np[i] += self._dn[i]
        # nudge the three interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if ((d >= 1.0 and n[i + 1] - n[i] > 1.0)
                    or (d <= -1.0 and n[i - 1] - n[i] < -1.0)):
                s = 1.0 if d >= 1.0 else -1.0
                qi = self._parabolic(i, s)
                if not q[i - 1] < qi < q[i + 1]:
                    qi = self._linear(i, s)
                q[i] = qi
                n[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        q, n = self._q, self._n
        return q[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (q[i + 1] - q[i])
            / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (q[i] - q[i - 1])
            / (n[i] - n[i - 1]))

    def _linear(self, i: int, s: float) -> float:
        q, n = self._q, self._n
        j = i + int(s)
        return q[i] + s * (q[j] - q[i]) / (n[j] - n[i])

    @property
    def value(self) -> float:
        if self.count == 0:
            return _nan()
        if self.count < 5:
            return float(np.percentile(
                np.asarray(self._q, np.float64), self.p * 100.0))
        return self._q[2]


class SlidingWindow:
    """Fixed-size ring over the last `window` samples.  `quantile(p)`
    matches `np.percentile` over exactly that tail — so whenever the
    whole stream fits in the window the answer is *exact*, and it is NaN
    on an empty window.  Memory never grows past `window`."""

    __slots__ = ("window", "total", "_ring")

    def __init__(self, window: int):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.total = 0                       # lifetime observation count
        self._ring: Deque[float] = collections.deque(maxlen=self.window)

    def observe(self, x: float) -> None:
        self.total += 1
        self._ring.append(float(x))

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def last(self) -> float:
        return self._ring[-1] if self._ring else _nan()

    def quantile(self, p: float) -> float:
        if not self._ring:
            return _nan()
        return float(np.percentile(
            np.asarray(self._ring, np.float64), p))

    def mean(self) -> float:
        if not self._ring:
            return _nan()
        return float(np.mean(np.asarray(self._ring, np.float64)))


class StreamStat:
    """One metric's live view: exact sliding-window p50/p95 over the
    last `window` samples plus lifetime P² p50/p95 at O(1) memory."""

    __slots__ = ("win", "_p50", "_p95")

    def __init__(self, window: int = 128):
        self.win = SlidingWindow(window)
        self._p50 = P2Quantile(0.50)
        self._p95 = P2Quantile(0.95)

    def observe(self, x: float) -> None:
        self.win.observe(x)
        self._p50.observe(x)
        self._p95.observe(x)

    @property
    def count(self) -> int:
        return self.win.total

    def p50(self) -> float:
        return self.win.quantile(50.0)

    def p95(self) -> float:
        return self.win.quantile(95.0)

    def snapshot(self) -> Dict[str, float]:
        return {
            "n": self.win.total,
            "last": self.win.last,
            "p50": self.p50(),
            "p95": self.p95(),
            "stream_p50": self._p50.value,
            "stream_p95": self._p95.value,
        }


# ------------------------------------------------------------------ SLO
@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Declared p95 latency targets (seconds); 0 disables a target.

    Each target is evaluated as an SRE-style burn rate: the fraction of
    recent samples over the limit, in a short and a long indicator
    window.  For a p95 objective the error budget is 5%, so a target is
    *breached* when both windows burn above `burn_threshold` (default
    0.05) — the short window makes detection fast, the long window keeps
    one bad sample from flapping the state."""

    ttft_p95_s: float = 0.0
    itl_p95_s: float = 0.0
    queue_wait_p95_s: float = 0.0
    short_window: int = 20
    long_window: int = 100
    burn_threshold: float = 0.05
    min_samples: int = 3     # short-window samples needed before a breach

    def targets(self) -> Dict[str, float]:
        out = {}
        if self.ttft_p95_s > 0:
            out["ttft_p95"] = self.ttft_p95_s
        if self.itl_p95_s > 0:
            out["itl_p95"] = self.itl_p95_s
        if self.queue_wait_p95_s > 0:
            out["queue_wait_p95"] = self.queue_wait_p95_s
        return out


class _SLOTarget:
    __slots__ = ("limit", "short", "long", "breached")

    def __init__(self, limit: float, cfg: SLOConfig):
        self.limit = float(limit)
        self.short: Deque[int] = collections.deque(maxlen=cfg.short_window)
        self.long: Deque[int] = collections.deque(maxlen=cfg.long_window)
        self.breached = False

    def burn(self) -> Tuple[float, float]:
        s = (sum(self.short) / len(self.short)) if self.short else 0.0
        lo = (sum(self.long) / len(self.long)) if self.long else 0.0
        return s, lo


class SLOTracker:
    """Burn-rate evaluation of `SLOConfig` targets over sample streams.

    `observe(name, sample)` files a boolean over-limit indicator;
    `evaluate()` returns the state *transitions* since the last call as
    `(kind, target, short_burn, long_burn)` tuples with kind in
    {"slo_breach", "slo_recover"}.  Pure function of the sample stream:
    deterministic under `VirtualClock`."""

    def __init__(self, cfg: SLOConfig):
        self.cfg = cfg
        self._targets = {name: _SLOTarget(limit, cfg)
                         for name, limit in cfg.targets().items()}

    def observe(self, name: str, sample: float) -> None:
        t = self._targets.get(name)
        if t is None:
            return
        bad = 1 if sample > t.limit else 0
        t.short.append(bad)
        t.long.append(bad)

    def evaluate(self) -> List[Tuple[str, str, float, float]]:
        out: List[Tuple[str, str, float, float]] = []
        thr = self.cfg.burn_threshold
        for name in sorted(self._targets):
            t = self._targets[name]
            s, lo = t.burn()
            if (not t.breached and len(t.short) >= self.cfg.min_samples
                    and s > thr and lo > thr):
                t.breached = True
                out.append(("slo_breach", name, s, lo))
            elif t.breached and s <= thr and lo <= thr:
                t.breached = False
                out.append(("slo_recover", name, s, lo))
        return out

    @property
    def any_breached(self) -> bool:
        return any(t.breached for t in self._targets.values())

    def status(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name in sorted(self._targets):
            t = self._targets[name]
            s, lo = t.burn()
            out[name] = {
                "target_s": t.limit,
                "breached": int(t.breached),
                "burn_short": s,
                "burn_long": lo,
                "samples": len(t.long),
            }
        return out


# -------------------------------------------------------- engine plumbing
@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Knobs for the live telemetry plane (all surfaces off by default
    at the engine level — constructing a config turns the plane on)."""

    window: int = 128                 # sliding-window size (samples/steps)
    slo: Optional[SLOConfig] = None
    events_path: str = ""             # append-mode JSONL stream ("" = off)


class JsonlWriter:
    """Append-mode JSONL event stream; one canonical-JSON object per
    line, flushed per write so a crash loses at most the current line."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", encoding="utf-8")

    def write(self, obj: dict) -> None:
        self._f.write(dumps_deterministic(obj) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# metric names fed per finished request (per tenant + global scope)
FINISH_STATS = ("ttft_s", "itl_max_s", "queue_wait_s", "latency_s")
# metric names fed per engine step (global scope only)
STEP_STATS = ("queue_depth", "kv_free_pages", "prefix_hit_rate")
_GLOBAL = "_global"


class EngineTelemetry:
    """Per-engine live-telemetry aggregator.

    The engine calls `on_finish(req)` when a request completes and
    `on_step(step_no, t, rec, free_pages)` at the end of every step;
    both are O(1).  Everything here *observes* — no scheduling input
    ever reads a telemetry value, so enabling it is token-identical."""

    def __init__(self, cfg: TelemetryConfig, *, tracer=NULL_TRACER):
        self.cfg = cfg
        self.tracer = tracer
        self.slo = SLOTracker(cfg.slo) if cfg.slo is not None else None
        self.events = JsonlWriter(cfg.events_path) if cfg.events_path \
            else None
        self._stats: Dict[Tuple[str, str], StreamStat] = {}
        self._pending: List[Tuple[str, str, float, float]] = []
        self.finishes = 0

    def _stat(self, scope: str, name: str) -> StreamStat:
        key = (scope, name)
        st = self._stats.get(key)
        if st is None:
            st = StreamStat(self.cfg.window)
            self._stats[key] = st
        return st

    def _observe_finish(self, scope: str, name: str, value) -> None:
        if value is None:
            return
        self._stat(scope, name).observe(value)

    def on_finish(self, req: Request) -> None:
        """File one finished request's latency samples (global + tenant
        scope) and its SLO indicators; emits any SLO transition as a
        trace instant immediately."""
        self.finishes += 1
        samples = {"ttft_s": req.ttft, "itl_max_s": req.max_itl,
                   "queue_wait_s": req.ttft_queue, "latency_s": req.latency}
        for scope in (_GLOBAL, req.model):
            for name, v in samples.items():
                self._observe_finish(scope, name, v)
        if self.slo is not None:
            if req.ttft is not None:
                self.slo.observe("ttft_p95", req.ttft)
            if req.max_itl is not None:
                self.slo.observe("itl_p95", req.max_itl)
            if req.ttft_queue is not None:
                self.slo.observe("queue_wait_p95", req.ttft_queue)
            for kind, target, s, lo in self.slo.evaluate():
                self._pending.append((kind, target, s, lo))
                if self.tracer.enabled:
                    self.tracer.instant(kind, target=target, burn_short=s,
                                        burn_long=lo)
                if self.events is not None:
                    self.events.write({"type": kind, "t": req.finish_t,
                                       "target": target, "burn_short": s,
                                       "burn_long": lo})
        if self.events is not None:
            self.events.write({
                "type": "finish", "t": req.finish_t, "rid": req.rid,
                "tenant": req.model, "n_generated": len(req.generated),
                "ttft_s": req.ttft, "itl_max_s": req.max_itl,
                "queue_wait_s": req.ttft_queue, "latency_s": req.latency})

    def on_step(self, step_no: int, rec, free_pages: int
                ) -> List[Tuple[str, str, float, float]]:
        """File the per-step gauges and drain SLO transitions collected
        since the last step (the engine forwards them to the recorder).
        `rec` is the step's `StepRecord`."""
        self._stat(_GLOBAL, "queue_depth").observe(rec.queue_depth)
        if rec.kv_total_pages:
            self._stat(_GLOBAL, "kv_free_pages").observe(free_pages)
        covered = rec.prefix_hit_tokens + rec.prefill_tokens
        if covered:
            self._stat(_GLOBAL, "prefix_hit_rate").observe(
                rec.prefix_hit_tokens / covered)
        if self.events is not None:
            g = self.snapshot_scope(_GLOBAL)
            self.events.write({
                "type": "step", "step": step_no, "t": rec.t,
                "queue_depth": rec.queue_depth, "free_pages": free_pages,
                "n_active": rec.n_active, "windows": g})
        out, self._pending = self._pending, []
        return out

    # ------------------------------------------------------- snapshots
    def scopes(self) -> List[str]:
        return sorted({scope for scope, _ in self._stats})

    def snapshot_scope(self, scope: str) -> Dict[str, Dict[str, float]]:
        return {name: st.snapshot()
                for (sc, name), st in sorted(self._stats.items())
                if sc == scope}

    def snapshot(self) -> Dict[str, object]:
        tenants = {sc: self.snapshot_scope(sc) for sc in self.scopes()
                   if sc != _GLOBAL}
        doc: Dict[str, object] = {
            "finishes": self.finishes,
            "global": self.snapshot_scope(_GLOBAL),
            "tenants": tenants,
        }
        if self.slo is not None:
            doc["slo"] = self.slo.status()
        return doc

    def close(self) -> None:
        if self.events is not None:
            self.events.close()


# ------------------------------------------------------------ exporters
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_esc(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _prom_num(v: float) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def prometheus_text(registry: MetricsRegistry,
                    telemetry: Optional[EngineTelemetry] = None,
                    namespace: str = "repro") -> str:
    """Render the typed `MetricsRegistry` (plus, when given, the live
    telemetry windows and SLO status) as Prometheus text exposition
    format: `# HELP`/`# TYPE` headers, counters as `_total`, histograms
    as summaries with `quantile` labels, windows as labeled gauges."""
    from repro_torch.serving.metrics import Counter, Gauge, Histogram

    lines: List[str] = []

    def family(name: str, typ: str, help_text: str) -> None:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {typ}")

    for name in registry.names():
        m = registry._metrics[name]
        pname = f"{namespace}_{_prom_name(name)}"
        if isinstance(m, Counter):
            family(f"{pname}_total", "counter", f"counter {name}")
            lines.append(f"{pname}_total {_prom_num(m.value)}")
        elif isinstance(m, Gauge):
            family(pname, "gauge", f"gauge {name}")
            lines.append(f"{pname} {_prom_num(m.value)}")
            family(f"{pname}_max", "gauge", f"high-water mark of {name}")
            lines.append(f"{pname}_max {_prom_num(m.max)}")
        elif isinstance(m, Histogram):
            family(pname, "summary", f"histogram {name}")
            for q, p in (("0.5", 50), ("0.95", 95)):
                lines.append(
                    f"{pname}{{quantile=\"{q}\"}} "
                    f"{_prom_num(m.quantile(p))}")
            lines.append(f"{pname}_sum {_prom_num(m.sum)}")
            lines.append(f"{pname}_count {_prom_num(m.count)}")
    if telemetry is not None:
        wname = f"{namespace}_window"
        family(wname, "gauge",
               "sliding-window quantile (label metric/tenant/quantile)")
        for scope in telemetry.scopes():
            tenant = "" if scope == _GLOBAL else scope
            for name, snap in telemetry.snapshot_scope(scope).items():
                for q, key in (("0.5", "p50"), ("0.95", "p95")):
                    lines.append(
                        f"{wname}{{metric=\"{_prom_esc(name)}\","
                        f"tenant=\"{_prom_esc(tenant)}\","
                        f"quantile=\"{q}\"}} {_prom_num(snap[key])}")
        if telemetry.slo is not None:
            bname = f"{namespace}_slo_breached"
            family(bname, "gauge", "1 while the SLO target is breached")
            for target, st in telemetry.slo.status().items():
                lines.append(
                    f"{bname}{{target=\"{_prom_esc(target)}\"}} "
                    f"{_prom_num(st['breached'])}")
    return "\n".join(lines) + "\n"


class PromEndpoint:
    """Minimal stdlib `/metrics` endpoint: a daemon-threaded
    `ThreadingHTTPServer` rendering `render()` on each scrape.  Never on
    the step path — scrapes read whatever the last step published."""

    def __init__(self, port: int, render):
        import http.server

        endpoint = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):                          # noqa: N802
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = endpoint.render().encode("utf-8")
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):              # quiet
                pass

        self.render = render
        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                                    Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True,
            name="prom-endpoint")
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


# ----------------------------------------------------------- validators
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{([^{}]*)\})?"
    r" (NaN|[+-]Inf|[-+]?[0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?)"
    r"( [0-9]+)?$")
_LABEL_RE = re.compile(
    r"^[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\[\\\"n])*\"$")
_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"(counter|gauge|summary|histogram|untyped)$")
_SUFFIXES = ("_total", "_sum", "_count", "_bucket")


def validate_prometheus_text(text: str) -> List[str]:
    """Check Prometheus text-exposition well-formedness: TYPE lines
    declared once with a known type, every sample line syntactically
    valid (name, label syntax, value), and every sample belonging to a
    declared family.  Returns a list of error strings (empty = valid)."""
    errors: List[str] = []
    families: Dict[str, str] = {}
    n_samples = 0
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            if line.startswith("# TYPE "):
                m = _TYPE_RE.match(line)
                if not m:
                    errors.append(f"line {ln}: malformed TYPE line")
                    continue
                name, typ = m.group(1), m.group(2)
                if name in families:
                    errors.append(
                        f"line {ln}: duplicate TYPE for {name}")
                families[name] = typ
            elif not line.startswith("# HELP "):
                errors.append(f"line {ln}: unknown comment directive")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {ln}: malformed sample line: {line!r}")
            continue
        n_samples += 1
        name, labels = m.group(1), m.group(3)
        if labels:
            for pair in labels.split(","):
                if not _LABEL_RE.match(pair):
                    errors.append(
                        f"line {ln}: malformed label {pair!r}")
        base_names = [name] + [name[: -len(sfx)]
                               for sfx in _SUFFIXES
                               if name.endswith(sfx)]
        if not any(b in families for b in base_names):
            errors.append(
                f"line {ln}: sample {name!r} has no TYPE declaration")
    if n_samples == 0:
        errors.append("no sample lines found")
    return errors


# JSONL event schema: type -> required fields
EVENT_SCHEMA: Dict[str, Tuple[str, ...]] = {
    "step": ("step", "t", "queue_depth", "windows"),
    "finish": ("t", "rid", "tenant", "n_generated"),
    "slo_breach": ("t", "target", "burn_short", "burn_long"),
    "slo_recover": ("t", "target", "burn_short", "burn_long"),
    "flight_dump": ("t", "reason", "path"),
    "run_start": ("t",),
    "run_end": ("t",),
}


def validate_events_jsonl(text: str) -> List[str]:
    """Check the `--events-out` JSONL stream: every line strict JSON,
    every event of a known type with its required fields present."""
    errors: List[str] = []
    n = 0
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        n += 1
        try:
            obj = json.loads(line)
        except ValueError as e:
            errors.append(f"line {ln}: not valid JSON ({e})")
            continue
        if not isinstance(obj, dict):
            errors.append(f"line {ln}: event is not an object")
            continue
        typ = obj.get("type")
        if typ not in EVENT_SCHEMA:
            errors.append(f"line {ln}: unknown event type {typ!r}")
            continue
        missing = [k for k in EVENT_SCHEMA[typ] if k not in obj]
        if missing:
            errors.append(
                f"line {ln}: {typ} event missing fields {missing}")
    if n == 0:
        errors.append("no event lines found")
    return errors


def _main(argv=None) -> int:
    """CI validator: `python -m repro_torch.serving.telemetry --prom f
    --events g` exits non-zero listing every format error found."""
    import argparse

    ap = argparse.ArgumentParser(
        description="validate telemetry export artifacts")
    ap.add_argument("--prom", action="append", default=[],
                    help="Prometheus text-exposition file(s) to validate")
    ap.add_argument("--events", action="append", default=[],
                    help="JSONL event-stream file(s) to validate")
    args = ap.parse_args(argv)
    if not args.prom and not args.events:
        ap.error("nothing to validate: pass --prom and/or --events")
    failed = False
    for path in args.prom:
        with open(path, encoding="utf-8") as f:
            errs = validate_prometheus_text(f.read())
        for e in errs:
            print(f"{path}: {e}")
        failed = failed or bool(errs)
        if not errs:
            print(f"{path}: valid Prometheus text exposition")
    for path in args.events:
        with open(path, encoding="utf-8") as f:
            errs = validate_events_jsonl(f.read())
        for e in errs:
            print(f"{path}: {e}")
        failed = failed or bool(errs)
        if not errs:
            print(f"{path}: valid JSONL event stream")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(_main())
