"""Engine metrics surface: latency percentiles, throughput, queue depth,
and the weight-arena install accounting merged in by the engine.

`EngineMetrics` is backed by a typed `MetricsRegistry` of counters,
gauges, and histograms; the legacy attribute names (`tokens_generated`,
`preemptions`, ...) and every `summary()` key are preserved on top of it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.request import Request


def _pct(xs: List[float], p: float) -> float:
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), p))


class Counter:
    """Monotonic counter (ints stay ints so summaries render cleanly)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, delta: float = 1) -> None:
        if delta < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += delta


class Gauge:
    """Point-in-time value with a high-water mark."""

    __slots__ = ("name", "value", "max")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.max = 0

    def set(self, value: float) -> None:
        self.value = value
        if value > self.max:
            self.max = value


class Histogram:
    """Sample accumulator with numpy-percentile quantiles.

    `quantile(p)` matches the legacy `_pct` helper exactly: linear
    interpolation via `np.percentile`, NaN on an empty window.
    """

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, value: float) -> None:
        self.values.append(float(value))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    def quantile(self, p: float) -> float:
        return _pct(self.values, p)

    def mean(self) -> float:
        return float(np.mean(self.values)) if self.values else float("nan")


class MetricsRegistry:
    """Typed metric registry: one named instrument per metric.

    `counter`/`gauge`/`histogram` get-or-create; asking for an existing
    name with a different type is an error.  `as_dict()` flattens every
    instrument to floats for JSON export (`serve.py --metrics-json`).
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Counter):
                out[name] = float(m.value)
            elif isinstance(m, Gauge):
                out[name] = float(m.value)
                out[f"{name}_max"] = float(m.max)
            elif isinstance(m, Histogram):
                out[f"{name}_count"] = float(m.count)
                out[f"{name}_p50"] = m.quantile(50)
                out[f"{name}_p95"] = m.quantile(95)
        return out


class VirtualClock:
    """Injectable simulated time for the engine's `clock` hook: the test
    harness and benchmarks advance it explicitly per step, making every
    latency/stall metric deterministic — no device, no wall clock."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("virtual time cannot run backwards")
        self.t += dt
        return self.t


@dataclasses.dataclass
class StepRecord:
    t: float
    n_active: int
    queue_depth: int
    n_prefills: int
    n_decoded: int
    install_wire_bytes: int
    # paged-KV occupancy snapshot (0/0 when every tenant is slot-managed)
    kv_used_pages: int = 0
    kv_total_pages: int = 0
    # install-pipeline accounting (all zero on the unbudgeted ensure() path):
    # wire bytes of install stream pumped this step (partial installs
    # included), how much of it was hidden under decode/prefill compute, and
    # whether a scheduled tenant sat blocked on installs with no tokens out.
    install_work_bytes: int = 0
    overlap_hidden_bytes: int = 0
    install_stall: bool = False
    # chunked prefill: prompt tokens of chunk work this step (monolithic
    # prefills count their whole prompt here) and chunks launched — the
    # virtual-clock cost models charge step time against prefill_tokens
    prefill_tokens: int = 0
    n_prefill_chunks: int = 0
    # radix-tree prefix cache: prompt tokens served from cached pages this
    # step (skipped chunks — they cost no compute and no prefill budget)
    # and the retained-page gauge across all paged tenants
    prefix_hit_tokens: int = 0
    prefix_cached_pages: int = 0
    # host syncs spent pulling sampled tokens (or logits) off device this
    # step: 1 per decoded tenant batch (fused or batched sampler), never
    # per row
    sample_syncs: int = 0
    # tracer component breakdown for this step: component name -> seconds
    # spent inside spans of that component (empty when tracing is off)
    component_s: Dict[str, float] = dataclasses.field(default_factory=dict)


def _counter_property(attr: str):
    """Expose a registry counter under a legacy EngineMetrics attribute."""

    def fget(self) -> int:
        return getattr(self, attr).value

    def fset(self, value) -> None:
        getattr(self, attr).value = value

    return property(fget, fset)


class EngineMetrics:
    """Aggregate engine metrics, backed by a typed `MetricsRegistry`.

    The legacy counter attributes (`tokens_generated`, `preemptions`, ...)
    are properties over registry instruments, so both the old attribute
    surface and `registry.as_dict()` see the same numbers.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.finished: List[Request] = []
        self.steps: List[StepRecord] = []
        r = self.registry
        self._c_tokens = r.counter("engine_tokens_generated")
        self._c_preemptions = r.counter("engine_preemptions")
        self._c_prefill_tokens = r.counter("engine_prefill_tokens")
        self._c_prefill_chunks = r.counter("engine_prefill_chunks")
        self._c_prefix_hit_tokens = r.counter("engine_prefix_hit_tokens")
        self._g_concurrent = r.gauge("engine_concurrent")
        self._g_queue_depth = r.gauge("engine_queue_depth")
        self._h_latency = r.histogram("request_latency_s")
        self._h_ttft = r.histogram("request_ttft_s")
        self._h_ttft_queue = r.histogram("request_ttft_queue_s")
        self._h_ttft_prefill = r.histogram("request_ttft_prefill_s")
        self._h_itl_max = r.histogram("request_itl_max_s")

    tokens_generated = _counter_property("_c_tokens")
    preemptions = _counter_property("_c_preemptions")
    prefill_tokens = _counter_property("_c_prefill_tokens")
    prefill_chunks = _counter_property("_c_prefill_chunks")
    prefix_hit_tokens = _counter_property("_c_prefix_hit_tokens")

    @property
    def max_concurrent(self) -> int:
        return self._g_concurrent.max

    @max_concurrent.setter
    def max_concurrent(self, value: int) -> None:
        self._g_concurrent.max = value

    def record_step(self, rec: StepRecord) -> None:
        self.steps.append(rec)
        self._g_concurrent.set(rec.n_active)
        self._g_queue_depth.set(rec.queue_depth)
        self._c_tokens.inc(rec.n_decoded + rec.n_prefills)
        self._c_prefill_tokens.inc(rec.prefill_tokens)
        self._c_prefill_chunks.inc(rec.n_prefill_chunks)
        self._c_prefix_hit_tokens.inc(rec.prefix_hit_tokens)

    def record_finish(self, req: Request) -> None:
        self.finished.append(req)
        if req.latency is not None:
            self._h_latency.observe(req.latency)
        if req.ttft is not None:
            self._h_ttft.observe(req.ttft)
        if req.ttft_queue is not None:
            self._h_ttft_queue.observe(req.ttft_queue)
        if req.ttft_prefill is not None:
            self._h_ttft_prefill.observe(req.ttft_prefill)
        if req.max_itl is not None:
            self._h_itl_max.observe(req.max_itl)

    def record_preemption(self) -> None:
        self._c_preemptions.inc()

    def summary(self, wall_s: float,
                residency: Optional[Dict[str, float]] = None,
                rejected: int = 0,
                paging: Optional[Dict[str, float]] = None,
                prefill_cache: Optional[Dict[str, int]] = None,
                wear: Optional[Dict[str, float]] = None
                ) -> Dict[str, float]:
        # Histograms are fed by record_finish with exactly the non-None
        # per-request stats, so quantiles match the legacy list-comp path.
        lat = self._h_latency.values
        ttft = self._h_ttft.values
        ttft_q = self._h_ttft_queue.values
        ttft_p = self._h_ttft_prefill.values
        itl = self._h_itl_max.values
        depths = [s.queue_depth for s in self.steps]
        out = {
            "requests_finished": float(len(self.finished)),
            "requests_rejected": float(rejected),
            "tokens_generated": float(self.tokens_generated),
            "tokens_per_s": self.tokens_generated / max(wall_s, 1e-9),
            "latency_p50_s": _pct(lat, 50),
            "latency_p95_s": _pct(lat, 95),
            "ttft_p50_s": _pct(ttft, 50),
            "ttft_p95_s": _pct(ttft, 95),
            # TTFT split: queued-for-admission vs chunk-prefilling time (a
            # prefill-token budget trades the latter against decode ITL)
            "ttft_queue_p50_s": _pct(ttft_q, 50),
            "ttft_queue_p95_s": _pct(ttft_q, 95),
            "ttft_prefill_p50_s": _pct(ttft_p, 50),
            "ttft_prefill_p95_s": _pct(ttft_p, 95),
            "prefill_tokens": float(self.prefill_tokens),
            "prefill_chunks": float(self.prefill_chunks),
            # prefix cache: prompt tokens served from retained pages
            # instead of chunk compute; hit rate over all prompt tokens
            # the engine covered (computed + skipped)
            "prefix_hit_tokens": float(self.prefix_hit_tokens),
            "prefix_hit_rate": (
                self.prefix_hit_tokens
                / max(self.prefix_hit_tokens + self.prefill_tokens, 1)),
            # worst inter-token gap per request: the tenant-boundary stall a
            # mean latency hides (install stalls land exactly here)
            "itl_max_p50_s": _pct(itl, 50),
            "itl_max_p95_s": _pct(itl, 95),
            "queue_depth_mean": float(np.mean(depths)) if depths else 0.0,
            "queue_depth_max": float(max(depths)) if depths else 0.0,
            "max_concurrent": float(self.max_concurrent),
            "preemptions": float(self.preemptions),
            "steps": float(len(self.steps)),
            "install_stall_steps": float(
                sum(1 for s in self.steps if s.install_stall)),
            "install_work_bytes": float(
                sum(s.install_work_bytes for s in self.steps)),
            "overlap_hidden_bytes": float(
                sum(s.overlap_hidden_bytes for s in self.steps)),
            "wall_s": wall_s,
        }
        # Tracer component breakdown: total seconds per component across
        # all steps (only present when a tracer fed StepRecord.component_s).
        comp_totals: Dict[str, float] = {}
        for s_rec in self.steps:
            for comp, secs in s_rec.component_s.items():
                comp_totals[comp] = comp_totals.get(comp, 0.0) + secs
        for comp, secs in sorted(comp_totals.items()):
            out[f"component_{comp}_s"] = secs
        if prefill_cache:
            # jit-trace accounting from launch.steps.prefill_cache_info —
            # process-wide (step caches are shared across engine instances
            # of one config), so read deltas when comparing arms
            out.update({f"prefill_cache_{k}": float(v)
                        for k, v in prefill_cache.items()})
        if residency:
            out.update(residency)
        if paging:
            occ = [s.kv_used_pages / s.kv_total_pages
                   for s in self.steps if s.kv_total_pages]
            out.update(paging)
            out["kv_page_occupancy_mean"] = (
                float(np.mean(occ)) if occ else 0.0)
            out["kv_page_occupancy_max"] = float(max(occ)) if occ else 0.0
            cached = [s.prefix_cached_pages for s in self.steps]
            out["prefix_cached_pages_mean"] = (
                float(np.mean(cached)) if cached else 0.0)
            out["prefix_cached_pages_max"] = (
                float(max(cached)) if cached else 0.0)
        if wear:
            # engine._wear_stats(): install/KV write energy priced through
            # the EnergyModel plus the WearMap spread coefficients
            out.update(wear)
        # Per-tenant attribution: every finished request knows its tenant
        # (`Request.model`), so the summary splits the latency picture by
        # tenant under dotted `tenant.<name>.<metric>` keys (no other
        # summary key contains a dot — format_summary keys off that).
        by_tenant: Dict[str, List[Request]] = {}
        for req in self.finished:
            by_tenant.setdefault(req.model, []).append(req)
        for name in sorted(by_tenant):
            reqs = by_tenant[name]
            toks = float(sum(len(r.generated) for r in reqs))
            pre = f"tenant.{name}."
            out[pre + "requests"] = float(len(reqs))
            out[pre + "tokens_generated"] = toks
            out[pre + "tokens_per_s"] = toks / max(wall_s, 1e-9)
            out[pre + "ttft_p95_s"] = _pct(
                [r.ttft for r in reqs if r.ttft is not None], 95)
            out[pre + "itl_max_p95_s"] = _pct(
                [r.max_itl for r in reqs if r.max_itl is not None], 95)
        return out


def format_summary(s: Dict[str, float]) -> str:
    lines = [
        f"finished {int(s['requests_finished'])} requests "
        f"({int(s['requests_rejected'])} rejected, "
        f"{int(s['preemptions'])} preemptions) in {s['wall_s']*1e3:.0f} ms "
        f"over {int(s['steps'])} steps",
        f"throughput {s['tokens_per_s']:.1f} tok/s, "
        f"max concurrent {int(s['max_concurrent'])}",
        f"latency p50/p95 {s['latency_p50_s']*1e3:.1f}/"
        f"{s['latency_p95_s']*1e3:.1f} ms, "
        f"ttft p50/p95 {s['ttft_p50_s']*1e3:.1f}/"
        f"{s['ttft_p95_s']*1e3:.1f} ms",
        f"queue depth mean/max {s['queue_depth_mean']:.1f}/"
        f"{int(s['queue_depth_max'])}",
    ]
    if "kv_pages_total" in s:
        lines.append(
            f"paged KV: occupancy mean/max "
            f"{s['kv_page_occupancy_mean']:.1%}/"
            f"{s['kv_page_occupancy_max']:.1%} of "
            f"{int(s['kv_pages_total'])} pages, "
            f"{int(s['kv_shared_page_hits'])} shared-page hits "
            f"({int(s['kv_pages_saved'])} pages saved), "
            f"{int(s['kv_cow_copies'])} COW copies")
    if "install_wire_bytes" in s:
        lines.append(
            f"weight installs: {int(s['installs'])} "
            f"({int(s['cross_tenant_installs'])} cross-tenant), "
            f"{s['install_wire_bytes']/1e6:.2f} MB wire vs "
            f"{s['install_raw_bytes']/1e6:.2f} MB raw "
            f"(saved {s['install_savings']:.1%}, "
            f"skip {s['install_mean_skip']:.1%})")
    if s.get("prefix_hit_tokens", 0) or s.get("kv_prefix_cached_pages", 0):
        lines.append(
            f"prefix cache: {int(s['prefix_hit_tokens'])} prompt tokens "
            f"served from cache ({s['prefix_hit_rate']:.1%} hit rate), "
            f"{int(s.get('kv_prefix_cached_pages', 0))} pages resident "
            f"(max {int(s.get('prefix_cached_pages_max', 0))}), "
            f"{int(s.get('kv_prefix_evictions', 0))} LRU evictions")
    if s.get("prefill_chunks", 0):
        lines.append(
            f"chunked prefill: {int(s['prefill_tokens'])} prompt tokens in "
            f"{int(s['prefill_chunks'])} chunks; ttft queue/prefill p95 "
            f"{s['ttft_queue_p95_s']*1e3:.1f}/{s['ttft_prefill_p95_s']*1e3:.1f}"
            f" ms; {int(s.get('prefill_cache_traces', 0))} prefill traces "
            f"process-wide")
    if s.get("install_work_bytes", 0) or s.get("install_stall_steps", 0):
        hidden = s["overlap_hidden_bytes"]
        work = max(s["install_work_bytes"], 1.0)
        lines.append(
            f"install pipeline: {int(s['install_stall_steps'])} stall steps, "
            f"{hidden/1e6:.2f} MB of {s['install_work_bytes']/1e6:.2f} MB "
            f"hidden under decode ({hidden/work:.0%}); "
            f"worst inter-token gap p50/p95 "
            f"{s['itl_max_p50_s']*1e3:.1f}/{s['itl_max_p95_s']*1e3:.1f} ms")
    if s.get("install_write_pulses", 0) or s.get("kv_page_writes", 0):
        line = (
            f"wear: installs {s.get('install_energy_j', 0.0)*1e3:.2f} mJ "
            f"({int(s.get('install_cell_flips', 0))} cell flips, "
            f"{int(s.get('install_write_pulses', 0))} pulses), "
            f"KV {s.get('kv_write_energy_j', 0.0)*1e3:.2f} mJ "
            f"({int(s.get('kv_page_writes', 0))} page writes, "
            f"{int(s.get('kv_page_writes_avoided', 0))} avoided); "
            f"gini weight {s.get('wear_gini_weight', 0.0):.3f}")
        if "wear_gini_kv" in s:
            line += f", kv {s['wear_gini_kv']:.3f}"
        lines.append(line)
    if s.get("faults_survived", 0):
        lines.append(
            f"faults: {int(s['faults_survived'])} survived "
            f"({int(s.get('slots_retired', 0))} slots, "
            f"{int(s.get('pages_retired', 0))} pages retired)")
    tenants = sorted({k.split(".", 2)[1] for k in s
                      if k.startswith("tenant.")})
    for name in tenants:
        pre = f"tenant.{name}."
        lines.append(
            f"tenant {name}: {int(s[pre + 'requests'])} requests, "
            f"ttft p95 {s[pre + 'ttft_p95_s']*1e3:.1f} ms, "
            f"itl p95 {s[pre + 'itl_max_p95_s']*1e3:.1f} ms, "
            f"{s[pre + 'tokens_per_s']:.1f} tok/s")
    return "\n".join(lines)
