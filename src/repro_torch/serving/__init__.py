"""Continuous-batching serving engine of the port: request queue and
admission control, slot-managed KV arenas (one whole-sequence slot per
request), paged KV arenas (block page tables, refcounted prefix sharing,
COW, radix-tree prefix cache), chunked prefill into a staging
cache with the prefix cache's chunk skip, multi-model weight-arena residency
with cross-tenant §V-C delta reuse and a tick-budgeted install pipeline
that overlaps tenant switches with decode, fused on-device sampling, the
wear plane with wear-aware placement and seeded stuck-at faults, the live
telemetry plane (windowed percentiles, SLOs, Prometheus and JSONL
exporters) with its flight recorder, and the engine metrics and tracing
surface (drivable on a deterministic VirtualClock)."""
from repro_torch.serving.bucketing import (PrefillProgress, bucket_for,
                                           bucket_ladder)
from repro_torch.serving.engine import EngineModel, ServingEngine
from repro_torch.serving.faults import FaultModel
from repro_torch.serving.harness import drive_simulated
from repro_torch.serving.kv_arena import KVArena
from repro_torch.serving.metrics import (Counter, EngineMetrics, Gauge,
                                         Histogram, MetricsRegistry,
                                         VirtualClock, format_summary)
from repro_torch.serving.paging import PageAllocator, PagedKVArena
from repro_torch.serving.prefix_cache import RadixNode, RadixPrefixCache
from repro_torch.serving.recorder import FlightRecorder
from repro_torch.serving.request import Request, RequestStatus
from repro_torch.serving.residency import (InstallPipeline,
                                           WeightResidencyManager)
from repro_torch.serving.sampling import (request_key, sample_token,
                                          sample_tokens)
from repro_torch.serving.scheduler import SchedulerConfig, StepScheduler
from repro_torch.serving.telemetry import (EngineTelemetry, P2Quantile,
                                           PromEndpoint, SLOConfig,
                                           SLOTracker, SlidingWindow,
                                           StreamStat, TelemetryConfig,
                                           prometheus_text,
                                           validate_events_jsonl,
                                           validate_prometheus_text)
from repro_torch.serving.tracing import NULL_TRACER, NullTracer, Tracer
from repro_torch.serving.wear import WearMap, WearPlane, gini_coefficient
from repro_torch.streaming.plan import InstallCostModel

__all__ = [
    "EngineModel", "ServingEngine", "KVArena", "PageAllocator",
    "PagedKVArena", "RadixNode", "RadixPrefixCache",
    "EngineMetrics", "VirtualClock", "format_summary",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "NullTracer", "NULL_TRACER",
    "Request", "RequestStatus", "InstallPipeline", "InstallCostModel",
    "WeightResidencyManager", "SchedulerConfig", "StepScheduler",
    "drive_simulated", "request_key", "sample_token", "sample_tokens",
    "PrefillProgress", "bucket_for", "bucket_ladder",
    "WearMap", "WearPlane", "gini_coefficient", "FaultModel",
    "TelemetryConfig", "EngineTelemetry", "SLOConfig", "SLOTracker",
    "P2Quantile", "SlidingWindow", "StreamStat", "FlightRecorder",
    "PromEndpoint", "prometheus_text",
    "validate_prometheus_text", "validate_events_jsonl",
]
