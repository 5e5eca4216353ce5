"""Continuous-batching serving engine of the port: request queue and
admission control, paged KV arenas (block page tables, refcounted prefix
sharing, COW, radix-tree prefix cache), multi-model weight-arena residency
with cross-tenant §V-C delta reuse and a tick-budgeted install pipeline
that overlaps tenant switches with decode, fused on-device sampling, and
the engine metrics and tracing surface (drivable on a deterministic
VirtualClock)."""
from repro_torch.serving.engine import EngineModel, ServingEngine
from repro_torch.serving.harness import drive_simulated
from repro_torch.serving.metrics import (EngineMetrics, VirtualClock,
                                         format_summary)
from repro_torch.serving.paging import PageAllocator, PagedKVArena
from repro_torch.serving.request import Request, RequestStatus
from repro_torch.serving.residency import (InstallPipeline,
                                           WeightResidencyManager)
from repro_torch.serving.scheduler import SchedulerConfig, StepScheduler
from repro_torch.serving.tracing import NULL_TRACER, Tracer
from repro_torch.streaming.plan import InstallCostModel

__all__ = [
    "EngineModel", "ServingEngine", "EngineMetrics", "VirtualClock",
    "format_summary", "PageAllocator", "PagedKVArena", "Request",
    "RequestStatus", "InstallPipeline", "InstallCostModel",
    "WeightResidencyManager", "SchedulerConfig", "StepScheduler",
    "drive_simulated", "NULL_TRACER", "Tracer",
]
