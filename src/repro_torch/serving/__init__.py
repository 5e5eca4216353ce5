"""Continuous-batching serving engine of the port: request queue and
admission control, paged KV arenas (block page tables, refcounted prefix
sharing, COW, radix-tree prefix cache), fused on-device sampling, and the
engine metrics and tracing surface."""
from repro_torch.serving.engine import EngineModel, ServingEngine
from repro_torch.serving.metrics import (EngineMetrics, VirtualClock,
                                         format_summary)
from repro_torch.serving.paging import PageAllocator, PagedKVArena
from repro_torch.serving.request import Request, RequestStatus
from repro_torch.serving.scheduler import SchedulerConfig, StepScheduler
from repro_torch.serving.tracing import NULL_TRACER, Tracer

__all__ = [
    "EngineModel", "ServingEngine", "EngineMetrics", "VirtualClock",
    "format_summary", "PageAllocator", "PagedKVArena", "Request",
    "RequestStatus", "SchedulerConfig", "StepScheduler", "NULL_TRACER",
    "Tracer",
]
