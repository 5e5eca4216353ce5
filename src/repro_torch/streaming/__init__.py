"""ARAS layer streaming of the port: a model whose weights do not fit the
device arena runs layer by layer, each layer installed into an arena slot
as a mod-256 delta of the slot's previous occupant (PyTorch counterpart of
`repro.streaming`)."""
from repro_torch.streaming.delta import QuantizedStore, delta_bytes
from repro_torch.streaming.executor import StreamingExecutor
from repro_torch.streaming.plan import LinkModel, StreamPlan, build_stream_plan

__all__ = [
    "StreamPlan", "build_stream_plan", "LinkModel",
    "QuantizedStore", "delta_bytes", "StreamingExecutor",
]
