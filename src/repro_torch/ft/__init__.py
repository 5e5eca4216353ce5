"""Fault tolerance of the port: the step watchdog the serving engine arms
as a heartbeat."""
from repro_torch.ft.watchdog import Watchdog

__all__ = ["Watchdog"]
