"""Fault tolerance of the port: the step watchdog (the trainer's emergency
checkpoint, the serving engine's heartbeat) and the straggler timer."""
from repro_torch.ft.straggler import StepTimer, StragglerReport
from repro_torch.ft.watchdog import Watchdog

__all__ = ["StepTimer", "StragglerReport", "Watchdog"]
