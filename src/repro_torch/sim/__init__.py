"""Event-driven simulation of the ARAS accelerator and a TPU-like baseline
(the port's counterparts of `repro.sim`).  Their times and energies are
model outputs of the paper's simulated machines."""
# `repro_torch.core.scheduler` imports `sim.aras`, and `sim.aras` imports
# `repro_torch.core`: loading core first lets this package be imported
# before it (the serving engine imports `sim.energy` on its own).
import repro_torch.core  # noqa: F401
from repro_torch.sim.energy import EnergyModel
from repro_torch.sim.aras import ArasSimConfig, SimResult, simulate_aras, upper_bound_cycles
from repro_torch.sim.tpu import TpuConfig, simulate_tpu

__all__ = [
    "EnergyModel",
    "ArasSimConfig",
    "SimResult",
    "simulate_aras",
    "upper_bound_cycles",
    "TpuConfig",
    "simulate_tpu",
]
