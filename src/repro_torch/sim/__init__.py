"""The ARAS simulation layer of the port: so far the energy model the
serving engine prices its weight and KV writes with."""
from repro_torch.sim.energy import EnergyModel

__all__ = ["EnergyModel"]
