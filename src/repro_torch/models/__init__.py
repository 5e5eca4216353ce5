"""Layer graphs of the paper's DNN set (§VI) for the port's simulators."""
from repro_torch.models.paper_nets import PAPER_NETS, build_net, synth_layer_codes

__all__ = ["PAPER_NETS", "build_net", "synth_layer_codes"]
