"""Example, PyTorch port: explore scheduler behaviour across accelerator
sizes — how much crossbar capacity does each DNN need before the ARAS
overlap stops paying?  The rates printed are model outputs of the paper's
simulated ARAS machine.

    PYTHONPATH=src python examples/schedule_explore_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import dataclasses

from repro_torch.core.resources import AcceleratorConfig
from repro_torch.models.paper_nets import build_net, synth_layer_codes
from repro_torch.sim.aras import ArasSimConfig, simulate_aras


def main(device: str = "cuda") -> None:
    graph = build_net("resnet50")
    codes = synth_layer_codes(graph, max_samples=100_000, device=device)
    print(f"{graph.name}: scaling the PE pool (paper default 96 PEs)")
    print(f"{'PEs':>5} {'capacity':>10} {'baseline':>10} {'ARAS_BRW':>10} "
          f"{'speedup':>8}")
    for pes in (24, 48, 96, 192, 384):
        accel = AcceleratorConfig(num_pes=pes)
        cfgb = dataclasses.replace(ArasSimConfig.variant("baseline"), accel=accel)
        cfgw = dataclasses.replace(ArasSimConfig.variant("BRW"), accel=accel)
        b = simulate_aras(graph, codes, cfgb)
        w = simulate_aras(graph, codes, cfgw)
        print(f"{pes:5d} {accel.weight_capacity/1e6:9.1f}M "
              f"{1/b.makespan_s:9.1f}/s {1/w.makespan_s:9.1f}/s "
              f"{b.makespan_s/w.makespan_s:7.2f}×")
    print("\nthe optimizations matter most exactly when the model does not\n"
          "fit — the adaptability regime the paper targets.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the codes (default cuda)")
    main(ap.parse_args().device)
