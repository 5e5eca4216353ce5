"""Quickstart, PyTorch port: the ARAS pipeline end to end.

1. Build a DNN layer graph (ResNet-50) and synthetic INT8 weights, their
   codes on the device.
2. Run the offline scheduler (overlap + replication + bank selection +
   partial weight reuse) and inspect the static instruction stream.
3. Compare the four paper configurations on speed/energy/pulses.
4. Run the same scheduling machinery as a weight-streaming plan on one
   H100's link.

Times, rates and energies of steps 2-3 are model outputs of the paper's
simulated ARAS machine; the device only counts the codes' histograms.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.scheduler import build_schedule, validate_schedule
from repro_torch.models.paper_nets import build_net, synth_layer_codes
from repro_torch.sim.aras import ArasSimConfig, simulate_aras
from repro_torch.streaming.plan import StreamLayer, build_stream_plan


def main(device: str = "cuda") -> None:
    graph = build_net("resnet50")
    codes = synth_layer_codes(graph, max_samples=100_000, device=device)
    print(f"{graph.name}: {len(graph.layers)} layers, "
          f"{graph.total_weights/1e6:.1f}M weights")

    # --- offline schedule (paper Fig 6/8) ---
    sched = build_schedule(graph, codes, ArasSimConfig.variant("BRW"))
    errs = validate_schedule(sched)
    if errs:
        raise RuntimeError(f"invalid schedule: {errs}")
    writes, computes = sched.writes(), sched.computes()
    print(f"schedule: {len(writes)} write ops, {len(computes)} compute ops, "
          f"center={sched.reuse_center}, predicted {sched.makespan_s*1e3:.2f} ms")
    print("first events:")
    for ins in sched.instructions[:6]:
        print(f"  {ins.kind:8s} {ins.segment:12s} t=[{ins.t_start_cycles/1e6:8.3f},"
              f"{ins.t_end_cycles/1e6:8.3f}] Mcyc rows={ins.rows} ×{ins.replication}")

    # --- paper configurations ---
    base = simulate_aras(graph, codes, ArasSimConfig.variant("baseline"))
    for v in ("baseline", "B", "BR", "BRW"):
        r = simulate_aras(graph, codes, ArasSimConfig.variant(v))
        print(f"ARAS_{v:4s}: {1/r.makespan_s:6.1f} inf/s  "
              f"energy {r.total_energy_j*1e3:6.2f} mJ "
              f"({r.total_energy_j/base.total_energy_j:5.1%})  "
              f"pulses {r.total_pulses/base.total_pulses:5.1%}")

    # --- the same scheduler as a streaming plan on one H100's link ---
    layers = [StreamLayer(l.name, l.weights, 2.0 * l.weights, windows)
              for l, windows in ((l, l.windows) for l in graph.layers)]
    plan = build_stream_plan(layers,
                             hbm_weight_budget_bytes=graph.total_weights // 3)
    print(f"H100 streaming plan: {plan.n_slots} arena slots, overlap speedup "
          f"{plan.overlap_speedup:.2f}× vs naive")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the codes (default cuda)")
    main(ap.parse_args().device)
