"""The port's example arms against the reference's examples on the CPU:
`examples/quickstart_torch.py` and `examples/schedule_explore_torch.py`
run with `--device cpu`, each beside its reference example (under
`JAX_PLATFORMS=cpu`) in subprocesses, and must print the same lines.  The
quickstart's last line plans on one H100's link (the port's `LinkModel`)
where the reference plans on a TPU's, so that line is held against the
reference's `build_stream_plan` given a `TpuLinkModel` carrying the
`LinkModel` figures."""
import dataclasses
import os
import pathlib
import subprocess
import sys

from repro.models.paper_nets import build_net
from repro.streaming.plan import StreamLayer, TpuLinkModel, build_stream_plan
from repro_torch.streaming.plan import LinkModel

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 300


def run_pair(name):
    """(reference example's stdout lines, torch arm's stdout lines), the
    two run side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / script), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for script, args in ((f"{name}.py", ()),
                                       (f"{name}_torch.py", ("--device", "cpu")))]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, stderr[-4000:]
        out.append(stdout.splitlines())
    return out


def test_quickstart_torch_prints_the_reference_lines():
    ref, got = run_pair("quickstart")
    assert len(got) == len(ref) > 10
    assert got[:-1] == ref[:-1]
    assert ref[-1].startswith("TPU streaming plan: ")
    graph = build_net("resnet50")
    layers = [StreamLayer(l.name, l.weights, 2.0 * l.weights, l.windows)
              for l in graph.layers]
    h100 = TpuLinkModel(**dataclasses.asdict(LinkModel()))
    plan = build_stream_plan(layers,
                             hbm_weight_budget_bytes=graph.total_weights // 3,
                             link=h100)
    assert got[-1] == (f"H100 streaming plan: {plan.n_slots} arena slots, "
                       f"overlap speedup {plan.overlap_speedup:.2f}× vs naive")


def test_schedule_explore_torch_prints_the_reference_lines():
    ref, got = run_pair("schedule_explore")
    assert len(ref) > 5
    assert got == ref
