"""`examples/serve_stream_torch.py` against `examples/serve_stream.py` on
the CPU, both in subprocesses (the reference under `JAX_PLATFORMS=cpu`).
The arm is given the reference's `init_params(PRNGKey(0), cfg)` by
monkeypatching its `init_params`, as the reference's f32 values: the
streaming store and the weight arena quantize what they are given, and
`params_from_reference`'s bf16 rounding moves codes (the installs' wire
bytes by a few), while the port's model casts every matrix to bf16 at use
as the reference does.  The reference's streaming executor plans on a
`TpuLinkModel` carrying the port's H100 `LinkModel` figures, so the plan
line differs in the link's name alone.

Every line must then be equal but for wall-clock fields (ms, tok/s) and
the streamed forward's error against the resident model, which is held
within 2e-2 of the reference's."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
ERR_TOL = 2e-2

REF_RUNNER = """
import dataclasses, runpy
from repro.streaming import executor, plan
from repro_torch.streaming.plan import LinkModel
executor.StreamingExecutor.__init__.__kwdefaults__["link"] = \\
    plan.TpuLinkModel(**dataclasses.asdict(LinkModel()))
runpy.run_path("examples/serve_stream.py", run_name="__main__")
"""

PORT_RUNNER = """
import dataclasses, importlib.util
import jax, numpy as np, torch
from repro.configs import get_config
from repro.nn.model import init_params
from repro_torch.tree import tree_map
spec = importlib.util.spec_from_file_location(
    "serve_stream_torch", "examples/serve_stream_torch.py")
arm = importlib.util.module_from_spec(spec)
spec.loader.exec_module(arm)
cfg = dataclasses.replace(get_config("gemma-7b", smoke=True), n_layers=6,
                          scan_layers=False)
ref = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))

def carried(cfg, seed=0, device="cuda"):
    assert seed == 0
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), ref)

arm.init_params = carried
arm.main("cpu")
"""


def _wall_clock_masked(line):
    line = re.sub(r"\d+(\.\d+)?(/\d+(\.\d+)?)? ms\b", "<ms>", line)
    return re.sub(r"\d+(\.\d+)? tok/s", "<tok/s>", line)


def _parts(lines):
    """(streaming lines, two-tenant lines, paged lines)."""
    a = next(i for i, l in enumerate(lines) if l.startswith("serving 6 "))
    b = next(i for i, l in enumerate(lines) if l.startswith("serving 5 "))
    return lines[:a], lines[a:b], lines[b:]


@pytest.fixture(scope="module")
def outputs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for code in (REF_RUNNER, PORT_RUNNER)]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, stderr[-4000:]
        out.append(_parts(stdout.splitlines()))
    return out


def test_streamed_forward_matches_reference(outputs):
    (ref, *_), (got, *_) = outputs
    assert len(got) == len(ref) == 4          # 3 lines and a blank
    pattern = r"streamed forward matches resident model to ([\d.]+) "
    err_ref = float(re.match(pattern, ref[0]).group(1))
    err = float(re.match(pattern, got[0]).group(1))
    assert abs(err - err_ref) <= ERR_TOL, (err, err_ref)
    assert got[1] == ref[1]                   # raw, wire bytes, skip, center
    assert ref[2].endswith(" on TPU link")
    assert got[2] == ref[2][:-len("TPU link")] + "H100 link"


@pytest.mark.parametrize("part", [1, 2], ids=["two_tenants", "paged_kv"])
def test_serving_lines_match_reference(outputs, part):
    ref, got = outputs[0][part], outputs[1][part]
    assert len(ref) > 5
    assert [_wall_clock_masked(l) for l in got] == \
        [_wall_clock_masked(l) for l in ref]
