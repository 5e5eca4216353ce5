"""The port stands alone: importing every module of `repro_torch` loads no
jax and no module of the reference package `repro`, and neither the port's
sources, its example arms (`examples/*_torch.py`) nor `chip_smoke.py` name
them in an import.  `repro_torch.core` and `repro_torch.sim` import each
other (the scheduler runs the simulator): either may be imported first."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference_module():
    code = (
        "import importlib, sys\n"
        f"for name in {list(_modules())!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_name_no_jax_or_reference_import():
    pattern = re.compile(r"^\s*(import jax\b|from jax\b|from repro\.|"
                         r"import repro\.|from repro import|import repro\b)",
                         re.M)
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(examples) >= 3
    files = sorted(PORT.rglob("*.py")) + examples + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("first", ["repro_torch.sim", "repro_torch.sim.aras",
                                   "repro_torch.core",
                                   "repro_torch.core.scheduler",
                                   "repro_torch.serving.engine"])
def test_the_core_sim_cycle_imports_from_either_side(first):
    code = (f"import {first}\n"
            "from repro_torch.core import build_schedule\n"
            "from repro_torch.sim import simulate_aras, simulate_tpu\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
