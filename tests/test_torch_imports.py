"""The port stands alone: importing every module of `repro_torch` loads no
jax and no module of the reference package `repro`, and neither the port's
sources, its example arms (`examples/*_torch.py`) nor `chip_smoke.py` name
them in an import.  `repro_torch.core` and `repro_torch.sim` import each
other (the scheduler runs the simulator): either may be imported first.
The mesh layer's modules (`parallel/`, `launch/{mesh,shapes}.py`) each
import alone with the reference's names (the port's own collectives
module with the names the model code takes from it), and so do
`launch.steps`, the dry run and the roofline package, none of them
loading the fake process group."""
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
    assert len(examples) >= 4
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


# the mesh layer's modules and the reference names each keeps
MESH_MODULES = {
    "repro_torch.parallel": ("MeshCtx", "batch_axes", "current_mesh",
                             "make_spec", "set_mesh", "shard", "use_mesh"),
    "repro_torch.parallel.sharding": ("_LOGICAL", "_resolve",
                                      "named_sharding", "NamedSharding",
                                      "PartitionSpec"),
    "repro_torch.parallel.collectives": (
        "all_gather", "reduce_scatter", "all_reduce", "all_reduce_max",
        "psum", "recording_collectives", "_GatherBlocks", "_Psum",
        "_Replicated"),
    "repro_torch.parallel.compression": (
        "BLOCK", "_quantize_blockwise", "_dequantize_blockwise",
        "compressed_psum_pod", "compression_ratio_bytes"),
    "repro_torch.launch.mesh": ("make_production_mesh", "make_debug_mesh"),
    "repro_torch.launch.shapes": ("SHAPES", "ShapeSpec"),
}


@pytest.mark.parametrize("module", sorted(MESH_MODULES))
def test_the_mesh_layer_modules_import_alone(module):
    """Each imports by itself, with the reference's names, loading no jax
    and no reference module and starting no process group."""
    code = (f"import importlib, sys\n"
            f"m = importlib.import_module({module!r})\n"
            f"missing = [n for n in {MESH_MODULES[module]!r} "
            f"if not hasattr(m, n)]\n"
            "import torch.distributed as dist\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or "
            "n.startswith('jax.') or n == 'repro' or "
            "n.startswith('repro.'))\n"
            "print(missing, bad, dist.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] [] False", out.stdout


@pytest.mark.parametrize("module", ["repro_torch.launch.steps",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.roofline"])
def test_the_step_and_dry_run_modules_import_alone(module):
    """Each imports first in a fresh process (`launch.steps` imports the
    sampler inside the functions that use it, so `serving`, which imports
    `steps`, is not loaded half-way), loading no jax, no reference module
    and not the fake process group, and starting no process group."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "import torch.distributed as dist\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or "
            "n.startswith('jax.') or n == 'repro' or "
            "n.startswith('repro.') or n.endswith('fake_pg'))\n"
            "print(bad, dist.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False", out.stdout
