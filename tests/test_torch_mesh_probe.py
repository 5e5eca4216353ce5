"""`mesh_probe.py`'s rehearsal on the CPU (`--cpu`): four gloo ranks run
its two cases at smoke size on (2, 2), (1, 4) and (4, 1) (the 6-head case
on (2, 2) and (1, 4)), rank 0's whole and batch-blocked no-mesh steps, and
the leaf-by-leaf comparison of each mesh's gathered state, in one
subprocess (~15 s), so the script the cards run is checked here too."""
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_mesh_probe_rehearsal_holds_every_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "mesh_probe.py"), "--cpu", "--ranks",
         "4", "--out", str(tmp_path / "probe.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:] + out.stdout[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert lines[-1]["ok"] and lines[-1]["ranks"] == 4
    meshed = [x for x in lines[:-1] if x["mesh"] is not None]
    assert len(meshed) == 4 * 5 and all(x["ok"] for x in meshed)
    # rank 0 holds each mesh's state against the whole step, and a mesh
    # with a data axis against the step in as many batch blocks too
    for x in meshed:
        if x["rank"] == 0:
            want = {"whole"} | ({f"blocks{x['mesh'][0]}"}
                                if x["mesh"][0] > 1 else set())
            assert set(x["state"]) == want
            assert all(v["ok"] for v in x["state"].values())
