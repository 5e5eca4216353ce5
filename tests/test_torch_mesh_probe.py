"""`mesh_probe.py`'s rehearsal on the CPU (`--cpu`): four gloo ranks run
its cases at smoke size: the two dense ones on (2, 2), (1, 4) and (4, 1)
(the 6-head case on (2, 2) and (1, 4)) with rank 0's whole and
batch-blocked no-mesh steps; deepseek-v2-lite cut to 4 layers with no
token dropped on the three meshes, with rank 0's no-mesh step and its
one-card split step on a 1 x 1 mesh (which decides); deepseek-v2-lite
whole on the three meshes and qwen3-moe on (2, 2) and (1, 4), with no
one-card step; and the leaf-by-leaf comparison of each held mesh's
gathered state, in one subprocess (~30 s), so the script the cards run is
checked here too."""
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
    assert len(meshed) == 4 * (5 + 8) and all(x["ok"] for x in meshed)
    # rank 0 holds each dense mesh's state against the whole step, and a
    # mesh with a data axis against the step in as many batch blocks too;
    # the no-drop MoE case's against the one-card split step (and the
    # no-mesh step beside it); the other MoE cases have no one-card step
    for x in meshed:
        if x["rank"] != 0:
            continue
        if x["case"].startswith("minicpm"):
            want = {"whole"} | ({f"blocks{x['mesh'][0]}"}
                                if x["mesh"][0] > 1 else set())
            assert set(x["state"]) == want
            assert all(v["ok"] for v in x["state"].values())
        elif x["case"] == "deepseek-v2-lite-16b@4":
            assert set(x["state"]) == {"whole", "one_card_split"}
            assert x["state"]["one_card_split"]["ok"]
        else:
            assert "state" not in x and len(x["runs"]) == 2
