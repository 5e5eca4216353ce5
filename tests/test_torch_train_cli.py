"""The port's checkpoints, straggler timer and training CLI against the
reference's: the checkpoint round trip, atomic rename and shape check of
`tests/test_optim_data_ckpt.py`; each package restoring the other's
trainer checkpoint leaf for leaf; `StepTimer` on the same times; the
CLI's run-and-resume of `tests/test_system.py`; and the port CLI resuming
a checkpoint the reference CLI wrote, printing the reference CLI's own
resumed step lines (loss and ce within 1e-4 relative, gnorm within 3e-2,
lr equal)."""
import dataclasses
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.ft import StepTimer as RefStepTimer
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint, wait_for_saves)
from repro_torch.ft import StepTimer
from repro_torch.launch.train import cast_for_training
from repro_torch.nn.model import init_params
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_flatten, tree_map

from train_pair import configs, ref_params, to_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
LINE = re.compile(r"step\s+(\d+) loss=(\S+) ce=(\S+) gnorm=(\S+) lr=(\S+)")


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)},
            "h": torch.linspace(-3, 3, 7).to(torch.bfloat16)}
    d = str(tmp_path)
    save_checkpoint(d, 10, tree)
    save_checkpoint(d, 20, tree, block=False)
    wait_for_saves()
    assert latest_step(d) == 20
    assert latest_step(str(tmp_path / "none")) is None
    assert not any(p.endswith(".tmp") for p in os.listdir(d))
    out = restore_checkpoint(d, 10, tree_map(torch.zeros_like, tree))
    for a, b in zip(tree_flatten(out), tree_flatten(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_keeps_the_state_it_was_given(tmp_path):
    """An async save of CPU tensors writes the values at the call, not
    what the next step's in-place AdamW update leaves in them: the
    writer is held back until the update has run."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.optim import adamw_update
    params = {"w": torch.linspace(-1, 1, 24).reshape(4, 6).to(torch.bfloat16),
              "b": torch.linspace(0, 1, 6)}
    state = {"params": params, "opt": adamw_init(params)}
    before = [t.clone() for t in tree_flatten(state)]
    d = str(tmp_path)
    with ckpt._SAVE_LOCK:
        save_checkpoint(d, 3, state, block=False)
        grads = tree_map(lambda p: torch.full_like(p, 0.5), params)
        adamw_update(params, grads, state["opt"], 1e-2)
    wait_for_saves()
    after = tree_flatten(state)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    zeros = tree_map(torch.zeros_like, params)
    out = restore_checkpoint(d, 3, {"params": zeros,
                                    "opt": adamw_init(zeros)})
    for a, b in zip(tree_flatten(out), before):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"a": torch.ones(2, 2)})
    with pytest.raises(ValueError):
        restore_checkpoint(d, 1, {"a": torch.ones(3, 3)})


def _port_state(arch):
    cfg = configs(arch)[1]
    params = cast_for_training(init_params(cfg, seed=3, device="cpu"))
    opt = adamw_init(params)
    opt.step.fill_(7)
    for t in tree_flatten(opt.mu) + tree_flatten(opt.nu):
        t.normal_(generator=torch.Generator().manual_seed(t.numel()))
    return {"params": params, "opt": opt}


def _ref_state(arch):
    params = ref_params(arch)
    opt = ref_adamw_init(params)
    key = jax.random.PRNGKey(1)
    opt = jax.tree.map(lambda a: a + jax.random.normal(key, a.shape, a.dtype)
                       if a.ndim else a + 5, opt)
    return {"params": params, "opt": opt}


def _equal_leaves(port_tree, ref_tree):
    ref = [np.asarray(x) for x in jax.tree.leaves(ref_tree)]
    mine = tree_flatten(port_tree)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.bfloat16:
            assert b.dtype.name == "bfloat16"
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v2-lite-16b"])
def test_each_package_restores_the_others_checkpoint(arch, tmp_path):
    """Leaves in jax's flatten order (opt.step, opt.mu…, opt.nu…,
    params…): 61 of them for minicpm-2b smoke."""
    port = _port_state(arch)
    ref = _ref_state(arch)
    if arch == "minicpm-2b":
        assert len(tree_flatten(port)) == len(jax.tree.leaves(ref)) == 61
    save_checkpoint(str(tmp_path / "port"), 7, port)
    got = ref_restore(str(tmp_path / "port"), 7, ref)
    _equal_leaves(port, got)
    ref_save(str(tmp_path / "ref"), 9, ref)
    target = _port_state(arch)
    got = restore_checkpoint(str(tmp_path / "ref"), 9, target)
    _equal_leaves(got, ref)
    assert int(got["opt"].step) == 5


def test_step_timer_matches_the_reference(monkeypatch):
    """Both timers fed one clock: stop() times, EWMAs, reports and
    history agree, and a slow host is flagged."""
    now = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    mine, ref = StepTimer(), RefStepTimer()
    for step, dt in enumerate([0.010, 0.011, 0.030, 0.012, 0.050, 0.009]):
        mine.start(), ref.start()
        now[0] += dt
        assert mine.stop() == ref.stop()
        hosts = {"host1": 0.02 * (step + 1), "host2": 0.01}
        mine.observe(hosts), ref.observe(hosts)
        a, b = mine.report(step), ref.report(step)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        now[0] += 1.0
    assert mine.history == ref.history and mine.ewma == ref.ewma
    assert mine.report(5).flagged


def test_straggler_flagging():
    """tests/test_sharding_and_ft.py's case on the port's timer."""
    t = StepTimer(ewma_alpha=1.0, threshold=1.5)
    t.observe({"h0": 1.0, "h1": 1.0, "h2": 1.0, "h3": 5.0})
    rep = t.report(1)
    assert rep.flagged and "h3" in rep.slowest


def _cli(module, *args, device=True, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    extra = ("--device", "cpu") if device else ()
    r = subprocess.run([sys.executable, "-m", module, "--arch", "minicpm-2b",
                        "--smoke", "--batch", "2", "--seq", "32", *args,
                        *extra], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_cli_runs_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    out = _cli("repro_torch.launch.train", "--steps", "4", "--ckpt-dir", ck,
               "--ckpt-every", "2")
    assert "step     3" in out and out.strip().endswith("done")
    assert latest_step(ck) == 4 and os.path.isdir(os.path.join(ck, "step_2"))
    out = _cli("repro_torch.launch.train", "--steps", "6", "--ckpt-dir", ck)
    assert "resumed from step 4" in out
    assert "step     3" not in out and "step     5" in out


def test_cli_watchdog_writes_an_emergency_checkpoint(tmp_path):
    """A step that overruns --watchdog-s fires the watchdog, whose action
    saves a checkpoint at that step, as the reference trainer's does."""
    ck = str(tmp_path / "ck")
    out = _cli("repro_torch.launch.train", "--steps", "2", "--ckpt-dir", ck,
               "--watchdog-s", "0.001")
    assert "WATCHDOG: step 0 hung; emergency checkpoint" in out
    assert os.path.isdir(os.path.join(ck, "step_0"))
    assert latest_step(ck) == 2


def _steps(out):
    return {int(m.group(1)): [float(x) for x in m.group(2, 3, 4, 5)]
            for m in LINE.finditer(out)}


def test_cli_resumes_a_reference_checkpoint_as_the_reference_does(tmp_path):
    """The reference CLI trains steps 0-1 and checkpoints step 2; the
    reference CLI and the port CLI each resume a copy of it to step 4."""
    ck, mine = tmp_path / "ck", tmp_path / "mine"
    _cli("repro.launch.train", "--steps", "2", "--ckpt-dir", str(ck),
         device=False)
    shutil.copytree(ck / "step_2", mine / "step_2")
    ref_out = _cli("repro.launch.train", "--steps", "4", "--ckpt-dir",
                   str(ck), device=False)
    out = _cli("repro_torch.launch.train", "--steps", "4", "--ckpt-dir",
               str(mine))
    assert "resumed from step 2" in out and "resumed from step 2" in ref_out
    got, want = _steps(out), _steps(ref_out)
    assert sorted(got) == sorted(want) == [2, 3]
    for s in want:
        (loss, ce, gn, lr), (loss_r, ce_r, gn_r, lr_r) = got[s], want[s]
        assert abs(loss - loss_r) <= max(1e-4 * loss_r, 1e-4)
        assert abs(ce - ce_r) <= max(1e-4 * ce_r, 1e-4)
        assert abs(gn - gn_r) <= 3e-2 * gn_r
        assert lr == lr_r
    # the port's final checkpoint restores in the reference package
    params = ref_params("minicpm-2b")
    restored = ref_restore(str(mine), 4, {"params": params,
                                          "opt": ref_adamw_init(params)})
    assert int(restored["opt"].step) == 4
    assert all(bool(jnp.all(jnp.isfinite(x.astype(jnp.float32))))
               for x in jax.tree.leaves(restored))


def test_example_arm_trains_and_checkpoints(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, str(ROOT / "examples" /
                                            "train_lm_torch.py"),
                        "--arch", "minicpm-2b", "--device", "cpu",
                        "--steps", "3"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "step     2" in r.stdout and "done" in r.stdout
    assert latest_step(str(tmp_path / "repro_torch_train_ck")) == 3
