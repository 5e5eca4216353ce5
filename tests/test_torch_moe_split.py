"""The port's split training path for the MoE families
(`launch.steps.split_shardings`) on the CPU: deepseek-v2-lite smoke (MLA
attention, 4 heads, 8 experts top-2, 2 shared experts, a dense first
layer) and qwen3-moe smoke (GQA with qk-norm, 2 KV heads: under `model`
4 a rank's query head reads a KV head another rank stores) under (2, 2),
(1, 4) and (4, 1) meshes of four gloo ranks (spawned
`tests/split_mesh_worker.py` processes on a `FileStore`, once per mesh,
every case in each spawn; no port is opened).  Each rank holds its block
of the params and AdamW state, routes its own (B / data, S / model) block
of tokens through the all-to-all body, computes its block of the heads
(MLA's latents whole over `model`), the shared experts' and the dense
layer's ff and the vocab:

  * with `capacity_factor` raised to n_experts / moe_topk, so no token
    drops on any block, and the aux loss out of the loss (a function of
    the origin rank's block, not of the batch), one `make_train_step` step on the reference
    trainer's weights against the port's one-process step, by
    `tests/split_mesh_worker.py`'s measures; also deepseek with 6 heads, which
    split 3 a rank under `model` 2 and do not divide under `model` 4
    (every model rank computes every head and keeps its sequence block),
    and deepseek at 5 layers with the full config's grouped stack
    [dense, scan·4] under (2, 2), held against the one-card split step
    (the same expert-parallel body on the whole batch);
  * at the default capacity factor (tokens dropped by each block's
    capacity) the port's 2 x 2 step against the reference's own sharded
    step (`jax.jit` with the param, opt and batch shardings on four forced
    host devices, in a subprocess started beside the spawns): the same
    blocks, so the same drops; loss and aux within F32_TOL, the grad norm
    within BF16_TOL;
  * each rank holds only its blocks: the bytes of its params and moments
    equal `local_bytes` of their shardings;
  * a 1 x 1 mesh takes the split path for both families; the 2 x 2
    checkpoint restores without a mesh; the trainer under `--mesh debug`
    trains deepseek on the split path and resumes, printing the lines of
    the uninterrupted run under the same mesh;
  * the aux share: summed over the ranks, the origin rank's aux, with the
    mean of the ranks' aux gradients (the reference's transpose of its
    `out_specs P()`).
"""
import contextlib
import dataclasses as dc
import io
import json
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.serving  # noqa: F401  (before launch.steps)
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import make_train_step, split_shardings
from repro_torch.nn import moe as moe_mod
from repro_torch.nn.model import init_params
from repro_torch.optim import adamw_init
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (MeshCtx, flat_shardings,
                                           gather_whole, place, use_mesh)
from repro_torch.tree import tree_flatten

from split_mesh_worker import (BF16_TOL, F32_TOL, case_config,
                               check_split_step, finish, one_process,
                               run_meshes, start_reference, write_inputs)

MESHES = [(2, 2), (1, 4), (4, 1)]
B, S = 4, 16
STEP = dict(lr=1e-3, warmup=4, total=100, step=3)
# both smoke configs route top-2 of 8 experts: a capacity factor of 8 / 2
# gives every expert room for every token of its block.  The aux loss is
# a function of each block's tokens (the origin rank's, the reference's
# `out_specs P()`), not of the batch's, so it leaves the loss (weight 0):
# what is left is one function on every mesh
NO_DROP = dict(capacity_factor=4.0, router_aux_weight=0.0)
CASES = [
    dict(name="deepseek", arch="deepseek-v2-lite-16b", replace=NO_DROP,
         ckpt=True, **STEP),
    dict(name="qwen3moe", arch="qwen3-moe-235b-a22b", replace=NO_DROP,
         **STEP),
    dict(name="heads6", arch="deepseek-v2-lite-16b",
         replace=dict(NO_DROP, name="deepseek-smoke-h6", n_heads=6),
         meshes=[[2, 2], [1, 4]], **STEP),
    # the full config's grouped stack, [dense, scan·4]: the MoE layers'
    # (L, ...) leaves placed with their layer axis whole.  Over four MoE
    # layers the expert-parallel body (each expert's output rounded to
    # bf16, a token's picks summed in pick order) parts from the no-mesh
    # layer (f32, expert order) by more than the measures allow, so this
    # case is held against the one-card split step, which runs the same
    # body on the whole batch: with no drops, each token's function is
    # the same as on any mesh
    dict(name="stacked", arch="deepseek-v2-lite-16b",
         replace=dict(NO_DROP, name="deepseek-smoke-l5", n_layers=5,
                      scan_layers=True), meshes=[[2, 2]],
         one_card_split=True, **STEP),
]
# the default capacity factor, held against the reference's 2 x 2 step
DROP_CASES = [
    dict(name="deepseek_cf", arch="deepseek-v2-lite-16b", meshes=[[2, 2]],
         **STEP),
    dict(name="qwen3moe_cf", arch="qwen3-moe-235b-a22b", meshes=[[2, 2]],
         **STEP),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's four ranks, the reference's 2 x 2 steps and the port's
    one-process steps, run once for the module."""
    tmp = tmp_path_factory.mktemp("moe_split")
    inputs, whole = write_inputs(tmp / "in.npz", CASES + DROP_CASES, B, S)
    ref = start_reference(DROP_CASES, B, S, STEP)
    try:
        outs = run_meshes(tmp, MESHES, tmp / "in.npz")
        ref_out, = finish([ref])
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    return {"meshes": outs,
            "ref": json.loads(ref_out.strip().splitlines()[-1]),
            "one": one_process(CASES, inputs, whole)}


@pytest.mark.parametrize("mesh,c", [
    (m, c["name"]) for m in MESHES for c in CASES
    if list(m) in c.get("meshes", [list(m)])],
    ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v)
def test_no_drop_split_step_matches_the_one_process_step(runs, mesh, c):
    _, ranks = runs["meshes"][mesh]
    check_split_step(ranks, runs["one"][c], c, STEP["lr"])
    # every rank reports the origin rank's aux
    aux = {float(o[f"{c}__m_aux"]) for o in ranks}
    assert len(aux) == 1 and aux.pop() > 0


@pytest.mark.parametrize("case", DROP_CASES, ids=lambda c: c["name"])
def test_reference_sharded_step_matches_the_ports(runs, case):
    _, ranks = runs["meshes"][2, 2]
    ref = runs["ref"][case["name"]]
    for o in ranks:
        for k in ("loss", "ce", "aux", "grad_norm"):
            got = float(o[f"{case['name']}__m_{k}"])
            tol = BF16_TOL if k == "grad_norm" else F32_TOL
            assert abs(got - ref[k]) <= tol * abs(ref[k]), (k, got, ref)
        assert float(o[f"{case['name']}__m_tokens"]) == ref["tokens"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_each_rank_holds_only_its_blocks(runs, mesh):
    _, ranks = runs["meshes"][mesh]
    n = mesh[0] * mesh[1]
    for case in CASES[:2]:
        c = case["name"]
        whole = sum(t.numel() * t.element_size() for t in tree_flatten(
            init_params(case_config(case), device="meta")))
        for o in ranks:
            assert int(o[f"{c}__held_params"]) == int(o[f"{c}__local_params"])
            assert int(o[f"{c}__held_opt"]) == int(o[f"{c}__local_opt"])
            # the router, the norm scales and (under one axis) MLA's
            # latent projections are whole: far under twice the share
            assert int(o[f"{c}__held_params"]) < 2 * whole // n


def test_split_checkpoint_restores_without_a_mesh(runs):
    out, ranks = runs["meshes"][2, 2]
    cfg = case_config(CASES[0])
    params = init_params(cfg, seed=5, device="cpu")
    target = {"params": params, "opt": adamw_init(params)}
    state = restore_checkpoint(str(out / "ckpt_deepseek"), 1, target)
    for i, t in enumerate(tree_flatten(state["params"])):
        np.testing.assert_array_equal(t.float().numpy(),
                                      ranks[0][f"deepseek__p{i}"])
    for name in ("mu", "nu"):
        for i, t in enumerate(tree_flatten(getattr(state["opt"], name))):
            np.testing.assert_array_equal(t.numpy(),
                                          ranks[0][f"deepseek__{name}{i}"])
    assert int(state["opt"].step) == 1


def test_split_shardings_cover_the_moe_families():
    """Both MoE families split at full width (the shardings place every
    leaf of the param tree); the recurrent and input-mode families stay
    whole."""
    mesh = _StandIn((16, 16))
    for arch in ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"):
        sh = split_shardings(get_config(arch), mesh)
        assert sh is not None
        specs = [s.spec for s in flat_shardings(sh["params"])]
        assert len(specs) == len(tree_flatten(
            init_params(get_config(arch), device="meta")))
        # the stacked segment's expert stacks, its layer axis whole
        assert (None, "model", "data", None) in specs
    for arch in ("hymba-1.5b", "xlstm-350m", "hubert-xlarge",
                 "paligemma-3b"):
        assert split_shardings(get_config(arch), mesh) is None


@pytest.fixture
def mesh11():
    mesh = make_debug_mesh(1, 1, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_one_by_one_mesh_takes_the_split_path(mesh11, arch, monkeypatch):
    """The 1 x 1 mesh's step runs the split path (the MoE layer on the
    rank's block, its all-to-alls over one-rank `model` groups, no
    `_Replicated`) and, with no token dropped, equals the one-process
    step: loss and ce within F32_TOL, the grad norm within BF16_TOL (the
    one-process layer sums every expert in expert order, the body each
    token's picks in pick order), params within a bf16 ulp or 2 lr."""
    cfg = dc.replace(get_config(arch, smoke=True), **NO_DROP)
    whole = init_params(cfg, seed=2, device="cpu")
    batch = {"tokens": torch.from_numpy(make_batch(
        cfg, DataConfig(seq_len=S, global_batch=2), 0)["tokens"])}
    step = make_train_step(cfg, peak_lr=1e-3, warmup=4, total=100)
    replicated = []
    monkeypatch.setattr(moe_mod._Replicated, "apply",
                        lambda *a: replicated.append(1) or a[0])
    with use_mesh(mesh11):
        psh = split_shardings(cfg, mesh11)["params"]
        params = place(whole, psh)
        with collectives.recording_collectives() as recs:
            p2, _, m = step(params, adamw_init(params), batch, 3)
        gathered = gather_whole(p2, psh)
    assert not replicated
    kinds = {(r[0], r.axis) for r in recs}
    assert {("all-to-all", "model"), ("all-gather", "model"),
            ("reduce-scatter", "model"), ("all-gather", "data")} <= kinds
    assert all(r[2] == 1 for r in recs)
    p3, _, m1 = step(whole, adamw_init(whole), batch, 3)
    for k in ("loss", "ce", "grad_norm"):
        tol = BF16_TOL if k == "grad_norm" else F32_TOL
        assert abs(float(m[k]) - float(m1[k])) <= tol * abs(float(m1[k]))
    for a, b, a0 in zip(tree_flatten(gathered), tree_flatten(p3),
                        tree_flatten(whole)):
        a, b, a0 = a.float().numpy(), b.float().numpy(), a0.float().numpy()
        ulp = np.maximum(np.abs(a0), np.abs(b)) * 2.0 ** -7 + 1e-6
        assert np.all(np.abs(a - b) <= 2e-3 + ulp)


class _StandIn:
    """A stand-in DeviceMesh: named axes of the given sizes, this rank
    at `coord`, no process groups."""
    mesh_dim_names = ("data", "model")

    def __init__(self, sizes, coord=(0, 0)):
        self.sizes, self.coord = sizes, coord

    def size(self, i=None):
        return self.sizes[i] if i is not None else int(np.prod(self.sizes))

    def get_coordinate(self):
        return list(self.coord)

    def get_group(self, name):
        return None


def test_aux_share_counts_the_origin_once_with_the_mean_gradient():
    """Four ranks' shares of their aux losses: the sum is the origin
    rank's value, and each rank's share carries a quarter of its own aux's
    gradient."""
    x = torch.tensor([1.0, 2.0, 3.0, 4.0], requires_grad=True)
    shares = []
    for r in range(4):
        ctx = MeshCtx(_StandIn((2, 2), (r // 2, r % 2)))
        shares.append(moe_mod._aux_share(x[r] ** 2, ctx))
    total = sum(shares)
    assert float(total) == 1.0
    total.backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * x.detach().numpy() / 4)


LINE = re.compile(r"step\s+(\d+) loss=(\S+) ce=(\S+) gnorm=(\S+) lr=(\S+)")


def _train(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["--arch", "deepseek-v2-lite-16b", "--smoke",
                        "--device", "cpu", "--batch", "2", "--seq", "16",
                        *argv])
    assert not dist.is_initialized()
    return {int(m.group(1)): [float(x) for x in m.group(2, 3, 4, 5)]
            for m in LINE.finditer(buf.getvalue())}, buf.getvalue()


def test_cli_mesh_debug_trains_split_and_resumes(tmp_path, monkeypatch):
    """The trainer under `--mesh debug` on deepseek smoke: the params and
    moments placed (the split path: no `_Replicated`), two steps and a
    checkpoint (gathered, written by rank 0), then a resume that places
    the restored leaves and prints steps 2 and 3 as the uninterrupted run
    under the same mesh prints them.  (The run without a mesh evaluates
    every expert on every token, where the mesh drops tokens past each
    expert's capacity: `tests/test_torch_mesh.py` holds this CLI against
    the reference CLI under its own debug mesh.)"""
    replicated = []
    monkeypatch.setattr(moe_mod._Replicated, "apply",
                        lambda *a: replicated.append(1) or a[0])
    want, _ = _train("--steps", "4", "--mesh", "debug")
    ck = str(tmp_path / "ck")
    _train("--steps", "2", "--mesh", "debug", "--ckpt-dir", ck)
    got, out = _train("--steps", "4", "--mesh", "debug", "--ckpt-dir", ck)
    assert not replicated
    assert "resumed from step 2" in out and sorted(got) == [2, 3]
    for step in got:
        assert got[step] == want[step], step
