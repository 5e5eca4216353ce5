"""The port's dense split training path (`launch.steps.split_shardings`)
on the CPU: dense GQA families under (2, 2), (1, 4) and (4, 1) meshes of
four gloo ranks (spawned `tests/split_mesh_worker.py` processes on a
`FileStore` under a temporary directory, once per mesh; no port is
opened), each rank holding its block of the params and AdamW state and
computing its block of the batch, heads, ff and vocab with a
sequence-split residual stream:

  * one `make_train_step` step on the reference trainer's weights (bf16
    matrices) and `make_batch`'s batch against the port's one-process
    step, at the reference's tolerances, F32_TOL for f32 results and
    BF16_TOL for what bf16 products decide: loss and ce within F32_TOL
    relative; tokens and lr equal; the grad norm, a norm of bf16
    gradients, within BF16_TOL relative; the moments gathered whole, mu
    and |g| = sqrt(nu / 0.05), within BF16_TOL in relative norm over the
    whole state, and each leaf's least-squares factor to the one-process
    leaf within BF16_TOL of 1 (a share missing from a leaf's gradient or
    counted twice moves it by 1 / the shares); every param gathered whole
    within a bf16 ulp of the one-process step's where both first moments
    clear SIGN_FLOOR with one sign (Adam's first step moves those by
    exactly the lr), which must be HELD_SHARE of the elements whose
    one-process moment clears it, and within 2 lr everywhere.  A
    tensor-parallel rank rounds its partial products to bf16 before they
    are summed, where one process rounds the whole sum once, so the
    gradient leaves part from the one-process step's more under `model`
    2 or 4 than under `data` alone, and a small leaf's relative error can
    pass BF16_TOL by rounding alone: each leaf is held by its
    least-squares factor;
  * configs: gemma-7b smoke (4 heads), qwen3-32b smoke (qk-norm, 2 KV
    heads under `model` 4: a rank's query head reads a KV head another
    rank stores) and qwen3-32b smoke with 6 query heads and 3 KV heads:
    under `model` 2 a rank's 3 query heads read parts of two KV groups
    (each gets its own copy of the KV head it reads), under `model` 4
    they do not divide (every model rank computes every head and keeps
    its sequence block);
  * each rank holds only its blocks: the bytes of its params and moments
    equal `local_bytes` of their shardings;
  * the reference's own sharded step (`jax.jit` of its `make_train_step`
    with the param, opt and batch shardings under `use_mesh` of a 2 x 2
    debug mesh over four forced host devices, in a subprocess) against
    the port's 2 x 2 step on loss (F32_TOL) and grad norm (BF16_TOL);
  * a 1 x 1 mesh (one gloo rank on an in-process store) takes the split
    path, its collectives running over one-rank groups;
  * the 2 x 2 state's checkpoint (saved with its shardings, written once
    by rank 0) restores without a mesh to the gathered state, and the
    trainer under `--mesh debug` checkpoints and resumes a split state,
    printing the lines of a run without a mesh;
  * `place` refuses an uneven split, naming the leaf and the axis, and
    `head_plan` gives each rank whole query heads and the KV heads they
    read.
"""
import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.serving  # noqa: F401  (before launch.steps)
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import make_train_step, param_shardings
from repro_torch.nn import layers
from repro_torch.nn.attention import head_plan
from repro_torch.nn.model import init_params
from repro_torch.optim import adamw_init
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (MeshCtx, NamedSharding,
                                           PartitionSpec, gather_whole, place,
                                           splitting, use_ctx, use_mesh)
from repro_torch.tree import tree_flatten

from split_mesh_worker import (BF16_TOL, F32_TOL, case_config,
                               check_split_step, finish, one_process,
                               run_meshes, start_reference, write_inputs)

MESHES = [(2, 2), (1, 4), (4, 1)]
B, S = 4, 16
STEP = dict(lr=1e-3, warmup=4, total=100, step=3)
CASES = [
    dict(name="gemma", arch="gemma-7b", ckpt=True, **STEP),
    dict(name="qwen3", arch="qwen3-32b", **STEP),
    dict(name="heads6", arch="qwen3-32b",
         replace=dict(name="qwen3-smoke-h6kv3", n_heads=6, n_kv_heads=3),
         **STEP),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's four ranks, the reference's 2 x 2 step and the port's
    one-process step of every case, run once for the module."""
    tmp = tmp_path_factory.mktemp("dense_mesh")
    inputs, whole = write_inputs(tmp / "in.npz", CASES, B, S)
    ref = start_reference(CASES[:1], B, S, STEP)
    try:
        outs = run_meshes(tmp, MESHES, tmp / "in.npz")
        ref_out, = finish([ref])
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    return {"meshes": outs,
            "ref": json.loads(ref_out.strip().splitlines()[-1])["gemma"],
            "one": one_process(CASES, inputs, whole)}


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_split_step_matches_the_one_process_step(runs, mesh, case):
    _, ranks = runs["meshes"][mesh]
    check_split_step(ranks, runs["one"][case], case, STEP["lr"])
    for o in ranks:
        assert float(o[f"{case}__m_aux"]) == 0.0


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_each_rank_holds_only_its_blocks(runs, mesh):
    _, ranks = runs["meshes"][mesh]
    n = mesh[0] * mesh[1]
    for case in CASES:
        c = case["name"]
        whole = sum(t.numel() * t.element_size() for t in tree_flatten(
            init_params(case_config(case), device="meta")))
        for o in ranks:
            assert int(o[f"{c}__held_params"]) == int(o[f"{c}__local_params"])
            assert int(o[f"{c}__held_opt"]) == int(o[f"{c}__local_opt"])
            # every matrix splits over both axes; norm scales stay whole
            assert int(o[f"{c}__held_params"]) < whole // n + 4 * 2048


def test_reference_sharded_step_matches_the_ports(runs):
    _, ranks = runs["meshes"][2, 2]
    ref = runs["ref"]
    for o in ranks:
        for k in ("loss", "ce", "grad_norm"):
            got = float(o[f"gemma__m_{k}"])
            tol = BF16_TOL if k == "grad_norm" else F32_TOL
            assert abs(got - ref[k]) <= tol * abs(ref[k]), (k, got, ref)
        assert float(o["gemma__m_tokens"]) == ref["tokens"]


def test_split_checkpoint_restores_without_a_mesh(runs):
    out, ranks = runs["meshes"][2, 2]
    case = CASES[0]
    cfg = case_config(case)
    params = init_params(cfg, seed=5, device="cpu")
    target = {"params": params, "opt": adamw_init(params)}
    state = restore_checkpoint(str(out / "ckpt_gemma"), 1, target)
    for i, t in enumerate(tree_flatten(state["params"])):
        np.testing.assert_array_equal(t.float().numpy(), ranks[0][f"gemma__p{i}"])
    for name in ("mu", "nu"):
        for i, t in enumerate(tree_flatten(getattr(state["opt"], name))):
            np.testing.assert_array_equal(t.numpy(),
                                          ranks[0][f"gemma__{name}{i}"])
    assert int(state["opt"].step) == 1


@pytest.fixture
def mesh11():
    mesh = make_debug_mesh(1, 1, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_one_by_one_mesh_takes_the_split_path(mesh11):
    """The 1 x 1 mesh's step runs the split path's collectives (over
    one-rank groups: the sequence gathers and scatters over `model`, the
    FSDP gathers over `data`) and equals the one-process step."""
    case = CASES[1]
    cfg = case_config(case)
    whole = init_params(cfg, seed=2, device="cpu")
    batch = {"tokens": torch.from_numpy(make_batch(
        cfg, DataConfig(seq_len=S, global_batch=2), 0)["tokens"])}
    step = make_train_step(cfg, peak_lr=1e-3, warmup=4, total=100)
    with use_mesh(mesh11):
        psh = param_shardings(cfg, mesh11)
        params = place(whole, psh)
        assert all(a is not b for a, b in zip(tree_flatten(params),
                                              tree_flatten(whole)))
        with collectives.recording_collectives() as recs:
            p2, o2, m = step(params, adamw_init(params), batch, 3)
        gathered = gather_whole(p2, psh)
    kinds = {(r[0], r.axis) for r in recs}
    assert {("all-gather", "model"), ("reduce-scatter", "model"),
            ("all-gather", "data"), ("reduce-scatter", "data")} <= kinds
    assert all(r[2] == 1 for r in recs)
    p3, _, m1 = step(whole, adamw_init(whole), batch, 3)
    # one rank sums no partials: f32 results at F32_TOL, params within a
    # bf16 ulp
    for k in ("loss", "ce", "grad_norm"):
        assert abs(float(m[k]) - float(m1[k])) <= F32_TOL * abs(float(m1[k]))
    for a, b in zip(tree_flatten(gathered), tree_flatten(p3)):
        a, b = a.float().numpy(), b.float().numpy()
        assert np.all(np.abs(a - b) <= np.abs(b) * 2.0 ** -7 + 1e-6)


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_embedding_gradient_sums_a_frequent_token_in_f32(split, request):
    """The table's gradient adds a token's occurrences in f32 and rounds
    its row once, on the whole path and on the split path's vocab-parallel
    lookup: 1,800 occurrences of a gradient near 1 sum to ~1,800, where
    adding each into the bf16 row stalls at 512 (a batch's blocks would
    then give the table different gradients)."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(64, 8, generator=gen).to(torch.bfloat16)
    table.requires_grad_(True)
    tokens = torch.zeros(2, 1024, dtype=torch.int32)
    tokens[:, ::8] = torch.randint(1, 64, (2, 128), generator=gen,
                                   dtype=torch.int32)
    g = (torch.rand(2, 1024, 8, generator=gen) * 0.5 + 0.75).to(
        torch.bfloat16)
    ctx = contextlib.nullcontext()
    if split:
        mesh = request.getfixturevalue("mesh11")
        ctx = use_ctx(splitting(MeshCtx(mesh), ()))
    with ctx:
        x = layers.embed({"table": table}, tokens, None)
    x.backward(g)
    want = torch.zeros(64, 8, dtype=torch.float64).index_add_(
        0, tokens.reshape(-1).long(), g.reshape(-1, 8).double())
    got = table.grad.double()
    assert float(want[0, 0]) > 1700
    assert torch.all((got - want).abs() <= want.abs() * 2.0 ** -7)


LINE = re.compile(r"step\s+(\d+) loss=(\S+) ce=(\S+) gnorm=(\S+) lr=(\S+)")


def _train(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["--arch", "gemma-7b", "--smoke", "--device", "cpu",
                        "--batch", "2", "--seq", "16", *argv])
    assert not dist.is_initialized()
    return {int(m.group(1)): [float(x) for x in m.group(2, 3, 4, 5)]
            for m in LINE.finditer(buf.getvalue())}, buf.getvalue()


def test_cli_mesh_debug_trains_split_and_resumes(tmp_path):
    """The trainer under `--mesh debug` on a dense family: the params and
    moments placed, two steps and a checkpoint (gathered, written by rank
    0), then a resume that places the restored leaves and prints steps 2
    and 3 as the uninterrupted run without a mesh prints them: loss and
    ce at F32_TOL plus one unit of their last printed digit (4
    decimals), the grad norm at BF16_TOL, the lr string equal."""
    want, _ = _train("--steps", "4")
    ck = str(tmp_path / "ck")
    _train("--steps", "2", "--mesh", "debug", "--ckpt-dir", ck)
    got, out = _train("--steps", "4", "--mesh", "debug", "--ckpt-dir", ck)
    assert "resumed from step 2" in out and sorted(got) == [2, 3]
    for step, (loss, ce, gn, lr) in got.items():
        loss_w, ce_w, gn_w, lr_w = want[step]
        assert abs(loss - loss_w) <= F32_TOL * loss_w + 1e-4, step
        assert abs(ce - ce_w) <= F32_TOL * ce_w + 1e-4, step
        assert abs(gn - gn_w) <= BF16_TOL * gn_w, step
        assert lr == lr_w


class _Mesh:
    """A stand-in DeviceMesh: this rank's coordinate on named axes."""
    mesh_dim_names = ("data", "model")

    def __init__(self, sizes, coord):
        self.sizes, self.coord = sizes, coord

    def size(self, i):
        return self.sizes[i]

    def get_coordinate(self):
        return list(self.coord)


def test_place_refuses_an_uneven_split():
    mesh = _Mesh((2, 4), (1, 3))
    tree = {"attn": {"w_q": torch.arange(60.0).reshape(6, 10)}}
    sh = {"attn": {"w_q": NamedSharding(mesh, PartitionSpec("data", "model"))}}
    with pytest.raises(ValueError, match=r"attn/w_q: dim 1 .* 'model'"):
        place(tree, sh)
    tree = {"attn": {"w_q": torch.arange(64.0).reshape(8, 8)}}
    got = place(tree, sh)["attn"]["w_q"]
    np.testing.assert_array_equal(got.numpy(),
                                  tree["attn"]["w_q"][4:8, 6:8].numpy())


@pytest.mark.parametrize("H,Hkv,model,rank,want", [
    (4, 4, 2, 1, (2, 2, [2, 3])),
    (4, 2, 4, 3, (3, 1, [1])),           # model > Hkv: a shared KV head
    (12, 3, 2, 1, (6, 6, [1, 1, 2, 2, 2, 2])),   # groups cut by the split
    (64, 8, 16, 5, (20, 4, [2, 2, 2, 2])),       # qwen3-32b on (16, 16)
    (3, 1, 2, 0, None),                  # heads do not divide: gathered
    (36, 36, 16, 0, None),               # minicpm-2b on (16, 16)
])
def test_head_plan(H, Hkv, model, rank, want):
    plan = head_plan(H, Hkv, model, rank)
    if want is None:
        assert plan is None
    else:
        assert (plan[0], plan[1], plan[2]) == want
