"""The port's dense split training path (`launch.steps.split_shardings`)
on the CPU: dense GQA families under (2, 2), (1, 4) and (4, 1) meshes of
four gloo ranks (spawned `tests/dense_mesh_worker.py` processes on a
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
import dataclasses as dc
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_config
from repro.nn.model import init_params as ref_init_params
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
from repro_torch.tree import tree_flatten, tree_unflatten

from dense_mesh_worker import case_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [(2, 2), (1, 4), (4, 1)]
B, S = 4, 16
F32_TOL = 3e-4
BF16_TOL = 2e-2
SIGN_FLOOR = 1e-6
HELD_SHARE = 0.99
STEP = dict(lr=1e-3, warmup=4, total=100, step=3)
CASES = [
    dict(name="gemma", arch="gemma-7b", ckpt=True, **STEP),
    dict(name="qwen3", arch="qwen3-32b", **STEP),
    dict(name="heads6", arch="qwen3-32b",
         replace=dict(name="qwen3-smoke-h6kv3", n_heads=6, n_kv_heads=3),
         **STEP),
]

# the reference's sharded step, as the test prints it (a fresh process:
# the forced device count must be set before jax starts)
REF_STEP = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.data.pipeline import DataConfig, make_batch
from repro.launch.mesh import make_debug_mesh
from repro.launch.steps import (batch_shardings, make_train_step,
                                opt_shardings, param_shardings)
from repro.nn.model import init_params
from repro.optim.adamw import adamw_init
from repro.parallel.sharding import use_mesh
arch, B, S, lr, warmup, total, step = json.loads(sys.argv[1])
cfg = get_config(arch, smoke=True)
p = init_params(jax.random.PRNGKey(0), cfg)
p = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                 if jnp.issubdtype(a.dtype, jnp.floating) and a.ndim >= 2
                 else a, p)
batch = {k: jnp.asarray(v) for k, v in make_batch(
    cfg, DataConfig(seq_len=S, global_batch=B), 0).items()}
mesh = make_debug_mesh(2, 2)
with use_mesh(mesh):
    psh = param_shardings(cfg, mesh)
    osh = opt_shardings(psh, mesh)
    bsh = batch_shardings(cfg, mesh)
    bsh = {k: bsh[k] for k in batch}
    fn = jax.jit(make_train_step(cfg, peak_lr=lr, warmup=warmup, total=total),
                 in_shardings=(psh, osh, bsh, None),
                 out_shardings=(psh, osh, None))
    _, _, m = fn(p, adamw_init(p), batch, jnp.int32(step))
print(json.dumps({k: float(v) for k, v in m.items()}))
"""


def _bf16_leaves(arch_case):
    """The reference trainer's params for a case: whole, bf16 matrices."""
    cfg = case_config(arch_case)
    rcfg = dc.replace(ref_config(arch_case["arch"], smoke=True),
                      **arch_case.get("replace", {}))
    p = ref_init_params(jax.random.PRNGKey(0), rcfg)
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                     if jnp.issubdtype(a.dtype, jnp.floating) and a.ndim >= 2
                     else a, p)
    leaves = [np.asarray(a) for a in jax.tree.leaves(p)]
    like = tree_flatten(init_params(cfg, device="meta"))
    assert [tuple(a.shape) for a in leaves] == [tuple(t.shape) for t in like]
    return leaves


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _spawn(tmp, data, model, inputs):
    out = tmp / f"mesh{data}x{model}"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "dense_mesh_worker.py"),
         str(out / "store"), str(r), str(data), str(model), str(inputs),
         str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(data * model)]
    return out, procs


def _wait(procs, timeout=240):
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append((p.returncode, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _ in errs), errs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's four ranks, the reference's 2 x 2 step and the port's
    one-process step of every case, run once for the module."""
    tmp = tmp_path_factory.mktemp("dense_mesh")
    inputs, whole = {"cases": json.dumps(CASES)}, {}
    for case in CASES:
        c = case["name"]
        leaves = _bf16_leaves(case)
        whole[c] = leaves
        inputs[f"{c}__dtypes"] = json.dumps([a.dtype.name for a in leaves])
        for i, a in enumerate(leaves):
            inputs[f"{c}__p{i}"] = (a.view(np.uint16)
                                    if a.dtype.name == "bfloat16" else a)
        inputs[f"{c}__tokens"] = make_batch(
            case_config(case), DataConfig(seq_len=S, global_batch=B),
            0)["tokens"]
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_STEP, json.dumps(
            ["gemma-7b", B, S, STEP["lr"], STEP["warmup"], STEP["total"],
             STEP["step"]])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    outs = {}
    try:
        for data, model in MESHES:
            out, procs = _spawn(tmp, data, model, tmp / "in.npz")
            _wait(procs)
            outs[data, model] = (out, [dict(np.load(out / f"r{r}.npz"))
                                       for r in range(data * model)])
        ref_out, ref_err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, ref_err[-3000:]
    one = {}
    for case in CASES:
        c = case["name"]
        cfg = case_config(case)
        like = init_params(cfg, device="meta")
        params = tree_unflatten(like, [_torch(a) for a in whole[c]])
        batch = {"tokens": torch.from_numpy(inputs[f"{c}__tokens"])}
        step = make_train_step(cfg, peak_lr=case["lr"],
                               warmup=case["warmup"], total=case["total"])
        p0 = [t.float().numpy() for t in tree_flatten(params)]
        p2, o2, m = step(params, adamw_init(params), batch, case["step"])
        one[c] = {"p0": p0, "p": tree_flatten(p2), "mu": tree_flatten(o2.mu),
                  "nu": tree_flatten(o2.nu), "m": m}
    return {"meshes": outs, "ref": json.loads(ref_out.strip()
                                              .splitlines()[-1]),
            "one": one}


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_split_step_matches_the_one_process_step(runs, mesh, case):
    _, ranks = runs["meshes"][mesh]
    one = runs["one"][case]
    for r, o in enumerate(ranks):
        for k in ("loss", "ce", "grad_norm"):
            want = float(one["m"][k])
            got = float(o[f"{case}__m_{k}"])
            tol = BF16_TOL if k == "grad_norm" else F32_TOL
            assert abs(got - want) <= tol * abs(want), (r, k, got, want)
        assert float(o[f"{case}__m_tokens"]) == float(one["m"]["tokens"])
        assert float(o[f"{case}__m_aux"]) == 0.0
        assert float(o[f"{case}__m_lr"]) == float(one["m"]["lr"])
    o = ranks[0]
    assert int(o[f"{case}__opt_step"]) == 1
    for name in ("mu", "nu"):
        got = [o[f"{case}__{name}{i}"] for i in range(len(one[name]))]
        want = [w.numpy() for w in one[name]]
        if name == "nu":                  # |g|: nu is 0.05 g^2
            got, want = [np.sqrt(a) for a in got], [np.sqrt(a) for a in want]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape
            # the least-squares factor from the one-process leaf to this
            # one: a missing or doubled share moves it by 1 / the shares
            scale = float(np.vdot(g, w) / max(np.vdot(w, w), 1e-30))
            assert abs(scale - 1.0) <= BF16_TOL, (name, i, scale)
        err = np.sqrt(sum(np.sum((g - w) ** 2) for g, w in zip(got, want)))
        ref = np.sqrt(sum(np.sum(w ** 2) for w in want))
        assert err <= BF16_TOL * ref, (name, err / ref)
    held = eligible = 0
    for i, (a0, w, m) in enumerate(zip(one["p0"], one["p"], one["mu"])):
        got, w, m = o[f"{case}__p{i}"], w.float().numpy(), m.numpy()
        mu = o[f"{case}__mu{i}"]
        assert got.shape == w.shape
        clear = np.abs(m) > SIGN_FLOOR
        sure = clear & (np.sign(mu) == np.sign(m)) & (np.abs(mu) > SIGN_FLOOR)
        # a bf16 ulp of the larger of p and the one-process p2
        ulp = np.maximum(np.abs(a0), np.abs(w)) * 2.0 ** -7 + 1e-3 * STEP["lr"]
        assert np.all(np.abs(got - w)[sure] <= ulp[sure]), i
        assert np.all(np.abs(got - w) <= 2 * STEP["lr"] + ulp), i
        held += int(sure.sum())
        eligible += int(clear.sum())
    assert held >= HELD_SHARE * eligible, (held, eligible)


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
