"""The split training step's CPU runs over gloo meshes (not a test file):
one rank of a mesh when run as a script, and the test side's set-up when
`tests/test_torch_dense_mesh.py` and `tests/test_torch_moe_split.py`
import it.

As a script, one of DATA x MODEL ranks over gloo and a `FileStore` (no
port is opened):

    python tests/split_mesh_worker.py STORE RANK DATA MODEL IN.npz OUT_DIR

IN.npz holds `cases` (JSON: each case's smoke arch, its config overrides,
the step's lr, warmup, total and step number, whether to checkpoint it,
and optionally the [data, model] meshes it runs on, every mesh by
default) and, per case `c`, the whole params as `c__p<i>` in `tree_flatten`
order (bf16 leaves as their uint16 bits, `c__dtypes` naming each leaf's
dtype) and the global batch's `c__tokens`.  Under a (DATA, MODEL) debug
mesh the rank places the params into its blocks, runs one
`make_train_step` step on the global batch, and writes
OUT_DIR/r<RANK>.npz: per case the step's metrics, the bytes its param and
moment blocks hold beside `local_bytes` of their shardings, and (rank 0)
every param and moment gathered whole.  A case marked `ckpt` is also
saved under OUT_DIR/ckpt_<case> with its shardings (rank 0 writes it).

Imported, it gives the reference trainer's weights for a case, the
spawned ranks of each mesh, the reference's own sharded step in a
subprocess on four forced host devices, the port's one-process step, and
the measures the split step is held to against it:

  * loss and ce within F32_TOL relative, tokens and lr equal, the grad
    norm (a norm of bf16 gradients) within BF16_TOL relative;
  * the moments gathered whole, mu and |g| = sqrt(nu / 0.05), within
    BF16_TOL in relative norm over the whole state, and each leaf's
    least-squares factor to the one-process leaf within BF16_TOL of 1 (a
    share missing from a leaf's gradient or counted twice moves it by 1 /
    the shares);
  * every param gathered whole within a bf16 ulp of the one-process
    step's where both first moments clear SIGN_FLOOR with one sign (Adam's
    first step moves those by exactly the lr), which must be HELD_SHARE of
    the elements whose one-process moment clears it, and within 2 lr
    everywhere.

jax and the packages are imported inside the functions, so a rank
started as a script loads neither jax nor the test side.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist


ROOT = pathlib.Path(__file__).resolve().parents[1]
F32_TOL = 3e-4
BF16_TOL = 2e-2
SIGN_FLOOR = 1e-6
HELD_SHARE = 0.99

# the reference's sharded step of each [arch, config overrides] on a 2 x 2
# debug mesh, printed as one JSON object by case name (a fresh process:
# the forced device count must be set before jax starts)
REF_STEP = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.data.pipeline import DataConfig, make_batch
from repro.launch.mesh import make_debug_mesh
from repro.launch.steps import (batch_shardings, make_train_step,
                                opt_shardings, param_shardings)
from repro.nn.model import init_params
from repro.optim.adamw import adamw_init
from repro.parallel.sharding import use_mesh
cases, B, S, lr, warmup, total, step = json.loads(sys.argv[1])
out = {}
mesh = make_debug_mesh(2, 2)
for name, arch, replace in cases:
    cfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    p = init_params(jax.random.PRNGKey(0), cfg)
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                     if jnp.issubdtype(a.dtype, jnp.floating) and a.ndim >= 2
                     else a, p)
    batch = {k: jnp.asarray(v) for k, v in make_batch(
        cfg, DataConfig(seq_len=S, global_batch=B), 0).items()}
    with use_mesh(mesh):
        psh = param_shardings(cfg, mesh)
        osh = opt_shardings(psh, mesh)
        bsh = batch_shardings(cfg, mesh)
        bsh = {k: bsh[k] for k in batch}
        fn = jax.jit(make_train_step(cfg, peak_lr=lr, warmup=warmup,
                                     total=total),
                     in_shardings=(psh, osh, bsh, None),
                     out_shardings=(psh, osh, None))
        _, _, m = fn(p, adamw_init(p), batch, jnp.int32(step))
    out[name] = {k: float(v) for k, v in m.items()}
print(json.dumps(out))
"""


def bf16_leaves(case):
    """The reference trainer's params for a case: whole, bf16 matrices."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.nn.model import init_params as ref_init_params
    from repro_torch.nn.model import init_params
    from repro_torch.tree import tree_flatten
    cfg = case_config(case)
    rcfg = dataclasses.replace(ref_config(case["arch"], smoke=True),
                      **case.get("replace", {}))
    p = ref_init_params(jax.random.PRNGKey(0), rcfg)
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                     if jnp.issubdtype(a.dtype, jnp.floating) and a.ndim >= 2
                     else a, p)
    leaves = [np.asarray(a) for a in jax.tree.leaves(p)]
    like = tree_flatten(init_params(cfg, device="meta"))
    assert [tuple(a.shape) for a in leaves] == [tuple(t.shape) for t in like]
    return leaves


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def write_inputs(path, cases, B, S):
    """The workers' IN.npz for `cases` (each one's weights and the global
    batch of `make_batch`); returns (the inputs, the whole leaves by
    case)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    inputs, whole = {"cases": json.dumps(cases)}, {}
    for case in cases:
        c = case["name"]
        leaves = bf16_leaves(case)
        whole[c] = leaves
        inputs[f"{c}__dtypes"] = json.dumps([a.dtype.name for a in leaves])
        for i, a in enumerate(leaves):
            inputs[f"{c}__p{i}"] = (a.view(np.uint16)
                                    if a.dtype.name == "bfloat16" else a)
        inputs[f"{c}__tokens"] = make_batch(
            case_config(case), DataConfig(seq_len=S, global_batch=B),
            0)["tokens"]
    np.savez(path, **inputs)
    return inputs, whole


def start_reference(cases, B, S, step):
    """The reference's 2 x 2 sharded step of `cases` in a subprocess;
    `finish` reads it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    arg = [[c["name"], c["arch"], c.get("replace", {})] for c in cases]
    return subprocess.Popen(
        [sys.executable, "-c", REF_STEP, json.dumps(
            [arg, B, S, step["lr"], step["warmup"], step["total"],
             step["step"]])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def spawn(tmp, data, model, inputs):
    out = tmp / f"mesh{data}x{model}"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "split_mesh_worker.py"),
         str(out / "store"), str(r), str(data), str(model), str(inputs),
         str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(data * model)]
    return out, procs


def finish(procs, timeout=240):
    """Each process's standard output, once all have exited with 0."""
    outs, errs = [], []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append(out)
            errs.append((p.returncode, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _ in errs), errs
    return outs


def run_meshes(tmp, meshes, inputs_path):
    """Every mesh's four ranks, one spawn a mesh: {mesh: (its output
    directory, each rank's outputs)}."""
    outs = {}
    for data, model in meshes:
        out, procs = spawn(tmp, data, model, inputs_path)
        finish(procs)
        outs[data, model] = (out, [dict(np.load(out / f"r{r}.npz"))
                                   for r in range(data * model)])
    return outs


def one_process(cases, inputs, whole):
    """The port's one-process step of every case: its initial params, the
    params and moments after it, and its metrics.  A case marked
    `one_card_split` takes the step on a 1 x 1 mesh (a one-rank gloo
    group, ended after it): the split path on one rank, whose MoE layers
    run the expert-parallel body on the whole batch."""
    import repro_torch.serving  # noqa: F401  (before launch.steps)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn.model import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.tree import tree_flatten, tree_unflatten
    one = {}
    for case in cases:
        c = case["name"]
        cfg = case_config(case)
        like = init_params(cfg, device="meta")
        params = tree_unflatten(like, [to_torch(a) for a in whole[c]])
        batch = {"tokens": torch.from_numpy(inputs[f"{c}__tokens"])}
        step = make_train_step(cfg, peak_lr=case["lr"],
                               warmup=case["warmup"], total=case["total"])
        p0 = [t.float().numpy() for t in tree_flatten(params)]
        if case.get("one_card_split"):
            mesh = make_debug_mesh(1, 1, device="cpu")
            try:
                with use_mesh(mesh):
                    p2, o2, m = step(params, adamw_init(params), batch,
                                     case["step"])
            finally:
                dist.destroy_process_group()
        else:
            p2, o2, m = step(params, adamw_init(params), batch, case["step"])
        one[c] = {"p0": p0, "p": tree_flatten(p2), "mu": tree_flatten(o2.mu),
                  "nu": tree_flatten(o2.nu), "m": m}
    return one


def check_split_step(ranks, one, case: str, lr: float) -> None:
    """Every rank's metrics and rank 0's gathered state against the
    one-process step, by the measures of the module docstring (rank 0's
    mu, nu and params, as `main` writes them)."""
    for r, o in enumerate(ranks):
        for k in ("loss", "ce", "grad_norm"):
            want = float(one["m"][k])
            got = float(o[f"{case}__m_{k}"])
            tol = BF16_TOL if k == "grad_norm" else F32_TOL
            assert abs(got - want) <= tol * abs(want), (r, k, got, want)
        assert float(o[f"{case}__m_tokens"]) == float(one["m"]["tokens"])
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
        ulp = np.maximum(np.abs(a0), np.abs(w)) * 2.0 ** -7 + 1e-3 * lr
        assert np.all(np.abs(got - w)[sure] <= ulp[sure]), i
        assert np.all(np.abs(got - w) <= 2 * lr + ulp), i
        held += int(sure.sum())
        eligible += int(clear.sum())
    assert held >= HELD_SHARE * eligible, (held, eligible)


# ---------------------------------------------------------- one rank
def case_config(case):
    from repro_torch.configs import get_config
    cfg = get_config(case["arch"], smoke=True)
    return dataclasses.replace(cfg, **case.get("replace", {}))


def _leaf(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _held(tree) -> int:
    from repro_torch.tree import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree))


def main(argv) -> None:
    import repro_torch.serving  # noqa: F401  (before launch.steps)
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (make_train_step, opt_shardings,
                                          param_shardings)
    from repro_torch.nn.model import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import gather_whole, place, use_mesh
    from repro_torch.tree import tree_flatten, tree_unflatten

    store, rank, data, model, src, out_dir = argv
    rank, data, model = int(rank), int(data), int(model)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, data * model),
                            rank=rank, world_size=data * model)
    try:
        inp = np.load(src)
        out = {}
        mesh = make_debug_mesh(data, model, device="cpu")
        for case in json.loads(str(inp["cases"])):
            if [data, model] not in case.get("meshes", [[data, model]]):
                continue
            c = case["name"]
            cfg = case_config(case)
            dtypes = json.loads(str(inp[f"{c}__dtypes"]))
            like = init_params(cfg, device="meta")
            whole = tree_unflatten(like, [
                _leaf(inp[f"{c}__p{i}"], dt) for i, dt in enumerate(dtypes)])
            batch = {"tokens": torch.from_numpy(inp[f"{c}__tokens"])}
            step = make_train_step(cfg, peak_lr=case["lr"],
                                   warmup=case["warmup"], total=case["total"])
            with use_mesh(mesh):
                psh = param_shardings(cfg, mesh)
                osh = opt_shardings(psh, mesh)
                out[f"{c}__local_params"] = local_bytes(whole, psh)
                out[f"{c}__local_opt"] = local_bytes(adamw_init(whole), osh)
                params = place(whole, psh)
                del whole
                opt = adamw_init(params)
                out[f"{c}__held_params"] = _held(params)
                out[f"{c}__held_opt"] = _held(opt)
                params, opt, metrics = step(params, opt, batch,
                                            case["step"])
                for k, v in metrics.items():
                    out[f"{c}__m_{k}"] = float(v)
                wp = gather_whole(params, psh)
                wo = gather_whole(opt, osh)
                if case.get("ckpt"):
                    save_checkpoint(os.path.join(out_dir, f"ckpt_{c}"), 1,
                                    {"params": params, "opt": opt},
                                    shardings={"params": psh, "opt": osh})
            if rank == 0:
                for i, t in enumerate(tree_flatten(wp)):
                    out[f"{c}__p{i}"] = _np(t)
                for name in ("mu", "nu"):
                    for i, t in enumerate(tree_flatten(getattr(wo, name))):
                        out[f"{c}__{name}{i}"] = _np(t)
                out[f"{c}__opt_step"] = int(wo.step)
        np.savez(os.path.join(out_dir, f"r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1:])
