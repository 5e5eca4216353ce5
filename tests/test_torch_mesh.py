"""The port's mesh layer against the reference's on the CPU:

  * the spec trees (`param_specs` and the module `*_specs` under it)
    equal the reference's for all ten families, and give `init_params`'
    tree, one logical axis per dim;
  * the abstract inputs as `meta` tensors at full width (`abstract_params`,
    `abstract_opt_state`, `abstract_caches`, `make_batch_specs`,
    `input_specs`): the shapes and dtypes of the reference's `eval_shape`
    stand-ins, leaf for leaf;
  * the sharding trees (`param_shardings`, `opt_shardings`,
    `cache_shardings`, `batch_shardings`) under a 1 x 1 mesh (a one-rank
    gloo group): the reference's PartitionSpecs under
    `Mesh(jax.devices()[:1], ("data", "model"))`, leaf for leaf;
  * `make_spec` / `batch_axes` with no mesh, a (data, model) and a (pod,
    data, model) mesh; `shard` returns its input; `use_mesh` restores the
    previous mesh and is thread-local; DTensor placements;
  * the meshes: `make_production_mesh` refuses a world of one rank as the
    reference does, `make_debug_mesh` refuses ranks that do not exist;
    `SHAPES` is the reference's;
  * int8 gradient compression: codes and scales bit for bit with the
    reference's as its jitted step runs it (XLA multiplies by 1/127 where
    the eager reference divides by 127), `compression_ratio_bytes` equal,
    the round-trip bound and the error-feedback drift of
    `tests/test_sharding_and_ft.py`, and
    `compressed_psum_pod` over a one-rank group bit for bit with the
    reference's under a one-device `pod` shard_map, two steps with the
    error carried (XLA fuses the residual's product and difference, so
    the port rounds the residual once);
  * the trainer's `--mesh debug` on deepseek-v2-lite smoke printing the
    reference CLI's `--mesh debug` lines, and `--mesh pod` / `multipod`
    refused on one rank.
"""
import dataclasses as dc
import os
import pathlib
import re
import shutil
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as RefP

from repro.configs import ARCHS, get_config as ref_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import make_batch_specs as ref_make_batch_specs
from repro.launch import mesh as ref_mesh_mod
from repro.launch import steps as ref_steps
from repro.launch.shapes import SHAPES as REF_SHAPES
from repro.nn.model import param_specs as ref_param_specs
from repro.parallel import compression as ref_comp
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch_specs
# the serving package before launch.steps: the reverse order is a cycle
import repro_torch.serving  # noqa: F401
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.shapes import SHAPES
from repro_torch.nn.model import init_params, param_specs
from repro_torch.parallel import compression as comp
from repro_torch.parallel import sharding
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


def _layout(tree):
    """A tree of (shape, dtype name) leaves, containers kept."""
    if dc.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _layout(getattr(tree, f.name))
                for f in dc.fields(tree)}
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v) for v in tree]
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), str(tree.dtype).replace("torch.", "")
    return tuple(tree.shape), np.dtype(tree.dtype).name


def _specs(tree):
    """A sharding tree with each leaf's PartitionSpec as a plain tuple."""
    if dc.is_dataclass(tree) and not hasattr(tree, "spec"):
        return {f.name: _specs(getattr(tree, f.name))
                for f in dc.fields(tree)}
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_specs(v) for v in tree]
    return tuple(tree.spec)


@pytest.fixture
def meshes():
    """The port's 1 x 1 debug mesh on a one-rank gloo group (ended after
    the test) and the reference's 1 x 1 mesh."""
    mesh = make_debug_mesh(1, 1, device="cpu")
    try:
        yield mesh, Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- specs
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_and_the_param_tree(arch):
    cfg = get_config(arch)
    specs = param_specs(cfg)
    assert specs == ref_param_specs(ref_config(arch))
    # the same tree as init_params', one axis entry per dim
    assert tree_map(len, specs, is_leaf=steps._is_spec_leaf) == \
        tree_map(lambda t: t.dim(), init_params(cfg, device="meta"))


# ---------------------------------------------------- abstract inputs
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference_at_full_width(arch):
    got = steps.abstract_params(get_config(arch))
    assert all(t.device.type == "meta" for t in tree_flatten(got))
    assert _layout(got) == _layout(ref_steps.abstract_params(
        ref_config(arch)))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-350m"])
def test_abstract_opt_state_matches_reference_at_full_width(arch):
    got = steps.abstract_opt_state(steps.abstract_params(get_config(arch)))
    want = ref_steps.abstract_opt_state(ref_steps.abstract_params(
        ref_config(arch)))
    assert _layout(got) == _layout(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_caches_match_reference_at_full_width(arch):
    got = steps.abstract_caches(get_config(arch), 4, 4096)
    assert all(t.device.type == "meta" for t in tree_flatten(got))
    assert _layout(got) == _layout(ref_steps.abstract_caches(
        ref_config(arch), 4, 4096))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference_at_full_width(arch):
    shape = SHAPES["train_4k"]
    got = make_batch_specs(get_config(arch),
                           DataConfig(shape.seq_len, shape.global_batch))
    want = ref_make_batch_specs(ref_config(arch), RefDataConfig(
        shape.seq_len, shape.global_batch))
    assert _layout(got) == _layout(want)


@pytest.mark.parametrize("cell", list(SHAPES))
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "hymba-1.5b"])
def test_input_specs_match_reference_at_full_width(arch, cell):
    s = SHAPES[cell]
    got = steps.input_specs(get_config(arch), s.kind, s.seq_len,
                            s.global_batch)
    want = ref_steps.input_specs(ref_config(arch), s.kind, s.seq_len,
                                 s.global_batch)
    assert _layout(got) == _layout(want)


def test_shapes_equal_the_reference():
    assert {k: dc.asdict(v) for k, v in SHAPES.items()} == \
        {k: dc.asdict(v) for k, v in REF_SHAPES.items()}


# ----------------------------------------------------------- shardings
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch, meshes):
    mesh, rmesh = meshes
    with sharding.use_mesh(mesh):
        got = steps.param_shardings(get_config(arch), mesh)
    with ref_sharding.use_mesh(rmesh):
        want = ref_steps.param_shardings(ref_config(arch), rmesh)
    assert _specs(got) == _specs(want)
    assert all(s.mesh is mesh for s in tree_leaves(
        got, is_leaf=lambda x: hasattr(x, "spec")))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_shardings_match_reference(arch, meshes):
    mesh, rmesh = meshes
    cfg, rcfg = get_config(arch), ref_config(arch)
    with sharding.use_mesh(mesh):
        got = [steps.cache_shardings(cfg, mesh),
               steps.cache_shardings(cfg, mesh, global_batch=3),
               steps.batch_shardings(cfg, mesh)]
    with ref_sharding.use_mesh(rmesh):
        want = [ref_steps.cache_shardings(rcfg, rmesh),
                ref_steps.cache_shardings(rcfg, rmesh, global_batch=3),
                ref_steps.batch_shardings(rcfg, rmesh)]
    assert _specs(got) == _specs(want)
    # one sharding per cache leaf
    n_leaves = len(tree_leaves(steps.abstract_caches(cfg, 2, 32)))
    assert len(tree_leaves(got[0], is_leaf=lambda x: hasattr(x, "spec"))) \
        == n_leaves


def test_opt_shardings_match_reference(meshes):
    mesh, rmesh = meshes
    arch = "qwen3-moe-235b-a22b"
    with sharding.use_mesh(mesh):
        got = steps.opt_shardings(steps.param_shardings(get_config(arch),
                                                        mesh), mesh)
    with ref_sharding.use_mesh(rmesh):
        want = ref_steps.opt_shardings(ref_steps.param_shardings(
            ref_config(arch), rmesh), rmesh)
    assert _specs(got) == _specs(want)


AXES = [("batch", "sp", None), ("fsdp", "tp"), ("tp", None, "fsdp"),
        ("batch", None, "tp"), (None,), ("model", "data"), ()]


@pytest.mark.parametrize("axes", ["none", "data,model", "pod,data,model"])
def test_make_spec_and_batch_axes_match_reference(axes):
    """Every logical axis with no mesh, a single-pod and a multi-pod mesh
    (one rank each)."""
    if axes == "none":
        port_ctx, ref_ctx = sharding.use_mesh(None), \
            ref_sharding.use_mesh(None)
        group = False
    else:
        names = tuple(axes.split(","))
        shape = (1,) * len(names)
        make_debug_mesh(1, 1, device="cpu")
        group = True
        from torch.distributed.device_mesh import DeviceMesh
        port_ctx = sharding.use_mesh(DeviceMesh(
            "cpu", torch.zeros(shape, dtype=torch.int64),
            mesh_dim_names=names))
        ref_ctx = ref_sharding.use_mesh(Mesh(
            np.array(jax.devices()[:1]).reshape(shape), names))
    try:
        with port_ctx:
            got = [sharding.make_spec(*a) for a in AXES]
            got_ba = sharding.batch_axes()
        with ref_ctx:
            want = [ref_sharding.make_spec(*a) for a in AXES]
            want_ba = ref_sharding.batch_axes()
    finally:
        if group:
            dist.destroy_process_group()
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert all(g == w for g, w in zip(got, want))
    assert got_ba == want_ba


def test_named_sharding_placements_and_shard(meshes):
    from torch.distributed.tensor import Replicate, Shard
    mesh, rmesh = meshes
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.named_sharding("batch", "tp") is None
    assert sharding.shard(x, "batch", "tp") is x
    with sharding.use_mesh(mesh):
        ns = sharding.named_sharding("batch", None, "tp")
        assert sharding.shard(x, "batch", "tp") is x
    with ref_sharding.use_mesh(rmesh):
        want = ref_sharding.named_sharding("batch", None, "tp")
    assert tuple(ns.spec) == tuple(want.spec) and ns.mesh is mesh
    assert ns.placements() == (Shard(0), Shard(2))
    assert sharding.NamedSharding(mesh, sharding.make_spec(
        None, "fsdp")).placements() == (Shard(1), Replicate())
    assert sharding.NamedSharding(mesh, sharding.PartitionSpec()).placements() == \
        (Replicate(), Replicate())


def test_use_mesh_restores_and_is_thread_local(meshes):
    mesh, _ = meshes
    seen = []
    with sharding.use_mesh(mesh):
        assert sharding.current_mesh().mesh is mesh
        with sharding.use_mesh(None):
            assert sharding.current_mesh() is None
        assert sharding.current_mesh().axis_names == ("data", "model")
        assert not sharding.current_mesh().has_pod
        t = threading.Thread(target=lambda: seen.append(
            sharding.current_mesh()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen == [None] and sharding.current_mesh() is None


# -------------------------------------------------------------- meshes
@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_ranks(multi_pod, n):
    """One rank (no process group) against 256 or 512: both packages
    refuse, naming the count they need."""
    with pytest.raises(RuntimeError, match=f"needs {n} "):
        ref_mesh_mod.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError, match=f"needs {n} ranks but only 1"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert not dist.is_initialized()


def test_debug_mesh_refuses_ranks_that_do_not_exist():
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_debug_mesh(2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_debug_mesh(1, 1)
    assert not dist.is_initialized()


# --------------------------------------------------------- compression
def _grads(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3.0, n) * np.exp(rng.normal(0, 3.0, n))) \
        .astype(np.float32)


@pytest.mark.parametrize("n", [5000, 2048 * 7, (1 << 16) + 3])
def test_quantize_blockwise_matches_reference_bit_for_bit(n):
    x = _grads(n, n)
    q, s = jax.jit(ref_comp._quantize_blockwise)(jnp.asarray(x))
    tq, ts = comp._quantize_blockwise(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    out = comp._dequantize_blockwise(tq, ts, (n,), n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        ref_comp._dequantize_blockwise(q, s, (n,), n)))


def test_the_two_scale_forms_part_on_these_inputs():
    """Why the form matters: the reference's eager scales (amax / 127)
    and its jitted ones (amax * (1/127)) round apart in some blocks, and
    the port's are the jitted ones."""
    x = _grads((1 << 16) + 3, (1 << 16) + 3)
    fn = ref_comp._quantize_blockwise
    eager, jitted = fn(jnp.asarray(x))[1], jax.jit(fn)(jnp.asarray(x))[1]
    assert not np.array_equal(np.asarray(eager), np.asarray(jitted))
    np.testing.assert_array_equal(
        comp._quantize_blockwise(torch.from_numpy(x))[1].numpy(),
        np.asarray(jitted))


def test_blockwise_quant_roundtrip_error():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 3.0, (5000,))
                         .astype(np.float32))
    q, s = comp._quantize_blockwise(x)
    out = comp._dequantize_blockwise(q, s, x.shape, x.numel())
    assert float((out - x).abs().max()) <= float(s.max()) * 0.5 + 1e-6


def test_error_feedback_is_lossless_over_time():
    g = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (4096,))
                         .astype(np.float32))
    err = torch.zeros_like(g)
    applied = torch.zeros_like(g)
    for _ in range(30):
        total = g + err
        q, s = comp._quantize_blockwise(total)
        deq = comp._dequantize_blockwise(q, s, total.shape, total.numel())
        err = total - deq
        applied = applied + deq
    assert float((applied / 30.0 - g).abs().max()) < 0.05


def test_compression_ratio_bytes_matches_reference():
    cfg = get_config("deepseek-v2-lite-16b")
    got = comp.compression_ratio_bytes(init_params(cfg, device="meta"))
    want = ref_comp.compression_ratio_bytes(ref_steps.abstract_params(
        ref_config("deepseek-v2-lite-16b")))
    assert got == want
    raw, compressed = comp.compression_ratio_bytes(
        {"a": torch.zeros(1 << 20)})
    assert raw / compressed > 3.5


def test_compressed_psum_pod_matches_reference_over_one_rank():
    """Two steps with the error buffers carried, f32 and bf16 leaves: the
    port's all_reduce over a one-rank gloo group against the reference's
    psum under a jitted one-device `pod` shard_map."""
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(0, 2, (3, 1500)).astype(np.float32),
            "b": {"s": rng.normal(0, 1, (7,)).astype(np.float32)},
            "h": rng.normal(0, 1, (64, 65)).astype(np.float32)}
    ref_g = {"w": jnp.asarray(tree["w"]), "b": {"s": jnp.asarray(
        tree["b"]["s"])}, "h": jnp.asarray(tree["h"], jnp.bfloat16)}
    port_g = {"w": torch.from_numpy(tree["w"]),
              "b": {"s": torch.from_numpy(tree["b"]["s"])},
              "h": torch.from_numpy(tree["h"]).bfloat16()}
    pod = Mesh(np.array(jax.devices()[:1]), ("pod",))
    fn = jax.jit(jax.shard_map(
        lambda g, e: ref_comp.compressed_psum_pod(g, e, "pod"), mesh=pod,
        in_specs=(RefP(), RefP()), out_specs=(RefP(), RefP()),
        check_vma=False))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        err, r_err = None, jax.tree.map(
            lambda g: jnp.zeros(g.shape, jnp.float32), ref_g)
        for _ in range(2):
            red, err = comp.compressed_psum_pod(port_g, err)
            r_red, r_err = fn(ref_g, r_err)
            for a, b in zip(tree_flatten(red) + tree_flatten(err),
                            jax.tree.leaves(r_red) + jax.tree.leaves(r_err)):
                assert a.dtype == torch.bfloat16 or \
                    str(a.dtype) == f"torch.{np.dtype(b.dtype).name}"
                np.testing.assert_array_equal(
                    a.float().numpy(), np.asarray(b.astype(jnp.float32)))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the CLI
ROOT = pathlib.Path(__file__).resolve().parents[1]
LINE = re.compile(r"step\s+(\d+) loss=(\S+) ce=(\S+) gnorm=(\S+) lr=(\S+)")
CLI_ARCH = "deepseek-v2-lite-16b"


def _cli(module, *args, device=True, check=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    extra = ("--device", "cpu") if device else ()
    r = subprocess.run([sys.executable, "-m", module, "--arch", CLI_ARCH,
                        "--smoke", "--batch", "2", "--seq", "32", *args,
                        *extra], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    if check:
        assert r.returncode == 0, r.stderr[-3000:]
    return r


def _steps(out):
    return {int(m.group(1)): [float(x) for x in m.group(2, 3, 4, 5)]
            for m in LINE.finditer(out)}


def test_cli_mesh_debug_prints_the_reference_lines(tmp_path):
    """The reference CLI trains deepseek-v2-lite smoke under `--mesh debug`
    (its MoE layer on the all-to-all body, tokens dropped at the capacity
    factor 1.25) for 4 steps, checkpointing step 2; the port CLI under
    `--mesh debug` (a one-rank gloo group) resumes a copy of that
    checkpoint and prints the reference's steps 2 and 3, compared as
    `tests/test_torch_train_cli.py` compares them."""
    ck, mine = tmp_path / "ck", tmp_path / "mine"
    ref_out = _cli("repro.launch.train", "--steps", "4", "--ckpt-dir",
                   str(ck), "--ckpt-every", "2", "--mesh", "debug",
                   device=False).stdout
    shutil.copytree(ck / "step_2", mine / "step_2")
    out = _cli("repro_torch.launch.train", "--steps", "4", "--ckpt-dir",
               str(mine), "--mesh", "debug").stdout
    assert "resumed from step 2" in out and out.strip().endswith("done")
    got, want = _steps(out), _steps(ref_out)
    assert sorted(got) == [2, 3] and sorted(want) == [0, 1, 2, 3]
    for s in got:
        (loss, ce, gn, lr), (loss_r, ce_r, gn_r, lr_r) = got[s], want[s]
        assert abs(loss - loss_r) <= max(1e-4 * loss_r, 1e-4)
        assert abs(ce - ce_r) <= max(1e-4 * ce_r, 1e-4)
        assert abs(gn - gn_r) <= 3e-2 * gn_r
        assert lr == lr_r


@pytest.mark.parametrize("kind,n", [("pod", 256), ("multipod", 512)])
def test_cli_production_meshes_need_their_ranks(kind, n):
    r = _cli("repro_torch.launch.train", "--steps", "1", "--mesh", kind,
             check=False)
    assert r.returncode != 0
    assert f"needs {n} ranks but only 1 present" in r.stderr
