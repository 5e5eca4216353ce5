"""The port's MoE mesh bodies (`repro_torch.nn.moe` under an installed
mesh) against the reference's `shard_map` bodies on the CPU:

  * `_pack_dispatch` on the same routing: the buffer, token ids, slots
    and gates bit for bit, with capacity drops;
  * `moe` under a 1 x 1 mesh (a one-rank gloo group) against the
    reference's `moe` under `Mesh(jax.devices()[:1], ("data", "model"))`,
    at deepseek-v2-lite's and qwen3-moe's smoke widths: the all-to-all
    prefill at the config's capacity factor 1.25 (tokens dropped) and the
    replicated decode, `y` within the bf16 tolerance 2e-2 and `aux`
    within 1e-6;
  * 2 x 2 and 1 x 4 meshes over four gloo ranks (spawned processes, a
    `FileStore` under `tmp_path`) on `tests/test_moe.py`'s config
    (capacity factor 8.0, no drops): both paths within 2e-3 of
    `moe_reference`, every rank's output the same, the aux loss the
    reference's under `out_specs P()` (the rank at mesh coordinate 0's),
    and every rank's gradients of a loss through a residual, on both
    paths, within 2e-3 of one process's; the same with two shared
    experts;
  * a rematerialized MoE block's recomputation under the forward's mesh
    when the backward runs on another thread (as autograd runs a CUDA
    backward);
  * deepseek-v2-lite smoke's prefill and a slot decode step through the
    whole model under each package's 1 x 1 mesh: logits within 2e-2 of
    the logit scale with the same greedy picks.  Not within 2e-2
    absolute: at batch 2 the two packages' bf16 products part by an ulp
    now and then (ROADMAP §3), which this random-weight model carries to
    0.036 of logits at a scale of 4.3 without any mesh on this input, and
    to 0.044 under the meshes, whose capacity drops change the function.
"""
import dataclasses as dc
import json
import os
import pathlib
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

from repro.configs import get_config as ref_config
from repro.launch.steps import cached_prefill_step, cached_serve_step
from repro.nn import moe as ref_moe
from repro.nn.config import ModelConfig as RefModelConfig
from repro.nn.model import init_params as ref_init_params
from repro.parallel.sharding import use_mesh as ref_use_mesh
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.nn import moe
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.model import (F32_LEAVES, decode_step, init_params,
                                  lm_loss, prefill)
from repro_torch.parallel.sharding import current_mesh, use_mesh
from repro_torch.tree import tree_flatten
from repro_torch.weights import params_from_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE_ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
BF16_TOL = 2e-2
MESH_TOL = 2e-3          # tests/test_moe.py's shard_map tolerance


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture
def mesh11():
    """The port's 1 x 1 debug mesh on a one-rank gloo group, ended after
    the test, and the reference's 1 x 1 mesh."""
    mesh = make_debug_mesh(1, 1, device="cpu")
    try:
        yield mesh, Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))
    finally:
        dist.destroy_process_group()


def _bridge(node, key=None):
    if isinstance(node, dict):
        return {k: _bridge(v, k) for k, v in node.items()}
    return torch.from_numpy(np.array(node)).to(
        torch.float32 if key in F32_LEAVES else torch.bfloat16)


def _layer(arch, seed=3):
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    ref = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg)
    return rcfg, cfg, ref, _bridge(jax.tree.map(np.asarray, ref))


def _x(cfg, B, S, seed):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


# ------------------------------------------------------------ dispatch
@pytest.mark.parametrize("T,E,k,cap", [(40, 8, 2, 6), (64, 8, 2, 20),
                                       (37, 16, 4, 5), (19, 8, 6, 4)])
def test_pack_dispatch_matches_reference(T, E, k, cap):
    """The same routing into both packages' dispatch: every integer output
    (token ids, slots, -1 where dropped), the gates and the packed buffer
    bit for bit, with tokens dropped."""
    rng = np.random.default_rng(T * E + k)
    gate_idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]
                        ).astype(np.int32)
    gate_vals = rng.random((T, k)).astype(np.float32)
    xf = rng.standard_normal((T, 24)).astype(np.float32)
    rbuf, rtok, rslot, rgate = jax.jit(
        ref_moe._pack_dispatch, static_argnums=(3, 4))(
            jnp.asarray(xf, jnp.bfloat16), jnp.asarray(gate_vals),
            jnp.asarray(gate_idx), E, cap)
    buf, tok, slot, gate = moe._pack_dispatch(
        torch.from_numpy(xf).bfloat16(), torch.from_numpy(gate_vals),
        torch.from_numpy(gate_idx).long(), E, cap)
    assert int((np.asarray(rslot) < 0).sum()) > 0     # drops occur
    np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(rgate))
    assert buf.dtype == torch.bfloat16 and tuple(buf.shape) == rbuf.shape
    np.testing.assert_array_equal(_np(buf), _np(rbuf))


# ------------------------------------------------------- 1 x 1 meshes
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("path", ["a2a", "replicated"])
def test_moe_under_one_rank_mesh_matches_reference(arch, path, mesh11):
    mesh, rmesh = mesh11
    rcfg, cfg, ref, port = _layer(arch)
    decode = path == "replicated"
    jx, tx = _x(cfg, 2, 1 if decode else 19, seed=11)
    with ref_use_mesh(rmesh):
        want, want_aux = jax.jit(
            lambda p, x: ref_moe.moe(p, x, rcfg, decode=decode))(ref, jx)
    with use_mesh(mesh):
        got, got_aux = moe.moe(port, tx, cfg, decode=decode)
    assert current_mesh() is None
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert abs(float(got_aux) - float(want_aux)) < 1e-6
    if not decode:
        # the capacity factor dropped tokens, so the result is not the
        # exact (no-drop) layer's
        T = tx.shape[0] * tx.shape[1]
        cap = max(int(T * cfg.moe_topk * cfg.capacity_factor
                      / cfg.n_experts), 4)
        _, gv, gi = moe._route(tx.reshape(T, -1).float(),
                               port["router"].float(), cfg.moe_topk)
        slot = moe._pack_dispatch(tx.reshape(T, -1), gv, gi,
                                  cfg.n_experts, cap)[2]
        assert int((slot < 0).sum()) > 0
        exact, _ = moe.moe(port, tx, cfg)
        assert not torch.equal(exact, got)


def test_one_token_input_takes_the_replicated_body(mesh11, monkeypatch):
    """As the reference's: `decode` or an input of one position."""
    mesh, _ = mesh11
    _, cfg, _, port = _layer("qwen3-moe-235b-a22b")
    _, tx = _x(cfg, 2, 1, seed=2)
    seen = []
    for name in ("_moe_body_a2a", "_moe_body_replicated"):
        body = getattr(moe, name)
        monkeypatch.setattr(moe, name, lambda *a, _b=body, _n=name:
                            seen.append(_n) or _b(*a))
    with use_mesh(mesh):
        moe.moe(port, tx, cfg)
        moe.moe(port, torch.cat([tx, tx], 1), cfg)
        moe.moe(port, torch.cat([tx, tx], 1), cfg, decode=True)
    assert seen == ["_moe_body_replicated", "_moe_body_a2a",
                    "_moe_body_replicated"]


# ------------------------------------------------ four ranks over gloo
CFG_FIELDS = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2,
                  n_kv_heads=2, d_ff=64, vocab=64, n_experts=8, moe_topk=2,
                  d_ff_expert=16, capacity_factor=8.0)
SHARED_FIELDS = dict(CFG_FIELDS, n_shared_experts=2)


def _run_ranks(tmp_path, data, model, inputs):
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "mesh_worker.py"),
         str(tmp_path / "store"), str(r), str(data), str(model),
         str(tmp_path / "in.npz"), str(tmp_path / f"out{r}.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(data * model)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            errs.append((p.returncode, err[-2000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _ in errs), errs
    return [dict(np.load(tmp_path / f"out{r}.npz"))
            for r in range(data * model)]


def _flat(params):
    """{name: f32 array}, a nested leaf as `outer.inner`."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": np.asarray(w, np.float32)
                        for n, w in v.items()})
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _check_four_ranks(fields, data, model, tmp_path):
    rcfg = RefModelConfig(**fields)
    params = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 32), jnp.float32)
    y_ref, _ = ref_moe.moe_reference(params, x, rcfg)
    y1_ref, _ = ref_moe.moe_reference(params, x[:, :1], rcfg)
    # the reference's aux under out_specs P(): the rank at coordinate 0's
    # (its block of batch rows and, on the a2a path, of positions)
    bl, sl = 2 // data, 8 // model
    pr, _, gi = ref_moe._route(x[:bl, :sl].reshape(-1, 32),
                               params["router"], 2)
    aux_ref = ref_moe._aux_loss(pr, gi, 8)
    pr, _, gi = ref_moe._route(x[:bl, :1].reshape(-1, 32),
                               params["router"], 2)
    aux1_ref = ref_moe._aux_loss(pr, gi, 8)
    np_params = _flat(params)
    outs = _run_ranks(tmp_path, data, model, {
        "cfg": json.dumps(fields), "x": np.asarray(x),
        **{"p_" + k: v for k, v in np_params.items()}})
    for o in outs:
        np.testing.assert_array_equal(o["y"], outs[0]["y"])
        assert float(np.max(np.abs(o["y"] - np.asarray(y_ref)))) < MESH_TOL
        assert float(np.max(np.abs(o["y1"] - np.asarray(y1_ref)))) \
            < MESH_TOL
        assert abs(float(o["aux"]) - float(aux_ref)) < 1e-6
        assert abs(float(o["aux1"]) - float(aux1_ref)) < 1e-6
    # gradients of sum((x + y) * x), a residual as a block adds it: every
    # rank holds one process's, as the port's dense layers give on each
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in np_params.items()}
    tp = {k: v for k, v in leaves.items() if "." not in k}
    for k, v in leaves.items():
        if "." in k:
            outer, inner = k.split(".")
            tp.setdefault(outer, {})[inner] = v
    for tag, xs in (("g", np.array(x)), ("g1", np.array(x[:, :1]))):
        tx = torch.from_numpy(xs).requires_grad_(True)
        y, _ = moe.moe_reference(tp, tx, ModelConfig(**fields))
        want = torch.autograd.grad(((tx + y) * tx).sum(),
                                   list(leaves.values()) + [tx])
        for k, w in zip(list(leaves) + ["x"], want):
            for r, o in enumerate(outs):
                err = float(np.max(np.abs(o[f"{tag}_{k}"] - w.numpy())))
                assert err < MESH_TOL, (tag, k, r, err)


@pytest.mark.parametrize("data,model", [(2, 2), (1, 4)])
def test_four_rank_mesh_matches_moe_reference(data, model, tmp_path):
    """tests/test_moe.py's shard_map case on four gloo ranks."""
    _check_four_ranks(CFG_FIELDS, data, model, tmp_path)


@pytest.mark.parametrize("data,model", [(2, 2), (1, 4)])
def test_four_rank_mesh_with_shared_experts(data, model, tmp_path):
    """The same with two shared experts, whose MLP runs on each rank's own
    token block, so their gradients are counted once."""
    _check_four_ranks(SHARED_FIELDS, data, model, tmp_path)


# ------------------------------------------------------- the whole model
def test_deepseek_prefill_and_decode_under_mesh_match_reference(mesh11):
    """deepseek-v2-lite smoke (MLA, a dense layer then a MoE layer with
    shared experts): a prefill of 2 x 13 (the all-to-all body at the
    capacity factor 1.25) and a slot decode step (the replicated body)
    through each package under its 1 x 1 mesh."""
    mesh, rmesh = mesh11
    arch = "deepseek-v2-lite-16b"
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    ref = ref_init_params(jax.random.PRNGKey(0), rcfg)
    port = params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                 device="cpu")
    toks = np.random.default_rng(4).integers(1, cfg.vocab, (2, 13)) \
        .astype(np.int32)
    with ref_use_mesh(rmesh):
        r_logits, r_caches = cached_prefill_step(rcfg, 16)(
            ref, {"tokens": jnp.asarray(toks)})
        nxt = np.asarray(_np(r_logits)[:, :cfg.vocab].argmax(-1), np.int32)
        r_dec, _ = cached_serve_step(rcfg)(ref, jnp.asarray(nxt), r_caches,
                                           jnp.asarray(np.int32(13)))
    with use_mesh(mesh):
        logits, caches = prefill(
            port, {"tokens": torch.from_numpy(toks).long()}, cfg, 16)
        dec, _ = decode_step(port, torch.from_numpy(nxt).long(), caches,
                             13, cfg)
    for got, want in ((logits, r_logits), (dec, r_dec)):
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=BF16_TOL * scale)
        np.testing.assert_array_equal(_np(got)[:, :cfg.vocab].argmax(-1),
                                      _np(want)[:, :cfg.vocab].argmax(-1))


def test_remat_recomputes_under_the_forward_mesh_on_any_thread(mesh11):
    """Autograd runs a CUDA backward on a thread of its own, where the
    thread-local mesh is not installed: a rematerialized block recomputes
    under the mesh its forward ran under.  deepseek-v2-lite smoke's loss
    under the 1 x 1 mesh, differentiated on a fresh thread, gives the
    gradients of the same-thread backward, bit for bit."""
    mesh, _ = mesh11
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    assert cfg.remat
    params = init_params(cfg, seed=1, device="cpu")
    leaves = tree_flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (2, 16)).astype(np.int64))

    def loss():
        with use_mesh(mesh):
            return lm_loss(params, {"tokens": toks}, cfg)[0]

    want = torch.autograd.grad(loss(), leaves, allow_unused=True)
    out = []
    graph = loss()
    t = threading.Thread(target=lambda: out.append(torch.autograd.grad(
        graph, leaves, allow_unused=True)))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and len(out) == 1
    for g, w in zip(out[0], want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)
