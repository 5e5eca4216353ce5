"""The port's layers and model against the reference at gemma smoke size.
The reference's `init_params` weights are carried over through numpy by
`repro_torch.weights.params_from_reference`; inputs are made with numpy
from a seed and fed to both.  Float outputs are held within 2e-2 in bf16
(the reference's bf16 kernel tolerance, `tests/test_kernels.py:71,94`);
greedy tokens must be identical."""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch.steps import (cached_paged_serve_step,
                                cached_prefill_step, cached_serve_step)
from repro.nn import layers as ref_layers
from repro.nn.model import init_params as ref_init_params
from repro.serving.paging import (_cached_page_write, init_page_pool as
                                  ref_init_page_pool)
from repro_torch.configs import get_config
from repro_torch.nn import layers
from repro_torch.nn.model import decode_step, init_params, prefill
from repro_torch.serving.paging import PagedKVArena, init_page_pool, page_write
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_reference

RCFG = ref_config("gemma-7b", smoke=True)
CFG = get_config("gemma-7b", smoke=True)
REF_PARAMS = ref_init_params(jax.random.PRNGKey(0), RCFG)
PARAMS = params_from_reference(jax.tree.map(np.asarray, REF_PARAMS), CFG,
                               device="cpu")
TOL = 2e-2


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_input(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _flat(tree, prefix=()):
    """[(path, leaf)] over nested dicts and lists."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree) for x in _flat(t, prefix + (i,))]
    return [(prefix, tree)]


def _shapes(tree):
    return {path: tuple(leaf.shape) for path, leaf in _flat(tree)}


def test_weight_bridge_and_init_keep_the_reference_tree():
    ref = _shapes(jax.tree.map(np.asarray, REF_PARAMS))
    assert _shapes(PARAMS) == ref
    assert _shapes(init_params(CFG, seed=0, device="cpu")) == ref
    # norm scales f32, everything else bf16
    for path, leaf in _flat(PARAMS):
        want = torch.float32 if path[-1] == "scale" else torch.bfloat16
        assert leaf.dtype == want, path


def test_bridge_values_identical_after_bf16_cast():
    table = REF_PARAMS["embedding"]["table"].astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        _f32(PARAMS["embedding"]["table"]), _f32(table))


def test_rmsnorm_rope_mlp_unembed_match_reference():
    jx, tx = _bf16_input((2, 5, CFG.d_model), 1)
    seg_r = REF_PARAMS["stack"]["segments"][0]
    seg_t = PARAMS["stack"]["segments"][0]
    ref_rmsnorm = jax.jit(ref_layers.rmsnorm)
    ref_mlp = jax.jit(ref_layers.mlp, static_argnums=2)
    ref_unembed = jax.jit(ref_layers.unembed, static_argnums=2)
    np.testing.assert_allclose(
        _f32(layers.rmsnorm(seg_t["norm1"], tx, CFG.norm_eps)),
        _f32(ref_rmsnorm(seg_r["norm1"], jx, RCFG.norm_eps)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        _f32(layers.mlp(seg_t["mlp"], tx, CFG.act)),
        _f32(ref_mlp(seg_r["mlp"], jx, RCFG.act)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        _f32(layers.unembed(PARAMS["embedding"], tx, CFG)),
        _f32(ref_unembed(REF_PARAMS["embedding"], jx, RCFG)),
        rtol=TOL, atol=TOL)
    pos = np.arange(300, dtype=np.int32)[None]
    cos_t, sin_t = layers.rope_angles(torch.from_numpy(pos), 32, 10_000.0)
    cos_r, sin_r = jax.jit(ref_layers.rope_angles, static_argnums=(1, 2))(
        jnp.asarray(pos), 32, 10_000.0)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_r), atol=1e-5)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_r), atol=1e-5)
    jq, tq = _bf16_input((1, 300, 4, 32), 2)
    np.testing.assert_allclose(
        _f32(layers.apply_rope(tq, cos_t, sin_t)),
        _f32(jax.jit(ref_layers.apply_rope)(jq, cos_r, sin_r)), rtol=TOL,
        atol=TOL)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, CFG.vocab, (1, n)) \
        .astype(np.int32)


@pytest.mark.parametrize("kv,n_layers", [("bf16", 2), ("int8", 2),
                                         ("bf16", 4)],
                         ids=["bf16", "int8", "bf16-stacked"])
def test_prefill_and_paged_decode_logits_match_reference(kv, n_layers):
    """2 layers run as single blocks, 4 as one stacked (scanned) segment."""
    rcfg = dc.replace(RCFG, kv_cache_dtype=kv, n_layers=n_layers)
    cfg = dc.replace(CFG, kv_cache_dtype=kv, n_layers=n_layers)
    ref_params, params = REF_PARAMS, PARAMS
    if n_layers != RCFG.n_layers:
        ref_params = ref_init_params(jax.random.PRNGKey(1), rcfg)
        params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                       cfg, device="cpu")
    page, n_pages, S = 4, 6, 11
    toks = _prompt(S, seed=3)
    r_logits, r_cache = cached_prefill_step(rcfg, 12)(
        ref_params, {"tokens": jnp.asarray(toks)})
    t_logits, t_cache = prefill(
        params, {"tokens": torch.from_numpy(toks).long()}, cfg, 12)
    np.testing.assert_allclose(_f32(t_logits), _f32(r_logits), rtol=TOL,
                               atol=TOL)
    # both caches into pages 2, 4, 5 of a fresh pool, then one decode step
    table = np.asarray([[2, 4, 5, 0, 0, 0]], np.int32)
    r_pool = ref_init_page_pool(rcfg, n_pages, page)
    t_pool = init_page_pool(cfg, n_pages, page, device="cpu")
    write = _cached_page_write(rcfg, page)
    for blk in range(3):
        r_pool = write(r_pool, r_cache, jnp.int32(blk),
                       jnp.int32(table[0, blk]))
        page_write(cfg, t_pool, t_cache, blk, int(table[0, blk]))
    nxt = np.asarray([int(np.argmax(_f32(r_logits)[0, :CFG.vocab]))],
                     np.int32)
    pos = np.asarray([S], np.int32)
    r_out, _ = cached_paged_serve_step(rcfg)(
        ref_params, jnp.asarray(nxt), r_pool, jnp.asarray(pos),
        jnp.asarray(table))
    t_out, _ = decode_step(params, torch.from_numpy(nxt).long(), t_pool,
                           torch.from_numpy(pos), cfg,
                           torch.from_numpy(table))
    np.testing.assert_allclose(_f32(t_out), _f32(r_out), rtol=TOL, atol=TOL)


def _ref_sequential(prompt, n_new, max_seq=32):
    """The reference oracle: batch-1 prefill, then `make_serve_step` one
    token at a time over a contiguous cache (tests/test_serving.py)."""
    logits, caches = cached_prefill_step(RCFG, max_seq)(
        REF_PARAMS, {"tokens": jnp.asarray(prompt, jnp.int32)[None]})
    toks = [int(jnp.argmax(logits[0, :RCFG.vocab]))]
    for i in range(n_new - 1):
        logits, caches = cached_serve_step(RCFG)(
            REF_PARAMS, jnp.asarray([toks[-1]], jnp.int32), caches,
            jnp.int32(len(prompt) + i))
        toks.append(int(jnp.argmax(logits[0, :RCFG.vocab])))
    return toks


def _port_sequential(prompt, n_new, page=4):
    """The port's batch-1 loop: prefill, install into a paged arena, then
    paged decode steps through the arena's page table."""
    arena = PagedKVArena(CFG, 1, 8, page, device="cpu")
    row = arena.alloc(0, tuple(prompt))
    bucket = arena.blocks_for(len(prompt)) * page
    logits, one = prefill(PARAMS, {"tokens": torch.tensor([prompt])}, CFG,
                          bucket)
    toks = [int(torch.argmax(logits[0, :CFG.vocab]))]
    arena.install(row, one, toks[-1], tuple(prompt))
    for _ in range(n_new - 1):
        assert arena.prepare_decode(row)
        tok, pos, tables = arena.decode_inputs()
        logits, arena.caches = decode_step(PARAMS, tok, arena.caches, pos,
                                           CFG, tables)
        toks.append(int(torch.argmax(logits[0, :CFG.vocab])))
        arena.advance(row, toks[-1])
    return toks


@pytest.mark.parametrize("seed,plen", [(0, 5), (1, 9), (2, 13)])
def test_greedy_tokens_match_reference_sequential_loop(seed, plen):
    prompt = _prompt(plen, seed)[0].tolist()
    assert _port_sequential(prompt, 10) == _ref_sequential(prompt, 10)


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference(jax.tree.map(np.asarray, REF_PARAMS), CFG)


def test_tree_leaves_cover_every_param():
    assert len(tree_leaves(PARAMS)) == len(jax.tree.leaves(REF_PARAMS))
