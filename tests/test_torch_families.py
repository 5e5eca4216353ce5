"""The port's other model families against the reference on the CPU:

  * the registry: minicpm-2b, yi-34b, qwen3-32b, deepseek-v2-lite-16b,
    qwen3-moe-235b-a22b, hymba-1.5b, xlstm-350m, hubert-xlarge and
    paligemma-3b (and gemma-7b) field-equal to the reference's, `full()`
    and `smoke()`, with the same `param_count`;
  * `init_params` on every family: the reference's tree, with qk_norm
    scales, MLA's latent projections, the MoE stacks, the Mamba, mLSTM
    and sLSTM cells and hubert's untied head and ungated MLP, the expert
    stacks scaled by their own fan-in (axis
    1), the router, MLA's W_uk/W_uv and the recurrent cells' f32 leaves
    (`nn.model.F32_LEAVES`) kept in f32; the weight bridge keeps those in
    f32 with the reference's values;
  * every new family at smoke size: the prefill, paged and slot decode
    logits bit for bit, the forward's too on the dense families (within
    2e-2 on the MoE ones); for the dense GQA families (minicpm-2b,
    yi-34b, qwen3-32b) greedy tokens through a paged arena equal the
    reference's sequential loop; int8 KV on qwen3-32b bit for bit;
  * the streaming executor on minicpm-2b smoke at 4 layers
    (`tests/test_streaming.py::test_executor_matches_full_model`): the
    reference executor's installs and stats, logits within 2e-2 of the
    logit scale of its own, and within the reference test's 0.2 of the
    port's resident model.

Bit equality holds because the port follows XLA CPU's bf16 rounding points
(`nn/layers.py::_silu`, op by op, as `_gelu_tanh`)."""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels.delta_apply import ops as ref_delta_ops
from repro.kernels.delta_apply.ref import delta_apply_ref
from repro.launch.steps import (cached_paged_serve_step,
                                cached_prefill_step, cached_serve_step)
from repro.nn.model import forward as ref_forward
from repro.nn.model import init_params as ref_init_params
from repro.serving.paging import _cached_page_write
from repro.serving.paging import init_page_pool as ref_init_page_pool
from repro.streaming import plan as ref_plan
from repro.streaming.executor import StreamingExecutor as RefExecutor
from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.nn.model import (decode_step, forward, init_params,
                                  prefill)
from repro_torch.serving.paging import (PagedKVArena, init_page_pool,
                                        page_write)
from repro_torch.streaming import plan
from repro_torch.streaming.executor import StreamingExecutor
from repro_torch.tree import tree_map
from repro_torch.weights import params_from_reference

ARCHS = ("gemma-7b", "minicpm-2b", "yi-34b", "qwen3-32b",
         "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b", "hymba-1.5b",
         "xlstm-350m", "hubert-xlarge", "paligemma-3b")
# the attention families beside gemma-7b: the paged arena takes them
# (hymba and xLSTM are slot-only, `tests/test_torch_hybrid.py`)
ATTENTION = ARCHS[1:6]
DENSE = ("minicpm-2b", "yi-34b", "qwen3-32b")
_PARAMS = {}


def _params(arch, seed=0, **variant):
    """(reference config, port config, reference params for PRNGKey(seed),
    port params through `params_from_reference`)."""
    key = (arch, seed, tuple(sorted(variant.items())))
    if key not in _PARAMS:
        rcfg = dc.replace(ref_config(arch, smoke=True), **variant)
        cfg = dc.replace(get_config(arch, smoke=True), **variant)
        ref = ref_init_params(jax.random.PRNGKey(seed), rcfg)
        _PARAMS[key] = (rcfg, cfg, ref, params_from_reference(
            jax.tree.map(np.asarray, ref), cfg, device="cpu"))
    return _PARAMS[key]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _flat(t, prefix + (i,))]
    return [(prefix, tree)]


def _shapes(tree):
    return {path: tuple(leaf.shape) for path, leaf in _flat(tree)}


# ------------------------------------------------------------- registry
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_field_equal_to_the_reference(arch):
    for smoke in (False, True):
        want = ref_config(arch, smoke=smoke)
        got = get_config(arch, smoke=smoke)
        assert dc.asdict(got) == dc.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.layer_is_moe == want.layer_is_moe
    assert arch in configs.ARCHS


# ----------------------------------------------------------------- init
F32_LEAVES = {"scale", "router", "w_uk", "w_uv", "dt_bias", "A_log",
              "if_bias", "r_gates", "gate_bias"}


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_init_params_and_bridge_keep_the_reference_tree(arch):
    _, cfg, ref, port = _params(arch)
    want = _shapes(jax.tree.map(np.asarray, ref))
    assert _shapes(port) == want
    mine = init_params(cfg, seed=0, device="cpu")
    assert _shapes(mine) == want
    np_ref = dict(_flat(jax.tree.map(np.asarray, ref)))
    for tree in (port, mine):
        for path, leaf in _flat(tree):
            want_dt = (torch.float32 if path[-1] in F32_LEAVES
                       else torch.bfloat16)
            assert leaf.dtype == want_dt, path
    # the f32 leaves carry the reference's values exactly
    for path, leaf in _flat(port):
        if path[-1] in F32_LEAVES:
            np.testing.assert_array_equal(leaf.numpy(), np_ref[path])
    if cfg.qk_norm:
        attn = mine["stack"]["segments"][0]["attn"]
        assert set(attn) >= {"q_norm", "k_norm"}
        assert (attn["q_norm"]["scale"] == 1).all()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_init_params_scales_experts_by_their_fan_in(arch):
    """The reference draws the (E, d, f) / (E, f, d) expert stacks with
    fan-in axis 1 (`nn/moe.py:42-44`), not the expert count: the port's
    draws have the same per-leaf std (within sampling noise)."""
    cfg = dc.replace(get_config(arch, smoke=True), n_layers=2)
    seg = init_params(cfg, seed=3, device="cpu")["stack"]["segments"][-1]
    moe = seg["moe"]
    lead = moe["w_up"].ndim - 3           # a stacked segment's layer axis
    for name in ("w_gate", "w_up", "w_down", "router"):
        leaf = moe[name].float()
        fan_in = leaf.shape[lead + 1] if name != "router" else \
            leaf.shape[lead]
        assert abs(leaf.std().item() * fan_in ** 0.5 - 1) < 0.1, name


# --------------------------------------------------- dense GQA families
def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (1, n)) \
        .astype(np.int32)


@pytest.mark.parametrize("arch", ATTENTION)
def test_forward_prefill_and_decode_logits_equal_the_reference(arch):
    """The whole-sequence forward, the prefill, then one paged and one
    slot decode step over the prefill's cache: bit for bit, the MoE
    families' too on this input (`tests/test_torch_mla.py` shows an input
    where MLA's slot decode parts by an ulp), but for their forward's
    logits at every position, held to the bf16 tolerance: one of
    qwen3-moe's 5,632 parts by an ulp (2e-6) there."""
    rcfg, cfg, ref, port = _params(arch)
    toks = _prompt(cfg, 11, seed=3)
    r_fwd, _, _ = jax.jit(ref_forward, static_argnums=2)(
        ref, {"tokens": jnp.asarray(toks)}, rcfg)
    t_fwd, _, _ = forward(port, {"tokens": torch.from_numpy(toks).long()},
                          cfg)
    if cfg.n_experts:
        np.testing.assert_allclose(_np(t_fwd), _np(r_fwd), rtol=2e-2,
                                   atol=2e-2)
    else:
        np.testing.assert_array_equal(_np(t_fwd), _np(r_fwd))
    r_logits, r_cache = cached_prefill_step(rcfg, 12)(
        ref, {"tokens": jnp.asarray(toks)})
    t_logits, t_cache = prefill(
        port, {"tokens": torch.from_numpy(toks).long()}, cfg, 12)
    np.testing.assert_array_equal(_np(t_logits), _np(r_logits))
    table = np.asarray([[2, 4, 5, 0, 0, 0]], np.int32)
    r_pool = ref_init_page_pool(rcfg, 6, 4)
    t_pool = init_page_pool(cfg, 6, 4, device="cpu")
    write = _cached_page_write(rcfg, 4)
    for blk in range(3):
        r_pool = write(r_pool, r_cache, jnp.int32(blk),
                       jnp.int32(table[0, blk]))
        page_write(cfg, t_pool, t_cache, blk, int(table[0, blk]))
    nxt = np.asarray([int(np.argmax(_np(r_logits)[0, :cfg.vocab]))],
                     np.int32)
    pos = np.asarray([11], np.int32)
    r_out, _ = cached_paged_serve_step(rcfg)(
        ref, jnp.asarray(nxt), r_pool, jnp.asarray(pos), jnp.asarray(table))
    t_out, _ = decode_step(port, torch.from_numpy(nxt).long(), t_pool,
                           torch.from_numpy(pos), cfg,
                           torch.from_numpy(table))
    np.testing.assert_array_equal(_np(t_out), _np(r_out))
    r_out, _ = cached_serve_step(rcfg)(ref, jnp.asarray(nxt), r_cache,
                                       jnp.asarray(pos))
    t_out, _ = decode_step(port, torch.from_numpy(nxt).long(), t_cache,
                           torch.from_numpy(pos), cfg)
    np.testing.assert_array_equal(_np(t_out), _np(r_out))


def _ref_sequential(arch, prompt, n_new, max_seq=32):
    """The reference oracle: batch-1 prefill, then its serve step one token
    at a time over a contiguous cache."""
    rcfg, _, ref, _ = _params(arch)
    logits, caches = cached_prefill_step(rcfg, max_seq)(
        ref, {"tokens": jnp.asarray(prompt, jnp.int32)[None]})
    toks = [int(jnp.argmax(logits[0, :rcfg.vocab]))]
    for i in range(n_new - 1):
        logits, caches = cached_serve_step(rcfg)(
            ref, jnp.asarray([toks[-1]], jnp.int32), caches,
            jnp.int32(len(prompt) + i))
        toks.append(int(jnp.argmax(logits[0, :rcfg.vocab])))
    return toks


def _port_paged(arch, prompt, n_new, page=4):
    """The port's batch-1 loop: prefill, install into a paged arena, then
    paged decode steps through the arena's table."""
    _, cfg, _, port = _params(arch)
    arena = PagedKVArena(cfg, 1, 8, page, device="cpu")
    row = arena.alloc(0, tuple(prompt))
    logits, one = prefill(port, {"tokens": torch.tensor([prompt])}, cfg,
                          arena.blocks_for(len(prompt)) * page)
    toks = [int(torch.argmax(logits[0, :cfg.vocab]))]
    arena.install(row, one, toks[-1], tuple(prompt))
    for _ in range(n_new - 1):
        assert arena.prepare_decode(row)
        tok, pos, tables = arena.decode_inputs()
        logits, arena.caches = decode_step(port, tok, arena.caches, pos, cfg,
                                           tables)
        toks.append(int(torch.argmax(logits[0, :cfg.vocab])))
        arena.advance(row, toks[-1])
    return toks


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("seed,plen", [(0, 5), (1, 13)])
def test_greedy_tokens_equal_the_reference_loop(arch, seed, plen):
    _, cfg, _, _ = _params(arch)
    prompt = _prompt(cfg, plen, seed)[0].tolist()
    assert _port_paged(arch, prompt, 10) == _ref_sequential(arch, prompt, 10)


def test_int8_kv_on_qwen3_equals_the_reference():
    """`tests/test_attention.py::test_int8_kv_cache_decode_close_to_bf16`'s
    set-up on qwen3-32b smoke (B 2, S 24, cache 32): the port's int8
    prefill caches and decode logits are the reference's bit for bit, and
    track the bf16 cache within the reference test's 8%."""
    rcfg, cfg, ref, port = _params("qwen3-32b", kv_cache_dtype="int8")
    toks = np.array(jax.random.randint(jax.random.PRNGKey(3), (2, 25), 0,
                                         cfg.vocab), np.int32)
    r_logits, r_cache = cached_prefill_step(rcfg, 32)(
        ref, {"tokens": jnp.asarray(toks[:, :24])})
    t_logits, t_cache = prefill(
        port, {"tokens": torch.from_numpy(toks[:, :24]).long()}, cfg, 32)
    np.testing.assert_array_equal(_np(t_logits), _np(r_logits))
    for g, w in zip(t_cache, r_cache):
        for name in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(_np(g["attn"][name]),
                                          _np(w["attn"][name]), name)
    r_out, _ = cached_serve_step(rcfg)(ref, jnp.asarray(toks[:, 24]),
                                       r_cache, jnp.int32(24))
    t_out, _ = decode_step(port, torch.from_numpy(toks[:, 24]).long(),
                           t_cache, 24, cfg)
    np.testing.assert_array_equal(_np(t_out), _np(r_out))
    _, cfg16, _, port16 = _params("qwen3-32b")
    _, c16 = prefill(port16, {"tokens": torch.from_numpy(toks[:, :24]).long()},
                     cfg16, 32)
    out16, _ = decode_step(port16, torch.from_numpy(toks[:, 24]).long(),
                           c16, 24, cfg16)
    rel = np.abs(_np(t_out) - _np(out16)).max() / np.abs(_np(out16)).max()
    assert rel < 0.08, rel


# -------------------------------------------------------- streaming
# the link both executors model (`tests/test_torch_streaming.py`)
LINK = dict(peak_flops=1e14, hbm_bw=1e12, dma_bw=2e10, dma_latency_s=2e-5)


def test_streaming_executor_on_minicpm():
    """minicpm-2b smoke at 4 unscanned layers through 2 arena slots, on
    `tests/test_streaming.py::test_executor_matches_full_model`'s batch
    (ones, 2 x 12): the reference executor's stats and metrics, logits
    within 2e-2 of the logit scale of its own (its per-layer jit rounds
    elsewhere than the whole-model jit; `tests/test_torch_streaming.py`),
    and within that test's 0.2 of the port's resident model."""
    rcfg, cfg, ref, _ = _params("minicpm-2b", n_layers=4, scan_layers=False)
    batch = np.ones((2, 12), np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_delta_ops, "apply_delta", delta_apply_ref)
        rex = RefExecutor(ref, rcfg, arena_slots=2, plan_tokens=24,
                          link=ref_plan.TpuLinkModel(**LINK))
        r_logits, r_m = rex.forward({"tokens": jnp.asarray(batch)})
    f32 = tree_map(lambda a: torch.from_numpy(np.array(a)),
                   jax.tree.map(np.asarray, ref))
    ex = StreamingExecutor(f32, cfg, arena_slots=2, plan_tokens=24,
                           link=plan.LinkModel(**LINK), device="cpu")
    logits, m = ex.forward({"tokens": torch.from_numpy(batch).long()})
    assert dc.asdict(ex.stats) == dc.asdict(rex.stats)
    for k, v in r_m.items():
        if k != "wall_s":
            assert m[k] == v, k
    want = _np(r_logits)
    got = _np(logits)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
    resident, _, _ = forward(f32, {"tokens": torch.from_numpy(batch).long()},
                             cfg)
    assert np.abs(got - _np(resident)).max() < 0.2
