"""The port's MLA attention (`repro_torch.nn.attention._mla_attention`) and
its latent caches against the reference on the CPU at deepseek-v2-lite
smoke, with the reference's `init_params` weights carried over:

  * the latent cache layouts (`init_cache` decode and staging, int8 or
    not, `init_page_pool`): the reference's shapes and dtypes; int8 is
    ignored for MLA as the reference ignores it;
  * prefill (through the flash wrapper, V zero-padded to K's width):
    logits and latent caches bit for bit;
  * chunks into a staging cache (the reference's materialized-K/V f32
    einsum) chunk by chunk, and a one-token chunk (the reference's
    absorbed branch): logits within the bf16 tolerance 2e-2
    (`tests/test_kernels.py:94`) and staging latents bit for bit; the
    last chunk's logits equal the port's monolithic prefill's;
  * absorbed slot decode (scalar and per-row positions, a stale row past
    the cache end): the attention output and the caches bit for bit, the
    logits within 2e-2 with the same greedy picks;
  * paged decode equals slot decode bit for bit
    (`tests/test_paging.py::test_paged_decode_matches_contiguous`'s
    schedule), and both equal the reference's paged decode;
  * page write, page read and the stage install on latent pools;
  * prefill-then-decode consistency on deepseek and qwen3-32b
    (`tests/test_attention.py::test_prefill_decode_consistency`).
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch.steps import cached_chunk_prefill_step as ref_chunk_step
from repro.launch.steps import (cached_paged_serve_step,
                                cached_prefill_step, cached_serve_step)
from repro.launch.steps import cached_stage_install as ref_stage_install
from repro.nn.attention import attention as ref_attention
from repro.nn.model import init_cache as ref_init_cache
from repro.nn.model import init_params as ref_init_params
from repro.serving.paging import _cached_page_read, _cached_page_write
from repro.serving.paging import init_page_pool as ref_init_page_pool
from repro_torch.configs import get_config
# the serving package before launch.steps: the reverse order is a cycle
from repro_torch.serving.paging import init_page_pool, page_read, page_write
from repro_torch.launch.steps import cached_stage_install
from repro_torch.nn import attention as attn_mod
from repro_torch.nn.model import (chunk_prefill, decode_step, forward,
                                  init_cache, prefill)
from repro_torch.weights import params_from_reference

ARCH = "deepseek-v2-lite-16b"
RCFG = ref_config(ARCH, smoke=True)
CFG = get_config(ARCH, smoke=True)
REF_PARAMS = ref_init_params(jax.random.PRNGKey(0), RCFG)
PARAMS = params_from_reference(jax.tree.map(np.asarray, REF_PARAMS), CFG,
                               device="cpu")
BF16_TOL = 2e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), str(tree.dtype).replace("torch.", "")
    return tuple(tree.shape), np.dtype(tree.dtype).name


def _to_port(caches):
    """Reference caches -> port caches, leaf for leaf (bf16 stays bf16)."""
    def leaf(x):
        t = torch.from_numpy(np.array(_np(x)))
        return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t
    return [{"attn": {k: leaf(v) for k, v in seg["attn"].items()}}
            for seg in caches]


def _assert_caches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g["attn"]) == set(w["attn"]) == {"c_kv", "k_rope"}
        for name, leaf in w["attn"].items():
            assert tuple(g["attn"][name].shape) == leaf.shape, name
            np.testing.assert_array_equal(_np(g["attn"][name]), _np(leaf),
                                          err_msg=name)


def _prompt(n, seed=0, batch=1):
    return np.random.default_rng(seed).integers(1, CFG.vocab, (batch, n)) \
        .astype(np.int32)


# ------------------------------------------------------------ layouts
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("staging", [True, False])
@pytest.mark.parametrize("variant", [{}, {"n_layers": 5,
                                          "scan_layers": True}],
                         ids=["single", "scanned"])
def test_latent_cache_and_pool_layouts_match_reference(kv, staging,
                                                       variant):
    """deepseek's stack is [dense, MoE]; at 5 layers with scanning on it is
    [dense, scan·4], the full config's plan.  int8 changes nothing."""
    rc = dc.replace(RCFG, kv_cache_dtype=kv, **variant)
    c = dc.replace(CFG, kv_cache_dtype=kv, **variant)
    assert _layout(init_cache(c, 2, 24, staging=staging, device="cpu")) \
        == _layout(ref_init_cache(rc, 2, 24, staging=staging))
    assert _layout(init_page_pool(c, 7, 4, device="cpu")) == \
        _layout(ref_init_page_pool(rc, 7, 4))


# ------------------------------------------------------------ prefill
def test_prefill_logits_and_latents_equal_the_reference():
    """The flash wrapper runs MLA's prefill on K/V of widths 24 and 16 (V
    zero-padded to 24): the reference's logits and latent caches bit for
    bit, and the wrapper is what ran."""
    toks = _prompt(11, seed=3, batch=2)
    calls = []
    flash = attn_mod.flash_attention

    def counting(q, k, v, causal):
        calls.append((tuple(q.shape), tuple(v.shape)))
        return flash(q, k, v, causal)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attn_mod, "flash_attention", counting)
        logits, caches = prefill(
            PARAMS, {"tokens": torch.from_numpy(toks).long()}, CFG, 16)
    r_logits, r_caches = cached_prefill_step(RCFG, 16)(
        REF_PARAMS, {"tokens": jnp.asarray(toks)})
    np.testing.assert_array_equal(_np(logits), _np(r_logits))
    _assert_caches_equal(caches, r_caches)
    width = CFG.qk_nope_dim + CFG.qk_rope_dim
    assert calls == [((2, 11, CFG.n_heads, width),
                      (2, 11, CFG.n_heads, width))] * CFG.n_layers


# ------------------------------------------------------------- chunks
PROMPT_LEN, STAGING = 19, 24
CHUNKINGS = {
    "aligned, padded tail": [(0, 8), (8, 8), (16, 8)],
    "sub-chunk start at 12": [(0, 8), (8, 4), (12, 8)],
    "one-token chunk": [(0, 8), (8, 1), (9, 8), (17, 8)],
}


@pytest.mark.parametrize("chunking", list(CHUNKINGS))
def test_chunk_prefill_matches_reference(chunking):
    toks = _prompt(PROMPT_LEN, seed=5)[0]
    caches = init_cache(CFG, 1, STAGING, staging=True, device="cpu")
    r_caches = ref_init_cache(RCFG, 1, STAGING, staging=True)
    for start, size in CHUNKINGS[chunking]:
        n_valid = min(size, PROMPT_LEN - start)
        chunk = np.zeros((1, size), np.int32)
        chunk[0, :n_valid] = toks[start:start + n_valid]
        if start + size > STAGING:      # the port refuses a spill; the
            size = STAGING - start      # engine never asks for one
            chunk = chunk[:, :size]
        logits, caches = chunk_prefill(PARAMS, torch.from_numpy(chunk).long(),
                                       caches, start, n_valid, CFG)
        r_logits, r_caches = ref_chunk_step(RCFG, size, STAGING)(
            REF_PARAMS, jnp.asarray(chunk), r_caches, jnp.int32(start),
            jnp.int32(n_valid))
        np.testing.assert_allclose(_np(logits), _np(r_logits),
                                   rtol=BF16_TOL, atol=BF16_TOL)
        assert int(_np(logits)[0, :CFG.vocab].argmax()) == \
            int(_np(r_logits)[0, :CFG.vocab].argmax())
        _assert_caches_equal(caches, r_caches)
    if chunking != "one-token chunk":
        # a one-token chunk attends through the absorbed branch, which
        # moves that token's residual stream, hence later layers' latents,
        # off the monolithic prefill's (in the reference too)
        mono, _ = prefill(PARAMS,
                          {"tokens": torch.from_numpy(toks[None]).long()},
                          CFG, STAGING)
        np.testing.assert_array_equal(_np(logits), _np(mono))


def test_chunk_prefill_refuses_a_chunk_past_the_staging():
    caches = init_cache(CFG, 1, 8, staging=True, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        chunk_prefill(PARAMS, torch.ones(1, 6, dtype=torch.long), caches, 4,
                      6, CFG)


# ------------------------------------------------------------- decode
@pytest.mark.parametrize("pos", ["scalar", "rows", "stale"])
def test_absorbed_slot_decode_matches_reference(pos):
    """One decode step over prefill caches of 16 at a scalar position, at
    per-row positions, and with one row's stale position past the cache
    end (its write clamps to the last slot, as `dynamic_update_slice`
    does): layer 0's attention output and every cache bit for bit, the
    logits within the bf16 tolerance with the same greedy picks.  The
    logits are not bit-equal in general: past the attention, torch's and
    XLA's f32 and batched bf16 arithmetic part by an ulp now and then
    (ROADMAP §3), here on row 2 of the "stale" case (row 2 at position 3
    parts in the same way with no stale row beside it)."""
    toks = _prompt(11, seed=7, batch=3)
    r_logits, r_caches = cached_prefill_step(RCFG, 16)(
        REF_PARAMS, {"tokens": jnp.asarray(toks)})
    caches = _to_port(r_caches)
    tok = np.asarray(_np(r_logits)[:, :CFG.vocab].argmax(-1), np.int32)
    p = {"scalar": np.int32(11),
         "rows": np.asarray([11, 5, 15], np.int32),
         "stale": np.asarray([11, 20, 3], np.int32)}[pos]
    x = np.random.default_rng(0).standard_normal(
        (3, 1, CFG.d_model)).astype(np.float32)
    r_attn = jax.jit(lambda a, x, c, q: ref_attention(
        a, x, RCFG, cache=c, cache_pos=q))
    want_y, _ = r_attn(REF_PARAMS["stack"]["segments"][0]["attn"],
                       jnp.asarray(x, jnp.bfloat16), r_caches[0]["attn"],
                       jnp.asarray(p))
    got_y, _ = attn_mod.attention(
        PARAMS["stack"]["segments"][0]["attn"],
        torch.from_numpy(x).bfloat16(), CFG,
        cache=_to_port(r_caches)[0]["attn"],
        cache_pos=torch.from_numpy(np.asarray(p)))
    np.testing.assert_array_equal(_np(got_y), _np(want_y))
    want, want_caches = cached_serve_step(RCFG)(
        REF_PARAMS, jnp.asarray(tok), r_caches, jnp.asarray(p))
    got, caches = decode_step(PARAMS, torch.from_numpy(tok).long(), caches,
                              torch.from_numpy(np.asarray(p)), CFG)
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_array_equal(_np(got)[:, :CFG.vocab].argmax(-1),
                                  _np(want)[:, :CFG.vocab].argmax(-1))
    _assert_caches_equal(caches, want_caches)


def test_paged_decode_equals_slot_decode_bit_for_bit():
    """`tests/test_paging.py::test_paged_decode_matches_contiguous` on MLA:
    a 6-token prompt, its 2 blocks in scattered pages 3, 5 of a pool of
    8 + 1 pages of 4, then 4 decode steps (crossing into block 2): the
    paged logits equal the contiguous (slot) ones bit for bit, and both
    the reference's paged decode's."""
    ps, n_pages, plen = 4, 8, 6
    toks = _prompt(plen, seed=1)
    L = n_pages * ps
    batch = {"tokens": torch.from_numpy(toks).long()}
    logits, caches_c = prefill(PARAMS, batch, CFG, L)
    _, one = prefill(PARAMS, batch, CFG, 2 * ps)
    pool = init_page_pool(CFG, n_pages + 1, ps, device="cpu")
    r_logits, r_one = cached_prefill_step(RCFG, 2 * ps)(
        REF_PARAMS, {"tokens": jnp.asarray(toks)})
    r_pool = ref_init_page_pool(RCFG, n_pages + 1, ps)
    write = _cached_page_write(RCFG, ps)
    table = [3, 5, 7]
    for i in range(2):
        page_write(CFG, pool, one, i, table[i])
        r_pool = write(r_pool, r_one, jnp.int32(i), jnp.int32(table[i]))
    tables = np.zeros((1, n_pages), np.int32)
    tables[0, :3] = table
    tok = logits[:, :CFG.vocab].argmax(-1)
    pos = torch.full((1,), plen, dtype=torch.int32)
    step = cached_paged_serve_step(RCFG)
    for _ in range(4):
        ld_c, caches_c = decode_step(PARAMS, tok, caches_c, pos, CFG)
        ld_p, pool = decode_step(PARAMS, tok, pool, pos, CFG,
                                 torch.from_numpy(tables))
        np.testing.assert_array_equal(_np(ld_c), _np(ld_p))
        want, r_pool = step(REF_PARAMS, jnp.asarray(tok.numpy(), jnp.int32),
                            r_pool, jnp.asarray(pos.numpy()),
                            jnp.asarray(tables))
        np.testing.assert_array_equal(_np(ld_p), _np(want))
        tok = ld_c[:, :CFG.vocab].argmax(-1)
        pos = pos + 1


# --------------------------------------------------- pages and installs
def test_page_write_read_and_stage_install_on_latent_pools():
    """A prefill's latents written into pages 2 and 5, read back into a
    fresh staging cache (the prefix cache's warm path: every leaf bit for
    bit, int8 or not), and the staging installed into a slot row through
    `cached_stage_install`, against the reference's jitted page ops and
    stage install."""
    toks = _prompt(7, seed=2)
    _, one = prefill(PARAMS, {"tokens": torch.from_numpy(toks).long()}, CFG,
                     8)
    _, r_one = cached_prefill_step(RCFG, 8)(REF_PARAMS,
                                            {"tokens": jnp.asarray(toks)})
    c8 = dc.replace(CFG, kv_cache_dtype="int8")
    pool = init_page_pool(c8, 6, 4, device="cpu")
    r_pool = ref_init_page_pool(RCFG, 6, 4)
    write = _cached_page_write(RCFG, 4)
    for blk, page in ((0, 2), (1, 5)):
        page_write(c8, pool, one, blk, page)
        r_pool = write(r_pool, r_one, jnp.int32(blk), jnp.int32(page))
    _assert_caches_equal(pool, r_pool)
    staging = init_cache(c8, 1, 12, staging=True, device="cpu")
    r_staging = ref_init_cache(RCFG, 1, 12, staging=True)
    read = _cached_page_read(RCFG, 4)
    for blk, page in ((0, 2), (1, 5)):
        page_read(c8, staging, pool, blk, page)
        r_staging = read(r_staging, r_pool, jnp.int32(blk), jnp.int32(page))
    _assert_caches_equal(staging, r_staging)
    row = cached_stage_install(CFG, 12, 10)(staging, 7)
    r_row = ref_stage_install(RCFG, 12, 10)(r_staging, jnp.int32(7))
    _assert_caches_equal(row, r_row)


# ------------------------------------------- prefill / decode consistency
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen3-32b"])
def test_prefill_decode_consistency(arch):
    """Prefill(S) then one decode step against a forward over S+1 tokens
    (B 2, S 24), within the reference test's rtol 0.15 / atol 0.25 (bf16
    prefill and cached decode sum in other orders); the port's decode
    logits equal the reference's decode logits within 2e-2."""
    rcfg = ref_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    ref = REF_PARAMS if arch == ARCH else ref_init_params(
        jax.random.PRNGKey(0), rcfg)
    port = PARAMS if arch == ARCH else params_from_reference(
        jax.tree.map(np.asarray, ref), cfg, device="cpu")
    toks = np.array(jax.random.randint(jax.random.PRNGKey(9), (2, 25), 0,
                                       cfg.vocab), np.int32)
    t = torch.from_numpy(toks).long()
    _, caches = prefill(port, {"tokens": t[:, :24]}, cfg, 32)
    logits_d, _ = decode_step(port, t[:, 24], caches, 24, cfg)
    full, _, _ = forward(port, {"tokens": t}, cfg, last_only=True)
    np.testing.assert_allclose(_np(logits_d), _np(full[:, 0]), rtol=0.15,
                               atol=0.25)
    _, r_caches = cached_prefill_step(rcfg, 32)(
        ref, {"tokens": jnp.asarray(toks[:, :24])})
    want, _ = cached_serve_step(rcfg)(ref, jnp.asarray(toks[:, 24]),
                                      r_caches, jnp.int32(24))
    np.testing.assert_allclose(_np(logits_d), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)
