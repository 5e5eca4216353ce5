"""The port's paging against the reference: page write and COW page copy
bit for bit on the same pools, int8 KV quantization bit for bit, and one
scripted admit / share / COW / extend / free sequence on both allocators
giving the same tables, refcounts and counters at every step."""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.nn.attention import _kv_quant as ref_kv_quant
from repro.nn.model import init_cache as ref_init_cache
from repro.serving.paging import PageAllocator as RefAllocator
from repro.serving.paging import (_cached_page_copy, _cached_page_write,
                                  init_page_pool as ref_init_page_pool)
from repro_torch.configs import get_config
from repro_torch.nn.attention import _kv_quant
from repro_torch.serving.paging import (PageAllocator, init_page_pool,
                                        page_copy, page_write)


def _to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _assert_trees_equal(t_tree, r_tree):
    t_leaves = jax.tree.leaves(t_tree)   # torch tensors are leaves too
    r_leaves = jax.tree.leaves(r_tree)
    assert len(t_leaves) == len(r_leaves)
    for t, r in zip(t_leaves, r_leaves):
        assert t.shape == tuple(r.shape)
        assert torch.equal(t, _to_torch(r))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("n_layers", [2, 4], ids=["single", "stacked"])
def test_page_write_and_copy_bit_for_bit(kv, n_layers):
    """2 layers give unstacked segments, 4 a stacked (scanned) one."""
    rcfg = dc.replace(ref_config("gemma-7b", smoke=True), kv_cache_dtype=kv,
                      n_layers=n_layers)
    cfg = dc.replace(get_config("gemma-7b", smoke=True), kv_cache_dtype=kv,
                     n_layers=n_layers)
    page, n_pages, L = 4, 7, 12
    rng = np.random.default_rng(n_layers)
    # a batch-1 prefill cache in the reference's layout, random values
    def fill(a):
        if a.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, a.shape), jnp.int8)
        return jnp.asarray(rng.standard_normal(a.shape), a.dtype)
    r_one = jax.tree.map(fill, ref_init_cache(rcfg, 1, L))
    t_one = jax.tree.map(_to_torch, r_one)
    r_pool = ref_init_page_pool(rcfg, n_pages, page)
    t_pool = init_page_pool(cfg, n_pages, page, device="cpu")
    _assert_trees_equal(t_pool, r_pool)
    write = _cached_page_write(rcfg, page)
    for blk, pg in ((0, 3), (1, 1), (2, 6)):
        r_pool = write(r_pool, r_one, jnp.int32(blk), jnp.int32(pg))
        page_write(cfg, t_pool, t_one, blk, pg)
    _assert_trees_equal(t_pool, r_pool)
    r_pool = _cached_page_copy(rcfg)(r_pool, jnp.int32(3), jnp.int32(5))
    page_copy(cfg, t_pool, 3, 5)
    _assert_trees_equal(t_pool, r_pool)


def test_kv_quant_bit_for_bit():
    """Against the reference's `_kv_quant` as its serving paths run it,
    inside a jit (where XLA turns its division by 127 into a product)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    x[0, 0] = 0.0                        # all-zero rows hit the 1e-8 clamp
    x[1, 1, :, :2] = [127.0 * 0.5, -127.0 * 1.5]  # exact .5 ties
    for jx, tx in ((jnp.asarray(x), torch.from_numpy(x)),
                   (jnp.asarray(x, jnp.bfloat16),
                    torch.from_numpy(x).bfloat16())):
        rc, rs = jax.jit(ref_kv_quant)(jx)
        tc, ts = _kv_quant(tx)
        assert tc.dtype == torch.int8
        np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))


def _state(a):
    return ({rid: list(t) for rid, t in a.tables.items()},
            a.refcount.tolist(), a.n_free, a.shared_hits, a.cow_copies,
            a.pages_allocated, a.tree.n_cached, a.tree.evictions)


@pytest.mark.parametrize("retain", [False, True])
def test_scripted_allocator_sequence_matches_reference(retain):
    ps = 4
    rng = np.random.default_rng(1)
    shared = tuple(rng.integers(1, 100, 10).tolist())
    other = tuple(rng.integers(1, 100, 7).tolist())
    script = [
        ("alloc", 0, shared), ("register", 0, shared),
        ("alloc", 1, shared),                               # share 2.5 pages
        ("cow", 1, 2), ("extend", 0), ("alloc", 2, other),
        ("register", 2, other), ("cow", 0, 0),
        ("free", 0, shared + (5, 6)),                       # donate if retain
        ("alloc", 3, shared[:8]), ("register", 3, shared[:8]),
        ("extend", 2), ("extend", 2), ("free", 1, None),
        ("alloc", 4, other + (9,)), ("free", 2, None),
        ("free", 3, shared[:8] + (1,)), ("alloc", 5, shared),
    ]
    pair = (RefAllocator(12, ps, retain=retain, max_cached=6 if retain else None),
            PageAllocator(12, ps, retain=retain,
                          max_cached=6 if retain else None))
    for op in script:
        outs = []
        for a in pair:
            if op[0] == "alloc":
                outs.append(a.alloc_table(op[1], op[2]))
            elif op[0] == "cow":
                outs.append(a.cow(op[1], op[2]))
            elif op[0] == "extend":
                outs.append(a.extend(op[1]))
            elif op[0] == "register":
                outs.append(a.register(op[1], op[2]))
            else:
                outs.append(a.free_table(op[1], donate_tokens=op[2]))
        assert outs[0] == outs[1], op
        assert _state(pair[0]) == _state(pair[1]), op
    assert pair[1].cow_copies > 0 and pair[1].shared_hits > 0
