"""The port's chunked prefill into a staging cache, with the prefix cache's
chunk skip, against the reference on the CPU at gemma-7b smoke:

  * `bucket_ladder` / `bucket_for` and the engine's staging-length ladder
    (`staging_len_for`) equal the reference's over grids of their inputs;
  * `init_cache` layouts (staging and decode, bf16 and int8, single and
    scanned segments, and hymba's and xLSTM's recurrent entries) equal
    the reference's in shape and dtype;
  * `chunk_prefill` chunk by chunk (aligned chunks with a padded tail, and
    a sub-chunk start) gives the reference's logits and staging K/V within
    the reference's bf16 tolerance, 2e-2 (`tests/test_kernels.py:94`; the
    reference's chunk step is one jit whose XLA `exp` moves some values by
    one bf16 ulp), with the same greedy pick, and its last chunk gives the
    port's monolithic prefill logits bit for bit;
  * the engine schedules of `tests/test_chunked_prefill.py` and
    `tests/test_prefix_cache.py` (slot-row schedules run with the paged
    layout in both packages), and one two-tenant chunked schedule under
    `drive_simulated`: the port gives the reference engine's tokens
    (`kernel_backend="xla"`) and exactly its chunk, prompt-token, hit-token,
    COW, preemption and per-step decode-batch counts and its distinct chunk
    shapes (the reference's jit traces), and its own monolithic engine's
    tokens.  Tokens and counters are compared, never wall-clock keys.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch.steps import \
    cached_chunk_prefill_step as ref_chunk_step
from repro.nn.model import init_cache as ref_init_cache
from repro.nn.model import init_params as ref_init_params
from repro.serving import EngineModel as RefEngineModel
from repro.serving import PageAllocator as RefPageAllocator
from repro.serving import SchedulerConfig as RefSchedulerConfig
from repro.serving import ServingEngine as RefServingEngine
from repro.serving import VirtualClock as RefVirtualClock
from repro.serving import bucket_for as ref_bucket_for
from repro.serving import bucket_ladder as ref_bucket_ladder
from repro.serving import drive_simulated as ref_drive_simulated
from repro.serving import engine as ref_engine_mod
from repro_torch.configs import get_config
from repro_torch.serving import (EngineModel, PageAllocator,
                                 SchedulerConfig, ServingEngine,
                                 VirtualClock, drive_simulated)
from repro_torch.serving import engine as port_engine_mod
from repro_torch.serving.bucketing import bucket_for, bucket_ladder
from repro_torch.nn.model import chunk_prefill, init_cache, prefill
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import params_from_reference

RCFG = ref_config("gemma-7b", smoke=True)
CFG = get_config("gemma-7b", smoke=True)
REF_PARAMS = ref_init_params(jax.random.PRNGKey(0), RCFG)
PARAMS = params_from_reference(jax.tree.map(np.asarray, REF_PARAMS), CFG,
                               device="cpu")
BF16_TOL = 2e-2
PAGE = 4


# ------------------------------------------------------------ bucketing
@pytest.mark.parametrize("lo,hi,growth", [
    (1, 1, 2.0), (8, 8, 2.0), (16, 8, 2.0), (8, 32, 2.0), (3, 100, 1.5),
    (5, 37, 3.3), (1, 480, 1.1), (32, 512, 4.0)])
def test_bucket_ladder_matches_reference(lo, hi, growth):
    ladder = bucket_ladder(lo, hi, growth)
    assert ladder == ref_bucket_ladder(lo, hi, growth)
    for n in range(1, hi + 3):
        assert bucket_for(n, ladder) == ref_bucket_for(n, ladder), n


@pytest.mark.parametrize("lo,hi,growth", [(8, 64, 1.0), (0, 64, 2.0)])
def test_bucket_ladder_rejects_what_the_reference_rejects(lo, hi, growth):
    with pytest.raises(ValueError):
        ref_bucket_ladder(lo, hi, growth)
    with pytest.raises(ValueError):
        bucket_ladder(lo, hi, growth)


# ------------------------------------------------------------ engines
def _engine(pkg, cfg=None, *, tenants=(("a", 0),), kv_slots=3, max_seq=48,
            page=PAGE, n_pages=0, prefix_cache=False, prefix_cache_pages=0,
            chunk=0, budget=None, growth=2.0, staging_growth=2.0,
            max_prefill=2, weight_slots=None, clock=None, f32_params=False):
    """One engine of either package ("ref" or "port") over the paged
    layout; tenants are (name, PRNGKey seed) pairs.
    `f32_params` gives the port the reference's f32 params instead of
    `params_from_reference`'s bf16 ones, so the weight store quantizes
    the same values and installs match (as `test_torch_residency.py`
    does); the model casts to bf16 at use, so tokens do not move."""
    cfg_kv = (cfg or {}).get("kv_cache_dtype", "bf16")
    kw = dict(kv_slots=kv_slots, max_seq=max_seq, kv_layout="paged",
              page_size=page, n_pages=n_pages, prefix_cache=prefix_cache,
              prefix_cache_pages=prefix_cache_pages)
    extra = {} if clock is None else {"clock": clock}
    if pkg == "ref":
        c = dc.replace(RCFG, kv_cache_dtype=cfg_kv)
        return RefServingEngine(
            [RefEngineModel(name, _ref_params(seed), c,
                            kernel_backend="xla", **kw)
             for name, seed in tenants],
            sched=RefSchedulerConfig(max_prefill_per_step=max_prefill,
                                     prefill_token_budget=budget),
            weight_arena_slots=weight_slots, prefill_chunk=chunk,
            bucket_growth=growth, staging_growth=staging_growth, **extra)
    c = dc.replace(CFG, kv_cache_dtype=cfg_kv)
    return ServingEngine(
        [EngineModel(name, _port_params(seed, f32_params), c, **kw)
         for name, seed in tenants],
        sched=SchedulerConfig(max_prefill_per_step=max_prefill,
                              prefill_token_budget=budget),
        weight_arena_slots=weight_slots, prefill_chunk=chunk,
        bucket_growth=growth, staging_growth=staging_growth, device="cpu",
        **extra)


_PARAMS = {}


def _ref_params(seed):
    """The reference's params for PRNGKey(seed), and the port's: through
    `params_from_reference` (bf16 matrices) and as f32 tensors."""
    if seed not in _PARAMS:
        ref = (REF_PARAMS if seed == 0 else
               ref_init_params(jax.random.PRNGKey(seed), RCFG))
        np_params = jax.tree.map(np.asarray, ref)
        _PARAMS[seed] = (ref, params_from_reference(np_params, CFG,
                                                    device="cpu"),
                         tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  np_params))
    return _PARAMS[seed][0]


def _port_params(seed, f32=False):
    _ref_params(seed)
    return _PARAMS[seed][2 if f32 else 1]


@pytest.mark.parametrize("chunk,page,n_pages,growth", [
    (8, 4, 24, 2.0), (6, 4, 24, 2.0), (4, 4, 0, 0.0), (16, 8, 40, 1.5),
    (3, 4, 9, 2.0), (256, 16, 34, 2.0), (12, 8, 20, 3.0)])
def test_staging_ladder_matches_reference(chunk, page, n_pages, growth):
    """The staging-length ladder and `staging_len_for` at every prompt
    length up to the pool, and the tail-chunk bucket ladder."""
    kw = dict(chunk=chunk, page=page, n_pages=n_pages,
              staging_growth=growth)
    ref = _engine("ref", **kw)
    port = _engine("port", **kw)
    assert port._staging_ladders == ref._staging_ladders
    cap = port.arenas["a"].max_tokens
    for n in range(1, cap + 1):
        assert port.staging_len_for("a", n) == ref.staging_len_for("a", n)
    assert port._ladder == ref._ladder


# --------------------------------------------------------- staging caches
def _layout(tree):
    """Nested structure with (shape, dtype name) leaves."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), str(tree.dtype).replace("torch.", "")
    return tuple(tree.shape), np.dtype(tree.dtype).name


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("staging", [True, False])
@pytest.mark.parametrize("variant", [{}, {"n_layers": 4},
                                     {"sliding_window": 6}, "hymba-1.5b",
                                     "xlstm-350m"],
                         ids=["single", "scanned", "windowed", "hymba",
                              "xlstm"])
def test_init_cache_layout_matches_reference(kv, staging, variant):
    """gemma smoke and its variants, and hymba smoke (a hybrid layer's
    {attn, mamba} entry) and xlstm smoke (mLSTM {S, n}, sLSTM {c, n, h})."""
    if isinstance(variant, str):
        rc = dc.replace(ref_config(variant, smoke=True), kv_cache_dtype=kv)
        c = dc.replace(get_config(variant, smoke=True), kv_cache_dtype=kv)
    else:
        rc = dc.replace(RCFG, kv_cache_dtype=kv, **variant)
        c = dc.replace(CFG, kv_cache_dtype=kv, **variant)
    want = _layout(ref_init_cache(rc, 2, 24, staging=staging))
    got = _layout(init_cache(c, 2, 24, staging=staging, device="cpu"))
    assert got == want


# ---------------------------------------------------------- chunk_prefill
PROMPT_LEN, STAGING = 19, 24
CHUNKINGS = {
    "aligned, padded tail": [(0, 8), (8, 8), (16, 8)],
    "sub-chunk start at 12": [(0, 8), (8, 4), (12, 8)],
}


@pytest.mark.parametrize("chunking", list(CHUNKINGS))
@pytest.mark.parametrize("variant", [{}, {"n_layers": 4},
                                     {"sliding_window": 6,
                                      "logit_softcap": 30.0}],
                         ids=["gemma-smoke", "scanned", "window+softcap"])
def test_chunk_prefill_matches_reference(chunking, variant):
    """Chunk by chunk through the reference's jitted chunk step and the
    port's `chunk_prefill`: each chunk's logits within 2e-2 with the same
    argmax, the staging K/V at every prompt position within 2e-2 after the
    last chunk, and the last chunk's logits equal to the port's monolithic
    prefill's."""
    rc = dc.replace(RCFG, **variant)
    c = dc.replace(CFG, **variant)
    ref_params = (REF_PARAMS if not variant else
                  ref_init_params(jax.random.PRNGKey(0), rc))
    params = (PARAMS if not variant else params_from_reference(
        jax.tree.map(np.asarray, ref_params), c, device="cpu"))
    prompt = np.random.default_rng(0).integers(1, c.vocab, PROMPT_LEN)
    ref_caches = ref_init_cache(rc, 1, STAGING, staging=True)
    caches = init_cache(c, 1, STAGING, staging=True, device="cpu")
    for start, size in CHUNKINGS[chunking]:
        n = min(size, PROMPT_LEN - start)
        buf = np.zeros((1, size), np.int32)
        buf[0, :n] = prompt[start:start + n]
        want, ref_caches = ref_chunk_step(rc, size, STAGING)(
            ref_params, jnp.asarray(buf), ref_caches, jnp.int32(start),
            jnp.int32(n))
        got, out = chunk_prefill(params, torch.from_numpy(buf).long(),
                                 caches, start, n, c)
        assert out is caches                  # the staging is written in place
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                                   atol=BF16_TOL)
        assert int(got[0, :c.vocab].argmax()) == int(
            want[0, :c.vocab].argmax())
    for g, w in zip(tree_leaves(caches), jax.tree.leaves(ref_caches)):
        np.testing.assert_allclose(
            g.float().numpy()[..., :PROMPT_LEN, :, :],
            np.asarray(w.astype(jnp.float32))[..., :PROMPT_LEN, :, :],
            rtol=BF16_TOL, atol=BF16_TOL)
    mono, _ = prefill(params,
                      {"tokens": torch.from_numpy(prompt[None]).long()}, c,
                      STAGING)
    assert torch.equal(mono, got)


def test_chunk_prefill_refuses_a_chunk_past_the_staging():
    caches = init_cache(CFG, 1, 8, staging=True, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        chunk_prefill(PARAMS, torch.ones(1, 8, dtype=torch.long), caches, 4,
                      8, CFG)


# ---------------------------------------------------------- allocator
def _begin_grow(alloc_cls):
    a = alloc_cls(4, 2)
    seen = [a.begin_table(0, (1, 2, 3, 4, 5)), list(a.tables[0]),
            a.grow_table(0, 2), list(a.tables[0]), a.grow_table(0, 2)]
    a.begin_table(1, (9, 9))
    seen += [a.grow_table(1, 1), a.grow_table(0, 5), list(a.tables[0]),
             a.n_free]
    a.free_table(0)
    a.free_table(1)
    return seen + [a.n_free == a.n_pages]


def test_allocator_begin_grow_atomic():
    """`test_chunked_prefill.py::test_allocator_begin_grow_atomic`'s
    operations on both allocators: a failed grow allocates nothing."""
    got = _begin_grow(PageAllocator)
    assert got == _begin_grow(RefPageAllocator)
    assert got[0] == 0 and got[1] == [] and got[2] and got[4]
    assert not got[6] and len(got[7]) == 2 and got[-1]


# ----------------------------------------------------- engine schedules
def _run(pkg, schedule, engine_kw):
    """Run `schedule(eng)` on one package's engine, recording the chunk
    shapes its chunk-step cache is asked for; returns what is compared."""
    mod = ref_engine_mod if pkg == "ref" else port_engine_mod
    shapes = set()
    step = mod.cached_chunk_prefill_step

    def recording(cfg, chunk_len, staging_len):
        shapes.add((chunk_len, staging_len))
        return step(cfg, chunk_len, staging_len)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "cached_chunk_prefill_step", recording)
        eng = _engine(pkg, **engine_kw)
        reqs, extra = schedule(eng)
    s = eng.summary()
    arenas = eng.arenas.values()
    return {
        "tokens": [list(r.generated) for r in reqs],
        "status": [r.status.value for r in reqs],
        "preemptions": [r.preemptions for r in reqs],
        "decode_batches": [rec.n_decoded for rec in eng.metrics.steps],
        "chunks_by_step": [rec.n_prefill_chunks for rec in eng.metrics.steps],
        "chunk_shapes": sorted(shapes),
        "cow": sum(a.allocator.cow_copies for a in arenas),
        "shared_hits": sum(a.allocator.shared_hits for a in arenas),
        **{k: s[k] for k in ("prefill_chunks", "prefill_tokens",
                             "prefix_hit_tokens", "requests_finished",
                             "kv_prefix_cached_pages", "kv_prefix_evictions",
                             "installs")},
        **extra}, eng


def _mono_tokens(reqs, cfg):
    """Each request's greedy tokens from the port's monolithic engine."""
    eng = _engine("port", cfg, kv_slots=1, n_pages=64)
    mono = [eng.submit("a", list(r.prompt), max_new_tokens=r.max_new_tokens)
            for r in reqs]
    eng.run()
    return [list(r.generated) for r in mono]


def _check(schedule, engine_kw):
    """Reference and port on one schedule: everything `_run` records must
    be equal; the port's chunked tokens must equal its monolithic ones.
    Returns the port's record."""
    want, _ = _run("ref", schedule, engine_kw)
    got, eng = _run("port", schedule, engine_kw)
    assert got == want
    reqs = [eng.requests[rid] for rid in sorted(eng.requests)]
    assert got["tokens"] == _mono_tokens(reqs, engine_kw.get("cfg"))
    assert eng.summary()["prefill_cache_chunk_traces"] >= len(
        got["chunk_shapes"])
    return got


def _workload(eng, n=6, seed=0, gen=5, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    reqs = [eng.submit("a", rng.integers(1, CFG.vocab,
                                         int(rng.integers(lo, hi))).tolist(),
                       max_new_tokens=gen) for _ in range(n)]
    eng.run()
    return reqs, {}


@pytest.mark.parametrize("chunk,budget", [(4, None), (8, 4)])
def test_paged_chunked_matches_monolithic_and_oracle(chunk, budget):
    got = _check(lambda eng: _workload(eng, seed=1),
                 dict(n_pages=24, chunk=chunk, budget=budget))
    assert got["requests_finished"] == 6
    assert got["prefill_chunks"] >= 6


def test_int8_kv_chunked_matches_monolithic():
    got = _check(lambda eng: _workload(eng, seed=3, n=4),
                 dict(cfg={"kv_cache_dtype": "int8"}, chunk=6))
    assert got["requests_finished"] == 4


def _sharing_and_cow(eng):
    prompt = [7, 3, 9, 2, 5, 8, 1, 4, 6, 2]     # 2 full pages + partial
    reqs = [eng.submit("a", prompt, max_new_tokens=8)]
    eng.step()
    eng.step()
    reqs.append(eng.submit("a", prompt, max_new_tokens=8))
    eng.run()
    a = eng.arenas["a"].allocator
    return reqs, {"drained": a.n_free == a.n_pages and not a.tables}


def test_paged_chunked_prefix_sharing_and_cow_exact():
    got = _check(_sharing_and_cow,
                 dict(n_pages=16, chunk=4, max_prefill=1))
    assert got["shared_hits"] >= 3 and got["cow"] >= 1 and got["drained"]
    assert got["tokens"][0] == got["tokens"][1]


def _exhaustion(eng):
    rng = np.random.default_rng(6)
    p1 = rng.integers(1, CFG.vocab, 4).tolist()
    p2 = rng.integers(1, CFG.vocab, 16).tolist()
    r1 = eng.submit("a", p1, max_new_tokens=17)
    for _ in range(3):
        eng.step()
    r2 = eng.submit("a", p2, max_new_tokens=4)
    statuses = []
    while eng.has_work() and len(statuses) < 200:
        statuses.append(r2.status.value)
        eng.step()
    return [r1, r2], {"r2_statuses": statuses}


def test_paged_mid_prefill_exhaustion_preempts_and_resumes():
    got = _check(_exhaustion, dict(n_pages=6, kv_slots=2, chunk=4, budget=4,
                                   max_prefill=1))
    assert "prefilling" in got["r2_statuses"]
    assert got["preemptions"][0] == 0 and got["preemptions"][1] >= 1
    assert got["prefill_tokens"] == 4 + 16    # resumed, never re-prefilled


def _never_shrinks(eng):
    a = eng.submit("a", [5, 6, 7], max_new_tokens=40)
    b = eng.submit("a", [9, 8, 7, 6], max_new_tokens=40)
    eng.step()
    long = eng.submit("a", list(range(1, 65)), max_new_tokens=2)
    floor = []
    while long.status.value in ("queued", "prefilling"):
        running = sum(r.status.value == "running" for r in (a, b))
        eng.step()
        floor.append((eng.metrics.steps[-1].n_decoded, running))
    eng.run()
    return [a, b, long], {"decoded_vs_running": floor}


def test_decode_batch_never_shrinks_during_chunked_prefill():
    got = _check(_never_shrinks, dict(max_seq=96, chunk=8, budget=8))
    assert all(n >= running for n, running in got["decoded_vs_running"])
    assert sum(1 for c in got["chunks_by_step"] if c) >= 64 // 8


# prefix-cache schedules: `test_prefix_cache.py::cache_engine`
def _cache_kw(*, cache=True, chunk=4, budget=8, n_pages=24, rows=3,
              cache_pages=0, max_prefill=2, cfg=None):
    return dict(cfg=cfg, kv_slots=rows, max_seq=16, n_pages=n_pages,
                prefix_cache=cache, prefix_cache_pages=cache_pages,
                chunk=chunk, budget=budget, max_prefill=max_prefill)


def _warm_twice(prompt_seed, n, gen):
    def schedule(eng):
        prompt = np.random.default_rng(prompt_seed).integers(
            1, CFG.vocab, n).tolist()
        r1 = eng.submit("a", prompt, max_new_tokens=gen)
        eng.run()
        r2 = eng.submit("a", prompt, max_new_tokens=gen)
        eng.run()
        return [r1, r2], {}
    return schedule


def test_warm_request_skips_covered_chunks_token_for_token():
    warm = _check(_warm_twice(3, 16, 6), _cache_kw())
    cold = _check(_warm_twice(3, 16, 6), _cache_kw(cache=False))
    assert warm["tokens"] == cold["tokens"]
    assert warm["prefill_tokens"] == 16 + 1
    assert warm["prefix_hit_tokens"] == 15
    assert cold["prefix_hit_tokens"] == 0 and cold["prefill_tokens"] == 32


def _multi_turn(eng):
    rng = np.random.default_rng(4)
    hist = rng.integers(1, CFG.vocab, 8).tolist()
    reqs = []
    for _ in range(3):
        reqs.append(eng.submit("a", hist, max_new_tokens=4))
        eng.run()
        hist = hist + reqs[-1].generated + rng.integers(
            1, CFG.vocab, 5).tolist()
    return reqs, {"prompt_tokens": sum(len(r.prompt) for r in reqs)}


def test_multi_turn_history_reuse():
    got = _check(_multi_turn, _cache_kw(n_pages=48, budget=None))
    assert (got["prefill_tokens"] + got["prefix_hit_tokens"]
            == got["prompt_tokens"])
    assert got["prefix_hit_tokens"] >= 8


def _eviction(eng):
    rng = np.random.default_rng(5)
    p1 = rng.integers(1, CFG.vocab, 12).tolist()
    r1 = eng.submit("a", p1, max_new_tokens=4)
    eng.run()
    cached = eng.arenas["a"].allocator.tree.n_cached
    r2 = eng.submit("a", rng.integers(1, CFG.vocab, 16).tolist(),
                    max_new_tokens=8)
    eng.run()
    r3 = eng.submit("a", p1, max_new_tokens=4)
    eng.run()
    return [r1, r2, r3], {"cached_after_r1": cached}


def test_eviction_under_pressure_stays_exact():
    got = _check(_eviction, _cache_kw(n_pages=8, rows=2, budget=None))
    assert got["cached_after_r1"] >= 3 and got["kv_prefix_evictions"] >= 1
    assert got["preemptions"] == [0, 0, 0]
    assert got["tokens"][2] == got["tokens"][0]


def _mid_prefill_hit(eng):
    shared = list(range(1, 17))
    donor = eng.submit("a", shared, max_new_tokens=4)
    eng.run()
    tail = np.random.default_rng(6).integers(1, CFG.vocab, 8).tolist()
    long = eng.submit("a", shared + tail, max_new_tokens=3)
    eng.step()
    st = eng._prefills[long.rid]
    seen = {"skipped": st.skipped, "done": st.done}
    eng.preempt(long.rid)
    seen["after_preempt"] = (long.status.value,
                             eng._prefills[long.rid].done)
    eng.run()
    seen["left"] = len(eng._prefills)
    return [donor, long], seen


def test_mid_prefill_hit_and_preempt_resume():
    got = _check(_mid_prefill_hit, _cache_kw(n_pages=32, rows=2, budget=4,
                                             max_prefill=1))
    assert (got["skipped"], got["done"]) == (16, 20)
    assert got["after_preempt"] == ("preempted", 20) and got["left"] == 0
    assert got["prefill_tokens"] == 16 + 8
    assert got["prefix_hit_tokens"] == 16


def _resume_jump(eng):
    arena = eng.arenas["a"]
    rng = np.random.default_rng(10)
    pref = rng.integers(1, CFG.vocab, 24).tolist()
    donor = eng.submit("a", pref, max_new_tokens=5)
    eng.run()
    long = eng.submit("a", pref + rng.integers(1, CFG.vocab, 8).tolist(),
                      max_new_tokens=2)
    arena.skip_ok = False                     # a cold first stint
    eng.step()
    st = eng._prefills[long.rid]
    seen = {"cold_stint": (st.skipped, st.done)}
    eng.preempt(long.rid)
    arena.skip_ok = True
    eng.run()
    return [donor, long], seen


def test_resume_jump_when_coverage_grows_mid_prefill():
    got = _check(_resume_jump, _cache_kw(n_pages=32, rows=2, budget=4,
                                         max_prefill=1))
    assert got["cold_stint"] == (0, 4)
    assert got["prefill_tokens"] == 24 + 4 + 8
    assert got["prefix_hit_tokens"] == 20


def _full_prompt(eng):
    prompt = list(range(2, 10))
    r1 = eng.submit("a", prompt, max_new_tokens=3)
    eng.run()
    r2 = eng.submit("a", prompt, max_new_tokens=3)
    eng.run()
    return [r1, r2], {}


def test_full_prompt_cached_still_emits_first_token():
    got = _check(_full_prompt, _cache_kw(n_pages=24, budget=None))
    assert got["prefill_tokens"] == 8 + 1
    assert got["tokens"][0] == got["tokens"][1]


def test_int8_tenant_skips_covered_chunks_token_for_token():
    int8 = {"kv_cache_dtype": "int8"}
    warm = _check(_warm_twice(7, 12, 5),
                  _cache_kw(cfg=int8, rows=2, budget=None, max_prefill=1))
    cold = _check(_warm_twice(7, 12, 5),
                  _cache_kw(cfg=int8, rows=2, budget=None, max_prefill=1,
                            cache=False))
    assert warm["prefix_hit_tokens"] == 11 and warm["prefill_tokens"] < 24
    assert warm["tokens"][0] == warm["tokens"][1] == cold["tokens"][0]


def _three_distinct(eng):
    rng = np.random.default_rng(8)
    reqs = [eng.submit("a", rng.integers(1, CFG.vocab, 12).tolist(),
                       max_new_tokens=3) for _ in range(3)]
    eng.run()
    return reqs, {"max_cached": eng.arenas["a"].allocator.tree.max_cached}


def test_cache_cap_bounds_resident_pages():
    got = _check(_three_distinct, _cache_kw(n_pages=32, cache_pages=2,
                                            budget=None))
    assert got["max_cached"] == 2 and got["kv_prefix_cached_pages"] <= 2
    assert got["kv_prefix_evictions"] >= 1


# -------------------------------------------------------- two tenants
def _two_tenant_jobs():
    """`test_chunked_prefill.py`'s two-tenant Poisson workload, cut to six
    requests, one of them a long prompt."""
    rng = np.random.default_rng(8)
    t, jobs = 0.0, []
    for i in range(6):
        t += float(rng.exponential(2.0))
        plen = 40 if i == 3 else int(rng.integers(3, 12))
        jobs.append((t, "a" if i % 2 == 0 else "b",
                     rng.integers(1, CFG.vocab, plen).tolist(),
                     int(rng.integers(6, 12))))
    return jobs


def _simulated(pkg):
    clock = (RefVirtualClock if pkg == "ref" else VirtualClock)()
    drive = ref_drive_simulated if pkg == "ref" else drive_simulated

    def schedule(eng):
        drive(eng, clock, _two_tenant_jobs(), dt=1.0)
        return [eng.requests[rid] for rid in sorted(eng.requests)], {}
    return schedule, clock


def test_two_tenants_chunked_under_drive_simulated():
    """Two tenants through a weight arena of n_layers + 1 slots, so they
    take turns; turn-taking sees a tenant with only PREFILLING rows as
    having work.  Tokens, turn schedule (per-step decode batches, chunks)
    and installs equal the reference's."""
    kw = dict(tenants=(("a", 0), ("b", 1)), kv_slots=3, max_seq=64,
              chunk=8, budget=8, weight_slots=CFG.n_layers + 1,
              f32_params=True)
    records = {}
    for pkg in ("ref", "port"):
        schedule, clock = _simulated(pkg)
        records[pkg], eng = _run(pkg, schedule, dict(kw, clock=clock))
    assert records["port"] == records["ref"]
    assert records["port"]["requests_finished"] == 6
    assert records["port"]["installs"] > 2 * CFG.n_layers   # they switched
    for rid, toks in enumerate(records["port"]["tokens"]):
        req = eng.requests[rid]
        alone = _engine("port", tenants=((req.model, 0 if req.model == "a"
                                          else 1),), kv_slots=1, n_pages=64)
        r = alone.submit(req.model, list(req.prompt),
                         max_new_tokens=req.max_new_tokens)
        alone.run()
        assert r.generated == toks, rid


def test_int8_one_token_chunk_matches_monolithic():
    """With bucketing off, a prompt one token past a chunk multiple ends in
    a one-token chunk.  The reference's engine runs it through its decode
    branch, which looks for int8 scales the staging cache does not hold
    (KeyError); the port runs it as a chunk, and its tokens equal its
    monolithic prefill's."""
    kw = dict(cfg={"kv_cache_dtype": "int8"}, kv_slots=1, n_pages=8,
              max_seq=16, growth=0.0)
    chunked = _engine("port", chunk=4, **kw)
    mono = _engine("port", **kw)
    reqs = [e.submit("a", list(range(3, 8)), max_new_tokens=4)
            for e in (chunked, mono)]
    for e in (chunked, mono):
        e.run()
    assert chunked.metrics.prefill_chunks == 2
    assert reqs[0].generated == reqs[1].generated


# ---------------------------------------------------------------- CLI
CHUNK_FLAGS = ("prefill_chunk", "prefill_token_budget", "bucket_growth",
               "staging_growth", "prefix_cache", "prefix_cache_pages")


def test_engine_cli_chunk_flag_defaults_match_the_reference(monkeypatch):
    """The six chunked-prefill and prefix-cache flags of `--engine` have
    the reference parser's defaults (src/repro/launch/serve.py:247-274)."""
    import sys
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    seen = {}
    monkeypatch.setattr(ref_serve, "_run_engine",
                        lambda args: seen.setdefault("args", args))
    monkeypatch.setattr(sys, "argv", ["serve", "--engine"])
    ref_serve.main()
    want = vars(seen["args"])
    got = vars(serve._parser().parse_args(["--engine"]))
    for flag in CHUNK_FLAGS:
        assert got[flag] == want[flag], flag


def test_engine_cli_chunked_prefix_cache_serves_on_cpu(capsys):
    from repro_torch.launch import serve
    args = serve._parser().parse_args(
        ["--engine", "--smoke", "--device", "cpu", "--requests", "4",
         "--prompt-len", "12", "--gen", "4", "--prefill-chunk", "4",
         "--prefill-token-budget", "8", "--kv-layout", "paged",
         "--prefix-cache"])
    serve._run_engine(args)
    out = capsys.readouterr().out
    assert "finished 4 requests" in out
    assert "chunked prefill:" in out and "chunks" in out
