"""Shared set-up of the port's wear, fault and telemetry parity tests
(`tests/test_torch_{wear,faults,telemetry}.py`): the two-tenant gemma-7b
smoke engine of `tests/test_wear.py`, `tests/test_faults.py` and
`tests/test_telemetry.py`, built from the same arguments in either
package, on the same weights.

Tenant "a" holds the reference's `init_params(PRNGKey(0))`, tenant "b" its
`perturbed_variant`.  The port is given them as f32 tensors: its weight
store quantizes what it is given, and only the reference's own f32 values
give the reference's codes, pair costs, victims and flips (the model casts
to bf16 at use, so the logits do not depend on it).
"""
import jax
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.nn.model import init_params as ref_init_params
from repro.serving import EngineModel as RefEngineModel
from repro.serving import SchedulerConfig as RefSchedulerConfig
from repro.serving import ServingEngine as RefServingEngine
from repro.serving import Tracer as RefTracer
from repro.serving import VirtualClock as RefVirtualClock
from repro.serving import drive_simulated as ref_drive_simulated
from repro.serving.variants import perturbed_variant as ref_variant
from repro_torch.configs import get_config
from repro_torch.serving import (EngineModel, SchedulerConfig,
                                 ServingEngine, Tracer, VirtualClock,
                                 drive_simulated)
from repro_torch.tree import tree_map

RCFG = ref_config("gemma-7b", smoke=True)
CFG = get_config("gemma-7b", smoke=True)
MAX_SEQ = 48
N_PAGES = 24
PAGE = 8
_PARAMS = {}


def params(pkg):
    """{"a": params, "b": params} of one package (reference: jax arrays;
    port: f32 torch tensors of the same values)."""
    if not _PARAMS:
        a = ref_init_params(jax.random.PRNGKey(0), RCFG)
        b = ref_variant(a)
        _PARAMS["ref"] = {"a": a, "b": b}
        _PARAMS["port"] = {
            n: tree_map(lambda x: torch.from_numpy(np.array(x)),
                        jax.tree.map(np.asarray, p))
            for n, p in (("a", a), ("b", b))}
    return _PARAMS[pkg]


def two_tenant_jobs(seed=0, n=10):
    """The reference tests' `two_tenant_jobs`: alternating tenants,
    exponential arrival gaps of mean 1.5, prompts of 3-9 tokens, 4-7 new
    tokens."""
    rng = np.random.default_rng(seed)
    t, jobs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(1.5))
        plen = int(rng.integers(3, 10))
        jobs.append((t, "a" if i % 2 == 0 else "b",
                     rng.integers(1, RCFG.vocab, plen).tolist(),
                     int(rng.integers(4, 8))))
    return jobs


def api(pkg):
    """(ServingEngine, EngineModel, SchedulerConfig, VirtualClock, Tracer,
    drive_simulated) of one package."""
    if pkg == "ref":
        return (RefServingEngine, RefEngineModel, RefSchedulerConfig,
                RefVirtualClock, RefTracer, ref_drive_simulated)
    return (ServingEngine, EngineModel, SchedulerConfig, VirtualClock,
            Tracer, drive_simulated)


def make_engine(pkg, *, paged=True, prefix_cache=True, names=("a", "b"),
                spare_slots=2, traced=False, clock=None, **knobs):
    """The reference tests' `make_engine` in either package: 3 KV rows a
    tenant of max_seq 48 (paged: 24 pages of 8), a weight arena of
    n_layers + `spare_slots` slots, two prefills a step, on a VirtualClock
    (with a Tracer on the same clock when `traced`).  Returns (engine,
    clock)."""
    SE, EM, SC, VC, TR, _ = api(pkg)
    clock = clock or VC()
    kv = dict(kv_slots=3, max_seq=MAX_SEQ)
    if paged:
        kv.update(kv_layout="paged", page_size=PAGE, n_pages=N_PAGES,
                  prefix_cache=prefix_cache)
    cfg = RCFG if pkg == "ref" else CFG
    if pkg == "port":
        knobs["device"] = "cpu"
    p = params(pkg)
    eng = SE([EM(n, p[n], cfg, **kv) for n in names],
             weight_arena_slots=CFG.n_layers + spare_slots,
             sched=SC(max_prefill_per_step=2), clock=clock,
             tracer=TR(clock=clock) if traced else None, **knobs)
    return eng, clock


def run_jobs(pkg, eng, clock, jobs, **kw):
    """The package's `drive_simulated` over `jobs`; returns the summary."""
    return api(pkg)[5](eng, clock, jobs, max_steps=10_000, **kw)


def drive(pkg, jobs, *, dt=1.0, drive_kwargs=None, **engine_kw):
    """Build `make_engine(pkg, **engine_kw)` and drive it over `jobs`;
    returns (engine, summary)."""
    eng, clock = make_engine(pkg, **engine_kw)
    return eng, run_jobs(pkg, eng, clock, jobs, dt=dt, **(drive_kwargs or {}))


def generated_by_rid(eng):
    return {r.rid: tuple(r.generated) for r in eng.requests.values()}


# (tenant, prompt) -> index of the generated token where the port and the
# reference engine part at a bf16 tie (ROADMAP §3): XLA CPU sums a bf16
# product over a batch of two or more rows in another order than over one
# row, torch in neither, so one logit can round one bf16 ulp apart.  Here
# the reference's batched decode puts token 52 one ulp under token 257,
# the port's puts them level, and argmax takes the lower id.  It is the
# fifth and last token of `two_tenant_jobs()`'s request 7 (tenant "b").
KNOWN_TIES = {("b", (368, 455, 38, 478, 272)): 4}


def assert_reference_tokens(eng, ref_eng):
    """Every request's greedy tokens equal the reference engine's, but for
    a request in `KNOWN_TIES`, whose tokens agree up to its tie and differ
    at it."""
    want = generated_by_rid(ref_eng)
    got = generated_by_rid(eng)
    assert set(got) == set(want)
    for rid, w in want.items():
        req = eng.requests[rid]
        tie = KNOWN_TIES.get((req.model, req.prompt))
        if tie is None or len(w) <= tie:
            assert got[rid] == w, rid
        else:
            assert len(got[rid]) == len(w)
            assert got[rid][:tie] == w[:tie] and got[rid][tie] != w[tie], \
                (rid, got[rid], w)
