"""The port's slot-layout engine against the reference engine on the CPU
at gemma-7b smoke: on the schedules of `tests/test_serving.py`,
`tests/test_paging.py::test_paged_request_exceeds_slot_max_seq`, the
slot arms of `tests/test_chunked_prefill.py` and the two-tenant traced run
of `tests/test_tracing.py`, the slot engine gives the reference engine's
tokens, statuses, preemptions and per-step decode, prefill, chunk, install
and stall records, bit for bit; and its greedy tokens equal the port's own
sequential oracle (batch-1 prefill, then decode steps at scalar
positions).  `tests/test_torch_slot.py` holds the layers under it.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.nn.model import init_params as ref_init_params
from repro.serving import EngineModel as RefEngineModel
from repro.serving import SchedulerConfig as RefSchedulerConfig
from repro.serving import ServingEngine as RefServingEngine
from repro.serving import Tracer as RefTracer
from repro.serving import VirtualClock as RefVirtualClock
from repro.serving import drive_simulated as ref_drive_simulated
from repro_torch.configs import get_config
from repro_torch.serving import (EngineModel, SchedulerConfig,
                                 ServingEngine, Tracer, VirtualClock,
                                 drive_simulated)
from repro_torch.launch.steps import cached_prefill_step, cached_serve_step
from repro_torch.tree import tree_map
from repro_torch.weights import params_from_reference

RCFG = ref_config("gemma-7b", smoke=True)
CFG = get_config("gemma-7b", smoke=True)
MAX_SEQ = 32
_PARAMS = {}


def _params(seed):
    """(reference params for PRNGKey(seed), port bf16 params through
    `params_from_reference`, port f32 params).  The f32 ones let the port's
    weight store quantize the reference's values, so installs match."""
    if seed not in _PARAMS:
        ref = ref_init_params(jax.random.PRNGKey(seed), RCFG)
        np_p = jax.tree.map(np.asarray, ref)
        _PARAMS[seed] = (ref, params_from_reference(np_p, CFG, device="cpu"),
                         tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  np_p))
    return _PARAMS[seed]


def _engine(pkg, *, tenants=("a",), kv_slots=3, max_seq=MAX_SEQ,
            weight_slots=None, sched=None, clock=None, tracer=None,
            layout="slot", **kw):
    """`tests/test_serving.py::make_engine`-style engine of either package
    ("ref" or "port"); tenant "a" has PRNGKey(0)'s params, "b" PRNGKey(1)'s
    (f32 in the port, so installs match)."""
    ref = pkg == "ref"
    EM, SE, SC = ((RefEngineModel, RefServingEngine, RefSchedulerConfig)
                  if ref else (EngineModel, ServingEngine, SchedulerConfig))
    extra = {} if ref else {"device": "cpu"}
    if clock is not None:
        extra["clock"] = clock
    if tracer is not None:
        extra["tracer"] = tracer
    models = [EM(name, _params(seed)[0 if ref else 2],
                 RCFG if ref else CFG, kv_slots=kv_slots, max_seq=max_seq,
                 kv_layout=layout, **({"page_size": 4, "n_pages": 16}
                                      if layout == "paged" else {}))
              for name, seed in zip(tenants, (0, 1))]
    return SE(models, weight_arena_slots=weight_slots,
              sched=SC(**(sched or dict(max_prefill_per_step=2))), **kw,
              **extra)


def _record(eng, reqs):
    s = eng.summary()
    return {"tokens": [list(r.generated) for r in reqs],
            "status": [r.status.value for r in reqs],
            "preemptions": [r.preemptions for r in reqs],
            "decode_batches": [rec.n_decoded for rec in eng.metrics.steps],
            "prefills": [rec.n_prefills for rec in eng.metrics.steps],
            "chunks": [rec.n_prefill_chunks for rec in eng.metrics.steps],
            "installs": [rec.install_wire_bytes for rec in eng.metrics.steps],
            "stalls": [rec.install_stall for rec in eng.metrics.steps],
            **{k: s[k] for k in ("requests_finished", "requests_rejected",
                                 "max_concurrent", "prefill_tokens",
                                 "prefill_chunks") if k in s}}


def _both(schedule, **engine_kw):
    """Run `schedule(eng) -> (requests, extra)` on both engines; the
    records must be equal.  Returns the port's record and engine."""
    out = {}
    for pkg in ("ref", "port"):
        eng = _engine(pkg, **engine_kw)
        reqs, extra = schedule(eng)
        out[pkg] = ({**_record(eng, reqs), **extra}, eng)
    assert out["port"][0] == out["ref"][0]
    return out["port"]


def _submit_mixed(eng, n, seed=0, gen=6):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(1, CFG.vocab, int(rng.integers(3, 12))).tolist()
        reqs.append(eng.submit("a" if i % 2 == 0 else "b", prompt,
                               max_new_tokens=gen))
    return reqs


def _sequential(prompt, n_new, seed=0, cache_len=MAX_SEQ):
    """The port's oracle, as the reference's: batch-1 prefill, then the
    decode step one token at a time at scalar positions."""
    params = _params(seed)[1]
    logits, caches = cached_prefill_step(CFG, cache_len)(
        params, {"tokens": torch.tensor([prompt])})
    toks = [int(logits[0, :CFG.vocab].argmax())]
    for i in range(n_new - 1):
        logits, caches = cached_serve_step(CFG)(
            params, torch.tensor([toks[-1]]), caches, len(prompt) + i)
        toks.append(int(logits[0, :CFG.vocab].argmax()))
    return toks


TWO = dict(tenants=("a", "b"), weight_slots=CFG.n_layers + 1)


def test_engine_matches_sequential_and_reference():
    def schedule(eng):
        reqs = _submit_mixed(eng, 8)
        eng.run()
        return reqs, {}
    got, eng = _both(schedule, **TWO)
    assert got["requests_finished"] == 8 and got["max_concurrent"] >= 4
    assert any(got["installs"][1:])           # the tenants took turns
    for r in eng.requests.values():
        assert r.generated == _sequential(list(r.prompt), r.max_new_tokens,
                                          seed=0 if r.model == "a" else 1)


def test_requests_join_and_leave_between_steps():
    def schedule(eng):
        short = eng.submit("a", [5, 6, 7], max_new_tokens=2)
        long = eng.submit("a", [8, 9, 10, 11], max_new_tokens=10)
        eng.step()
        late = eng.submit("a", [1, 2, 3, 4, 5], max_new_tokens=3)
        eng.run()
        return [short, long, late], {}
    got, _ = _both(schedule, **TWO)
    assert got["status"] == ["finished"] * 3


def test_eviction_never_corrupts_inflight_requests():
    def schedule(eng):
        reqs = _submit_mixed(eng, 6, seed=3, gen=8)
        for _ in range(4):
            eng.step()
        victim = next(r for r in reqs if r.status.value == "running")
        eng.preempt(victim.rid)
        seen = {"victim": victim.rid, "victim_status": victim.status.value}
        eng.run()
        return reqs, seen
    got, eng = _both(schedule, **TWO)
    assert got["victim_status"] == "preempted"
    assert got["preemptions"][got["victim"]] == 1
    victim = eng.requests[got["victim"]]
    assert victim.generated == _sequential(
        list(victim.prompt), victim.max_new_tokens,
        seed=0 if victim.model == "a" else 1)


def test_slot_reuse_after_eviction_is_isolated():
    """One slot: the second request prefills over the first one's stale
    rows and decodes as if the arena were fresh."""
    def schedule(eng):
        first = eng.submit("a", [9, 8, 7, 6, 5, 4, 3], max_new_tokens=5)
        eng.run()
        second = eng.submit("a", [3, 1, 4], max_new_tokens=5)
        eng.run()
        return [first, second], {}
    got, _ = _both(schedule, kv_slots=1,
                   sched=dict(max_prefill_per_step=1))
    assert got["tokens"][1] == _sequential([3, 1, 4], 5)


def test_admission_control_rejects():
    def schedule(eng):
        too_long = eng.submit("a", list(range(1, MAX_SEQ)), max_new_tokens=8)
        reqs = [too_long] + [eng.submit("a", [i], max_new_tokens=1)
                             for i in (1, 2, 3)]
        eng.run()
        return reqs, {}
    got, _ = _both(schedule, sched=dict(max_queue=2), **TWO)
    assert got["status"] == ["rejected", "finished", "finished", "rejected"]
    assert got["requests_rejected"] == 2


def test_sampled_requests_are_reproducible():
    """A seeded temperature / top-k request beside a greedy one, twice:
    the reference's tokens both times (slot tenants sample split)."""
    def schedule(eng):
        sampled = eng.submit("a", [5, 6, 7, 8], max_new_tokens=6,
                             temperature=0.9, top_k=8, seed=42)
        greedy = eng.submit("a", [5, 6, 7, 8], max_new_tokens=6)
        eng.run()
        return [sampled, greedy], {}
    first, _ = _both(schedule, **TWO)
    again, _ = _both(schedule, **TWO)
    assert first == again
    assert first["tokens"][1] == _sequential([5, 6, 7, 8], 6)


def test_paged_request_exceeds_slot_max_seq():
    """44 tokens through pages of a 16-token max_seq tenant, as the
    reference's paged engine serves them; the slot engine of the same
    max_seq rejects the request, as the reference's does."""
    prompt = np.random.default_rng(1).integers(1, CFG.vocab, 20).tolist()

    def schedule(eng):
        req = eng.submit("a", prompt, max_new_tokens=24)
        eng.run()
        too_big = eng.submit("a", prompt, max_new_tokens=16 * 4)
        return [req, too_big], {}
    paged, _ = _both(schedule, max_seq=16, layout="paged")
    assert paged["status"] == ["finished", "rejected"]
    slot, _ = _both(schedule, max_seq=16)
    assert slot["status"] == ["rejected", "rejected"]


def _workload(eng, n=6, seed=0, gen=5, lo=3, hi=20):
    """`tests/test_chunked_prefill.py::run_workload`."""
    rng = np.random.default_rng(seed)
    reqs = [eng.submit("a", rng.integers(1, CFG.vocab,
                                         int(rng.integers(lo, hi))).tolist(),
                       max_new_tokens=gen) for _ in range(n)]
    eng.run()
    return reqs, {}


@pytest.mark.parametrize("chunk,budget", [(4, None), (8, 4), (16, 3)])
def test_slot_chunked_matches_monolithic_and_reference(chunk, budget):
    mono, _ = _both(_workload, max_seq=48)
    got, _ = _both(_workload, max_seq=48, prefill_chunk=chunk,
                   sched=dict(max_prefill_per_step=2,
                              prefill_token_budget=budget))
    assert got["tokens"] == mono["tokens"]
    assert got["prefill_chunks"] >= 6


def test_slot_explicit_preempt_mid_prefill_resumes():
    prompt = list(range(1, 17))

    def schedule(eng):
        req = eng.submit("a", prompt, max_new_tokens=3)
        eng.step()
        seen = {"status": req.status.value,
                "done": eng._prefills[req.rid].done}
        eng.preempt(req.rid)
        seen["after"] = (req.status.value, req.rid in eng._prefills)
        eng.run()
        return [req], seen
    got, _ = _both(schedule, kv_slots=1, max_seq=48, prefill_chunk=4,
                   sched=dict(max_prefill_per_step=1,
                              prefill_token_budget=4))
    assert (got["status"], got["done"]) == ("prefilling", 4)
    assert got["after"] == ("preempted", True)
    assert got["prefill_tokens"] == len(prompt)      # no chunk re-run
    assert got["tokens"][0] == _sequential(prompt, 3, cache_len=48)


def _tracing_jobs(seed=0, n=8):
    """`tests/test_tracing.py::two_tenant_jobs`."""
    rng = np.random.default_rng(seed)
    t, jobs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(1.5))
        plen = int(rng.integers(3, 10))
        jobs.append((t, "a" if i % 2 == 0 else "b",
                     rng.integers(1, CFG.vocab, plen).tolist(),
                     int(rng.integers(4, 8))))
    return jobs


def test_traced_two_tenant_run_matches_reference():
    """`tests/test_tracing.py::traced_run`: two slot tenants through
    n_layers + 1 weight slots under `drive_simulated`, engine and tracer on
    one VirtualClock.  Tokens, stall steps, install bytes and every
    request's phase sequence equal the reference's."""
    out = {}
    for pkg in ("ref", "port"):
        clock = (RefVirtualClock if pkg == "ref" else VirtualClock)()
        tracer = (RefTracer if pkg == "ref" else Tracer)(clock=clock)
        eng = _engine(pkg, clock=clock, tracer=tracer, **TWO)
        drive = ref_drive_simulated if pkg == "ref" else drive_simulated
        drive(eng, clock, _tracing_jobs(), max_steps=10_000)
        phases = {}
        for e in tracer.chrome_trace_doc()["traceEvents"]:
            if e.get("pid") == 1 and e["ph"] != "M":
                phases.setdefault(e["tid"], []).append(e["name"])
        out[pkg] = {**_record(eng, [eng.requests[r]
                                    for r in sorted(eng.requests)]),
                    "phases": phases, "open": dict(tracer._open_phase)}
    assert out["port"] == out["ref"]
    assert out["port"]["requests_finished"] == 8 and not out["port"]["open"]
    assert any(out["port"]["installs"][1:])   # the tenants took turns
