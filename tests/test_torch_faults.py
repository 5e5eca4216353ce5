"""The port's stuck-at faults and wear-aware placement against the
reference on the CPU at gemma-7b smoke (`tests/test_faults.py`'s checks,
held against the reference engine, `kernel_backend="xla"`, on the same
VirtualClock schedules; its sweep and replay are in
`tests/test_torch_fault_sweep.py`):

  * `FaultModel.check` decides as the reference's over a grid of seeds,
    planes, units and write ordinals;
  * with both knobs off the run is byte-identical to the default engine's
    and to the reference's (Chrome trace);
  * wear-aware placement flattens the weight plane's Gini with the tokens
    unchanged, as the reference's does, and hands out KV pages coldest
    first in the reference's order;
  * a stuck weight slot is retired and remapped, and a fault storm
    exhausts the arena at the reference's step with its message.
"""
import json

import pytest

from repro.serving import FaultModel as RefFaultModel
from repro_torch.serving import FaultModel
from serving_pair import (assert_reference_tokens, drive, generated_by_rid,
                          make_engine, run_jobs, two_tenant_jobs)


def test_fault_model_decisions_match_reference():
    for rate in (0.0, 0.05, 0.5, 1.0):
        for seed in (0, 7, 11, 2**40 + 3):
            got, want = FaultModel(rate, seed), RefFaultModel(rate, seed)
            for plane in ("weight", "kv", "kv:a", "kv:tenant-b"):
                for unit in range(24):
                    for _ in range(4):      # write ordinals 0..3
                        assert got.check(plane, unit) == \
                            want.check(plane, unit), (rate, seed, plane,
                                                      unit)
            assert got.stats() == want.stats()
            assert got._uniform("kv", 5, 9) == want._uniform("kv", 5, 9)
    # a fixed seed replays, another moves the stream; ordinals advance it
    a, b, c = FaultModel(0.1, 7), FaultModel(0.1, 7), FaultModel(0.1, 8)
    seq = [a.check("kv", u) for u in (1, 2, 3) * 40]
    assert seq == [b.check("kv", u) for u in (1, 2, 3) * 40]
    assert seq != [c.check("kv", u) for u in (1, 2, 3) * 40]
    assert a.checks == 120
    m = FaultModel(0.5, seed=3)
    draws = [m.check("kv", 9) for _ in range(64)]
    assert any(draws) and not all(draws)
    for bad in (1.5, -0.1):
        with pytest.raises(ValueError):
            FaultModel(bad)


def test_knobs_off_is_byte_identical_to_default_and_reference():
    jobs = two_tenant_jobs(seed=1, n=8)
    docs, tokens = [], []
    for pkg, knobs in (("port", {}),
                       ("port", {"wear_aware": 0.0, "fault_rate": 0.0}),
                       ("ref", {})):
        eng, _ = drive(pkg, jobs, traced=True, **knobs)
        assert eng.faults is None               # rate 0: no model built
        docs.append(json.dumps(eng.tracer.chrome_trace_doc(),
                               sort_keys=True))
        tokens.append(generated_by_rid(eng))
    assert docs[0] == docs[1] == docs[2]
    assert tokens[0] == tokens[1] == tokens[2]


WEAR_KEYS = ("wear_gini_weight", "wear_gini_kv", "install_energy_j",
             "kv_write_energy_j", "install_cell_flips", "steps")


def test_wear_aware_flattens_weight_gini_as_the_reference():
    """n_layers + 1 slots: too small for both tenants, so turns swap, and
    min-delta alone would never touch the spare slot; the wear blend
    rotates writes into it, token-identically, with the reference's
    victims (the weight plane's JSON equal)."""
    jobs = two_tenant_jobs(seed=2, n=12)
    arms = {(pkg, w): drive(pkg, jobs, spare_slots=1, wear_aware=w)
            for pkg in ("ref", "port") for w in (0.0, 1.0)}
    (eng_off, s_off), (eng_on, s_on) = arms["port", 0.0], arms["port", 1.0]
    assert s_on["steps"] == s_off["steps"]
    assert generated_by_rid(eng_on) == generated_by_rid(eng_off)
    assert s_on["wear_gini_weight"] < s_off["wear_gini_weight"]
    on, off = (e.wear.plane("weight").writes for e in (eng_on, eng_off))
    assert int(on.sum()) > 0 and int(on.min()) >= int(off.min())
    for w in (0.0, 1.0):
        (eng, s), (ref, ref_s) = arms["port", w], arms["ref", w]
        assert {k: s[k] for k in WEAR_KEYS} == \
            {k: ref_s[k] for k in WEAR_KEYS}
        assert eng.wear.as_json() == ref.wear.as_json()
        assert_reference_tokens(eng, ref)
    with pytest.raises(ValueError, match="wear_aware"):
        make_engine("port", wear_aware=-1.0)


def test_wear_aware_page_allocation_is_coldest_first():
    jobs = [(t, "a", prompt, n) for t, _, prompt, n
            in two_tenant_jobs(seed=3, n=6)]
    order = {}
    for pkg in ("ref", "port"):
        eng, _ = drive(pkg, jobs, names=("a",), wear_aware=1.0)
        alloc = eng.arenas["a"].allocator
        assert alloc.wear_aware
        pages = [alloc._take_page() for _ in range(min(alloc.n_free, 8))]
        order[pkg] = [(p, int(alloc.wear.writes[p - 1])) for p in pages]
    wear = [w for _, w in order["port"]]
    assert wear == sorted(wear) and len(wear) == 8
    assert order["port"] == order["ref"]


class ScriptedFaults:
    """Duck-typed FaultModel: slot 0 of the weight plane is stuck."""

    def check(self, plane, unit):
        return plane == "weight" and unit == 0


def test_weight_slot_fault_retires_and_remaps():
    jobs = two_tenant_jobs(seed=6, n=8)
    out = {}
    for pkg in ("ref", "port"):
        eng, clock = make_engine(pkg)
        eng.residency.faults = ScriptedFaults()
        s = run_jobs(pkg, eng, clock, jobs)
        out[pkg] = (eng, s)
    (eng, s), (ref, ref_s) = out["port"], out["ref"]
    base, _ = drive("port", jobs)
    res = eng.residency
    assert res.stats.slots_retired == 1 and res.retired == {0}
    assert res.slots[0] is None and 0 not in set(res.resident.values())
    assert 0 in res.wear.retired
    assert s["slots_retired"] == 1.0
    assert s["requests_finished"] == len(jobs)
    assert generated_by_rid(eng) == generated_by_rid(base)
    assert res.stats.as_dict() == ref.residency.stats.as_dict()
    assert res.slots == ref.residency.slots
    assert eng.wear.as_json() == ref.wear.as_json()


def test_arena_exhausted_by_faults_where_the_reference_is():
    """A fault storm over a two-spare arena: both engines raise the same
    RuntimeError in the same step, with the same slots retired."""
    jobs = two_tenant_jobs(seed=6, n=8)
    seen = {}
    for pkg in ("ref", "port"):
        eng, clock = make_engine(pkg, fault_rate=0.5, fault_seed=3)
        with pytest.raises(RuntimeError, match="exhausted by faults") as e:
            run_jobs(pkg, eng, clock, jobs)
        seen[pkg] = (str(e.value), eng._step_no, sorted(eng.residency.retired),
                     eng.residency.stats.as_dict())
    assert seen["port"] == seen["ref"]
