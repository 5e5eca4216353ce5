"""The port's fault sweep against the reference on the CPU at gemma-7b
smoke (`tests/test_faults.py::test_fault_sweep_token_equivalent_with_survivals`
and `::test_fault_replay_is_deterministic_per_seed`, held against the
reference engine, `kernel_backend="xla"`, on the same VirtualClock
schedules): over several fault rates the port gives the reference's
tokens, its retired slot and page sets and its wear map, with every page
free, referenced or retired; a replay with the same seed is
deterministic, and another seed faults other units with the same tokens.
"""
import json

from serving_pair import (assert_reference_tokens, drive, generated_by_rid,
                          two_tenant_jobs)


def _assert_conserved(eng):
    """Every page is free, referenced or retired, never two of those, and
    no table holds a retired page; retired weight slots hold nothing."""
    for arena in eng.arenas.values():
        a = arena.allocator
        free = {p for _, p in a._free} if a.wear_aware else set(a._free)
        referenced = {p for p in range(1, a.n_pages + 1)
                      if a.refcount[p] > 0}
        assert len(free) == a.n_free
        assert not free & referenced
        assert not a.retired & (free | referenced)
        assert len(free) + len(referenced) + len(a.retired) == a.n_pages
        assert not {p for t in a.tables.values() for p in t} & a.retired
    res = eng.residency
    assert all(res.slots[s] is None for s in res.retired)
    assert not set(res.resident.values()) & res.retired


def test_fault_sweep_matches_reference():
    jobs = two_tenant_jobs(seed=4, n=12)
    baseline = None
    survived = {}
    for rate in (0.0, 0.01, 0.02, 0.08):
        runs = {pkg: drive(pkg, jobs, fault_rate=rate, fault_seed=11)
                for pkg in ("ref", "port")}
        (eng, s), (ref, ref_s) = runs["port"], runs["ref"]
        assert s["requests_finished"] == len(jobs)
        tokens = generated_by_rid(eng)
        baseline = baseline or tokens
        assert tokens == baseline, f"rate {rate} changed tokens"
        assert_reference_tokens(eng, ref)
        assert s["faults_survived"] == s["slots_retired"] + \
            s["pages_retired"]
        for k in ("faults_survived", "slots_retired", "pages_retired",
                  "kv_pages_retired", "wear_gini_kv", "steps"):
            assert s[k] == ref_s[k], (rate, k)
        assert eng.residency.retired == ref.residency.retired
        for name in eng.arenas:
            assert eng.arenas[name].allocator.retired == \
                ref.arenas[name].allocator.retired
        assert eng.wear.as_json() == ref.wear.as_json()
        if rate:
            assert eng.faults.stats() == ref.faults.stats()
        _assert_conserved(eng)
        survived[rate] = s["faults_survived"]
    assert survived[0.0] == 0
    assert survived[0.08] > 0


def test_fault_replay_is_deterministic_per_seed():
    jobs = two_tenant_jobs(seed=5, n=8)
    docs = {}
    for pkg, seed in (("port", 21), ("port", 21), ("port", 22),
                      ("ref", 21)):
        eng, s = drive(pkg, jobs, fault_rate=0.08, fault_seed=seed)
        docs.setdefault((pkg, seed), []).append(
            (json.dumps(eng.wear.as_json(), sort_keys=True),
             s["faults_survived"], generated_by_rid(eng)))
    (a, b), (c,), (ref,) = (docs["port", 21], docs["port", 22],
                            docs["ref", 21])
    assert a == b == ref
    assert c[0] != a[0]                # other units fault under seed 22
    assert c[2] == a[2]                # ...but no token moves
