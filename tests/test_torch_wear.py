"""The port's wear plane against the reference on the CPU at gemma-7b
smoke (`tests/test_wear.py`'s checks, held against the reference engine,
`kernel_backend="xla"`, on the same VirtualClock schedules):

  * `gini_coefficient` and every `WearPlane` / `WearMap` view (counts,
    Gini, hottest, histogram, summary, JSON) equal the reference's;
  * per-install cell flips are conserved across the `WearMap`,
    `ResidencyStats` and the registry's `install_cell_flips` histogram,
    with reuse on and off, and `install_energy_j` equals the reference's;
  * KV page writes are the paged arena's page scatters and COW copies one
    for one, and equal the reference's counts;
  * on `two_tenant_jobs`, `WearMap.as_json()` serializes byte-equal to the
    reference engine's, for slot and for paged tenants, and the
    `install_flips` / `wear_gini_weight` trace counters equal its series.
"""
import json

import numpy as np
import pytest

from repro.serving import WearMap as RefWearMap
from repro.serving import WearPlane as RefWearPlane
from repro.serving import gini_coefficient as ref_gini
from repro_torch.serving import WearMap, WearPlane, gini_coefficient
from repro_torch.serving import paging as paging_mod
from repro_torch.sim import EnergyModel
from serving_pair import (RCFG, assert_reference_tokens, drive, make_engine,
                          run_jobs, two_tenant_jobs)


def test_gini_coefficient_matches_reference():
    rng = np.random.default_rng(3)
    cases = [[], [7], [0, 0, 0], [5, 5, 5, 5], [0] * 4 + [9],
             [0] * 31 + [9]]
    cases += [rng.integers(0, 100, int(rng.integers(1, 60)))
              for _ in range(20)]
    cases += [rng.exponential(3.0, 40) for _ in range(5)]
    for c in cases:
        assert gini_coefficient(c) == ref_gini(c)
        assert 0.0 <= gini_coefficient(c) <= 1.0
    assert gini_coefficient([0] * 4 + [9]) == pytest.approx(4 / 5)


def test_wear_plane_and_map_views_match_reference():
    """The same records into both packages' planes: every view, the JSON
    byte for byte; degenerate and invalid planes behave alike."""
    rng = np.random.default_rng(0)
    got, want = WearMap(), RefWearMap()
    for m in (got, want):
        m.add_plane("weight", 7)
        m.add_plane("kv:a", 12, first=1)
        m.add_plane("kv:b", 5, first=1)
    for _ in range(200):
        name = ("weight", "kv:a", "kv:b")[int(rng.integers(0, 3))]
        plane = want.plane(name)
        idx = int(rng.integers(plane.first, plane.first + plane.n))
        kw = dict(writes=int(rng.integers(1, 3)),
                  flips=int(rng.integers(0, 500)),
                  pulses=int(rng.integers(0, 900)),
                  group=(int(rng.integers(0, 3)) if name == "weight"
                         else None))
        for m in (got, want):
            m.plane(name).record(idx, **kw)
        if rng.random() < 0.05:
            for m in (got, want):
                m.plane(name).retire(idx)
    for name in want.planes:
        g, w = got.plane(name), want.plane(name)
        for metric in ("writes", "flips", "pulses"):
            assert g.gini(metric) == w.gini(metric)
            assert g.hottest(4, metric) == w.hottest(4, metric)
            assert g.histogram(metric, 5) == w.histogram(metric, 5)
        assert g.summary() == w.summary()
    for prefix in ("", "kv:", "weight", "none"):
        assert got.gini("flips", prefix) == want.gini("flips", prefix)
    assert json.dumps(got.as_json(), sort_keys=True) == \
        json.dumps(want.as_json(), sort_keys=True)

    solo, ref_solo = WearPlane("solo", 1), RefWearPlane("solo", 1)
    for p in (solo, ref_solo):
        p.record(0, flips=10, pulses=25)
    assert solo.as_json() == ref_solo.as_json()
    assert solo.gini("writes") == 0.0 and solo.hottest() == [(0, 1)]
    with pytest.raises(ValueError):
        WearPlane("empty", 0)
    with pytest.raises(KeyError):
        solo.counts("joules")
    with pytest.raises(ValueError):
        got.add_plane("weight", 3)


def test_energy_model_matches_reference():
    from repro.sim.energy import EnergyModel as RefEnergyModel
    import dataclasses
    assert dataclasses.asdict(EnergyModel()) == \
        dataclasses.asdict(RefEnergyModel())
    em, ref = EnergyModel(), RefEnergyModel()
    for x in (0, 1, 12345, 2.5e9):
        assert em.weight_write_j(x) == ref.weight_write_j(x)
        assert em.kv_write_j(x) == ref.kv_write_j(x)
    assert em.aras_static_w(4, 0.01) == ref.aras_static_w(4, 0.01)


WEAR_KEYS = ("install_cell_flips", "install_write_pulses",
             "install_energy_j", "kv_write_energy_j", "wear_gini_weight",
             "pages_retired", "faults_survived", "slots_retired")

_RUNS = {}


def _run(pkg, layout, reuse=True):
    """The two-tenant run of either package: `two_tenant_jobs()` for slot
    tenants (`tests/test_wear.py::test_flip_conservation_and_reuse_energy`,
    n_layers + 1 weight slots, so turns swap), `two_tenant_jobs(seed=2)`
    through the prefix cache for paged ones, both traced."""
    key = (pkg, layout, reuse)
    if key not in _RUNS:
        paged = layout == "paged"
        _RUNS[key] = drive(pkg, two_tenant_jobs(seed=2 if paged else 0),
                           paged=paged, spare_slots=1, reuse=reuse,
                           traced=True)
    return _RUNS[key]


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "no-reuse"])
def test_flip_conservation_and_energy_match_reference(reuse):
    eng, summary = _run("port", "slot", reuse)
    ref_eng, ref_summary = _run("ref", "slot", reuse)
    stats = eng.residency.stats
    plane = eng.wear.plane("weight")
    assert stats.installs > 0
    # every flip/pulse of an install lands in one slot of the wear plane,
    # one histogram sample and the stats totals
    assert int(plane.flips.sum()) == stats.cell_flips
    assert int(plane.pulses.sum()) == stats.write_pulses
    assert int(plane.writes.sum()) == stats.installs
    assert sum(v[1] for v in plane.by_group.values()) == stats.cell_flips
    assert sum(v[0] for v in plane.by_group.values()) == stats.installs
    hist = eng.metrics.registry.histogram("install_cell_flips")
    assert hist.count == stats.installs
    assert int(hist.sum) == stats.cell_flips
    assert summary["install_energy_j"] == pytest.approx(
        stats.write_pulses * eng.energy_model.write_pulse_j)
    assert "wear_gini_kv" not in summary      # slot arenas: no KV plane
    # ... and all of it equals the reference engine's, bit for bit
    assert_reference_tokens(eng, ref_eng)
    assert {k: summary[k] for k in WEAR_KEYS} == \
        {k: ref_summary[k] for k in WEAR_KEYS}
    ref_hist = ref_eng.metrics.registry.histogram("install_cell_flips")
    assert hist.values == ref_hist.values
    assert plane.by_group == ref_eng.wear.plane("weight").by_group
    if not reuse:
        # the equal-skip programmer spends strictly less write energy
        on = _run("port", "slot", True)[1]
        assert on["steps"] == summary["steps"]
        assert on["install_energy_j"] < summary["install_energy_j"]


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_wear_json_and_trace_counters_match_reference(layout):
    """The wear map's JSON document serializes to the reference engine's
    bytes, and the per-step counter tracks of the wear plane equal its
    series."""
    eng, summary = _run("port", layout)
    ref_eng, ref_summary = _run("ref", layout)
    want_planes = {"weight"} | ({"kv:a", "kv:b"} if layout == "paged"
                                else set())
    assert set(eng.wear.planes) == want_planes
    doc = json.dumps(eng.wear.as_json(), sort_keys=True)
    assert doc == json.dumps(ref_eng.wear.as_json(), sort_keys=True)
    assert json.dumps(eng.wear.as_json(), indent=2, sort_keys=True) == \
        json.dumps(ref_eng.wear.as_json(), indent=2, sort_keys=True)
    assert_reference_tokens(eng, ref_eng)
    assert ("wear_gini_kv" in summary) == (layout == "paged")
    assert {k: v for k, v in summary.items() if "wear" in k
            or "energy" in k or k.startswith("kv_")} == \
        {k: v for k, v in ref_summary.items() if "wear" in k
         or "energy" in k or k.startswith("kv_")}

    def counters(e):
        return [(ev["name"], ev["args"]) for ev in
                e.tracer.chrome_trace_doc()["traceEvents"]
                if ev.get("ph") == "C"]
    got = counters(eng)
    assert {"install_flips", "wear_gini_weight", "kv_free_pages",
            "install_queue_depth"} <= {n for n, _ in got}
    assert got == counters(ref_eng)


def test_kv_page_writes_match_scatter_and_cow(monkeypatch):
    """`tests/test_wear.py::test_kv_page_writes_match_scatter_cow_events`:
    two identical 20-token prompts arriving together share all 3 pages of
    the first and both decode into the shared partial block, forcing one
    COW; every accounted page write is one `page_write` or `page_copy`,
    and the counts equal the reference arena's."""
    calls = {"write": 0, "copy": 0}
    write, copy = paging_mod.page_write, paging_mod.page_copy

    def counting_write(*a):
        calls["write"] += 1
        return write(*a)

    def counting_copy(*a):
        calls["copy"] += 1
        return copy(*a)

    monkeypatch.setattr(paging_mod, "page_write", counting_write)
    monkeypatch.setattr(paging_mod, "page_copy", counting_copy)
    rng = np.random.default_rng(5)
    twin = rng.integers(1, RCFG.vocab, 20).tolist()
    jobs = [(0.0, "a", twin, 6), (0.0, "a", list(twin), 6)]
    for i in range(4):
        jobs.append((2.0 + i, "a", rng.integers(1, RCFG.vocab, 7).tolist(),
                     int(rng.integers(4, 8))))
    out = {}
    for pkg in ("ref", "port"):
        eng, clock = make_engine(pkg, names=("a",))
        summary = run_jobs(pkg, eng, clock, jobs)
        out[pkg] = (eng, summary)
    (eng, summary), (ref_eng, ref_summary) = out["port"], out["ref"]
    arena, ref_arena = eng.arenas["a"], ref_eng.arenas["a"]
    assert summary["requests_finished"] == len(jobs)
    assert arena.kv_page_writes == calls["write"] + calls["copy"]
    assert calls["copy"] == arena.allocator.cow_copies >= 1
    assert arena.kv_page_writes_avoided >= 3   # the twin's shared pages
    plane = eng.wear.plane("kv:a")
    assert plane.first == 1                    # scratch page 0 untracked
    assert int(plane.writes.sum()) == arena.kv_page_writes
    assert summary["kv_write_energy_j"] == pytest.approx(
        eng.energy_model.kv_write_j(arena.kv_bytes_written))
    assert arena.page_bytes == ref_arena.page_bytes
    assert arena.stats() == ref_arena.stats()
    assert (arena.kv_page_writes, arena.kv_bytes_written,
            arena.kv_page_writes_avoided) == \
        (ref_arena.kv_page_writes, ref_arena.kv_bytes_written,
         ref_arena.kv_page_writes_avoided)
    assert plane.as_json() == ref_eng.wear.plane("kv:a").as_json()
    assert_reference_tokens(eng, ref_eng)
