"""`chip_smoke.py` phase 9's arena and arm B in both packages on the CPU
(`tests/wear_blend_study.py`: two gemma-7b smoke tenants at 6 layers
behind n_layers + 2 weight slots, instant installs, paged at page 16, 8
requests up front, on a VirtualClock, with the wear-aware blend and phase
9's fault rate at a seed that retires one slot and two pages): the
port's weight Gini of cell flips, its Gini of writes over the slots in
service, its flips, installs, retired units, residency stats, wear map
and tokens equal the reference's.
"""
from serving_pair import generated_by_rid
from wear_blend_study import ARMS, measure, run


def test_phase9_arena_wear_and_faults_match_reference():
    ref, eng = run("ref", **ARMS["both"]), run("port", **ARMS["both"])
    got = measure(eng)
    assert got == measure(ref)
    assert got["slots_retired"] == [4] and got["pages_retired"] == 2
    assert eng.wear.as_json() == ref.wear.as_json()
    assert eng.residency.stats.as_dict() == ref.residency.stats.as_dict()
    assert generated_by_rid(eng) == generated_by_rid(ref)
