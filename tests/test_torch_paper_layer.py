"""The port's ARAS paper layer against the reference's on the CPU: the five
paper graphs (every node and its crossbar mapping), the seeded codes bit
for bit, `AcceleratorConfig`/`CrossbarSpec`/`RowPool`, the bank-selection
ILP, `segment_graph`, `simulate_aras` in all five variants (every field of
the result, the instruction stream element by element), a 24-PE pool that
takes the partial-write branch of the write planner, `upper_bound_cycles`,
`simulate_tpu`, `build_schedule` and `validate_schedule`; then
`tests/test_scheduler_sim.py`'s structural checks and paper bands on the
port's own results.

Both sides do the same host float64 arithmetic on equal codes (the port
counts each layer's 256-bin histogram with torch, an exact integer count),
so every float is held with `==`."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import bank_selection as ref_banks
from repro.core import resources as ref_resources
from repro.core import scheduler as ref_scheduler
from repro.models import paper_nets as ref_nets
from repro.sim import aras as ref_aras
from repro.sim import tpu as ref_tpu
from repro.xbar import mapping as ref_mapping
from repro_torch.core import bank_selection, resources, scheduler
from repro_torch.models import PAPER_NETS, paper_nets
from repro_torch.sim import aras, tpu
from repro_torch.sim.energy import EnergyModel
from repro_torch.xbar import mapping

NETS = sorted(PAPER_NETS)
VARIANTS = ("naive", "baseline", "B", "BR", "BRW")
SAMPLES = 50_000                  # test_scheduler_sim's fixtures


def _pair(name, samples=SAMPLES):
    g_ref, g = ref_nets.build_net(name), paper_nets.build_net(name)
    return (g_ref, ref_nets.synth_layer_codes(g_ref, max_samples=samples),
            g, paper_nets.synth_layer_codes(g, max_samples=samples,
                                            device="cpu"))


@pytest.fixture(scope="module")
def resnet():
    return _pair("resnet50")


@pytest.fixture(scope="module")
def bert():
    return _pair("bert_base")


def _sim_fields(r):
    """Every field of a SimResult, the instructions as tuples."""
    out = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    out["instructions"] = [dataclasses.astuple(i) for i in r.instructions]
    return out


def _assert_sim_equal(got, want):
    g, w = _sim_fields(got), _sim_fields(want)
    assert set(g) == set(w)
    assert len(g["instructions"]) == len(w["instructions"])
    for i, (a, b) in enumerate(zip(g["instructions"], w["instructions"])):
        assert a == b, (i, a, b)
    for k in w:
        assert g[k] == w[k], k
    assert got.throughput_inf_s == want.throughput_inf_s
    assert got.total_energy_j == want.total_energy_j


def _port_config(cfg_ref):
    """The port's ArasSimConfig with the reference config's fields."""
    kw = {f.name: getattr(cfg_ref, f.name)
          for f in dataclasses.fields(cfg_ref)}
    kw["accel"] = resources.AcceleratorConfig(**{
        f.name: getattr(kw["accel"], f.name)
        for f in dataclasses.fields(kw["accel"]) if f.name != "xbar"},
        xbar=mapping.CrossbarSpec(**dataclasses.asdict(kw["accel"].xbar)))
    kw["energy"] = EnergyModel(**dataclasses.asdict(kw["energy"]))
    return aras.ArasSimConfig(**kw)


# ------------------------------------------------------------ graphs, codes
@pytest.mark.parametrize("name", NETS)
def test_graph_equals_reference(name):
    g_ref, g = ref_nets.build_net(name), paper_nets.build_net(name)
    assert (g.name, len(g)) == (g_ref.name, len(g_ref))
    assert (g.total_weights, g.total_macs, g.max_act_bytes) == \
        (g_ref.total_weights, g_ref.total_macs, g_ref.max_act_bytes)
    for node, want in zip(g, g_ref):
        assert dataclasses.asdict(node) == dataclasses.asdict(want)
        assert (node.weights, node.weight_bytes, node.macs) == \
            (want.weights, want.weight_bytes, want.macs)
        m, m_ref = node.mapping(), want.mapping()
        assert dataclasses.asdict(m) == dataclasses.asdict(m_ref)
        assert (m.apus, m.weights, m.occupied_rows(mapping.CrossbarSpec())) \
            == (m_ref.apus, m_ref.weights,
                m_ref.occupied_rows(ref_mapping.CrossbarSpec()))


@pytest.mark.parametrize("name", NETS)
def test_synth_layer_codes_bit_equal(name):
    g_ref, codes_ref, g, codes = _pair(name, samples=20_000)
    assert len(codes) == len(codes_ref) == len(g)
    for (n, c), (n_ref, c_ref) in zip(codes, codes_ref):
        assert n == n_ref
        assert c.dtype == torch.uint8 and c.device.type == "cpu"
        np.testing.assert_array_equal(c.numpy(), c_ref)


def test_synth_layer_codes_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paper_nets.synth_layer_codes(paper_nets.build_net("resnet50"),
                                     max_samples=10)


def test_map_layer_and_crossbar_spec():
    for spec_kw in ({}, dict(rows=64, cols=256), dict(rows=256, cols=64)):
        spec, spec_ref = mapping.CrossbarSpec(**spec_kw), \
            ref_mapping.CrossbarSpec(**spec_kw)
        assert (spec.weights_per_row, spec.weight_capacity) == \
            (spec_ref.weights_per_row, spec_ref.weight_capacity)
        for kv, nk, win in ((1, 1, 0), (27, 64, 50176), (4608, 512, 196),
                            (25088, 4096, 1), (129, 33, 7)):
            m = mapping.map_layer(kv, nk, win, spec)
            m_ref = ref_mapping.map_layer(kv, nk, win, spec_ref)
            assert dataclasses.asdict(m) == dataclasses.asdict(m_ref)
            assert m.occupied_rows(spec) == m_ref.occupied_rows(spec_ref)
    for bad in ((0, 4, 1), (4, 0, 1)):
        with pytest.raises(ValueError):
            mapping.map_layer(*bad)
        with pytest.raises(ValueError):
            ref_mapping.map_layer(*bad)


@pytest.mark.parametrize("kw", [{}, dict(num_pes=24),
                                dict(num_pes=7, apu_rows_per_pe=3,
                                     apus_per_row=5, dram_efficiency=0.5)])
def test_accelerator_config_and_row_pool(kw):
    a, a_ref = resources.AcceleratorConfig(**kw), \
        ref_resources.AcceleratorConfig(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(a_ref)
    assert (a.dram_bw_effective, a.total_rows, a.total_apus,
            a.weight_capacity) == (a_ref.dram_bw_effective, a_ref.total_rows,
                                   a_ref.total_apus, a_ref.weight_capacity)
    for apus in (1, 4, 5, 2303, 10_000):
        assert a.rows_for_apus(apus) == a_ref.rows_for_apus(apus)
    for cycles in (0.0, 1.0, 768_000.0, 3.3e9):
        assert a.cycles_to_seconds(cycles) == a_ref.cycles_to_seconds(cycles)
    pool, pool_ref = resources.RowPool(a), ref_resources.RowPool(a_ref)
    for p in (pool, pool_ref):
        assert p.can_allocate(a.total_rows)
        assert not p.can_allocate(a.total_rows + 1)
        p.allocate(a.total_rows - 1)
        with pytest.raises(RuntimeError):
            p.allocate(2)
        p.release(a.total_rows - 1)
        with pytest.raises(RuntimeError):
            p.release(1)
    assert pool.free_rows == pool_ref.free_rows


# ------------------------------------------------------------ bank selection
BYTE_SIZES = (0, 1, 1000, 4096, 50_000, 200_000, 802_816, 1_605_632,
              3_000_000, 3_900_000)


@pytest.mark.parametrize("hetero", [True, False])
def test_select_banks_over_a_grid(hetero):
    sizes = ref_aras.HETERO_BANKS_BYTES if hetero \
        else ref_aras.BASELINE_BANKS_BYTES
    assert sizes == (aras.HETERO_BANKS_BYTES if hetero
                     else aras.BASELINE_BANKS_BYTES)
    em = EnergyModel()
    banks = bank_selection.make_banks(sizes, em.sram_leak_w_per_kb,
                                      em.sram_bank_overhead_w)
    banks_ref = ref_banks.make_banks(sizes, em.sram_leak_w_per_kb,
                                     em.sram_bank_overhead_w)
    assert [dataclasses.astuple(b) for b in banks] == \
        [dataclasses.astuple(b) for b in banks_ref]
    assert bank_selection.total_leakage(banks) == \
        ref_banks.total_leakage(banks_ref)
    feasible = set()
    for i in BYTE_SIZES:
        for o in BYTE_SIZES:
            s = bank_selection.select_banks(banks, i, o)
            s_ref = ref_banks.select_banks(banks_ref, i, o)
            assert dataclasses.astuple(s) == dataclasses.astuple(s_ref), \
                (i, o)
            feasible.add(s.feasible)
    assert feasible == {True, False}        # an infeasible pair is covered


def test_homogeneous_banks_closed_form():
    banks = bank_selection.make_banks((4096,) * 6, 1e-4, 1e-5)
    banks_ref = ref_banks.make_banks((4096,) * 6, 1e-4, 1e-5)
    for i, o in ((0, 0), (4096, 4097), (10_000, 10_000), (20_000, 8192)):
        assert dataclasses.astuple(bank_selection._homogeneous(banks, i, o)) \
            == dataclasses.astuple(ref_banks._homogeneous(banks_ref, i, o))


# ------------------------------------------------------------ segments
@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("pes", [96, 24])
def test_segment_graph_equals_reference(name, pes):
    a, a_ref = resources.AcceleratorConfig(num_pes=pes), \
        ref_resources.AcceleratorConfig(num_pes=pes)
    segs = aras.segment_graph(paper_nets.build_net(name), a)
    segs_ref = ref_aras.segment_graph(ref_nets.build_net(name), a_ref)
    assert [dataclasses.astuple(s) for s in segs] == \
        [dataclasses.astuple(s) for s in segs_ref]
    assert all(s.base_rows <= a.total_rows for s in segs)


# ------------------------------------------------------------ simulator
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("net", ["resnet", "bert"])
def test_simulate_aras_equals_reference(request, net, variant):
    g_ref, codes_ref, g, codes = request.getfixturevalue(net)
    cfg_ref = ref_aras.ArasSimConfig.variant(variant, record_instructions=True)
    cfg = aras.ArasSimConfig.variant(variant, record_instructions=True)
    assert _port_config(cfg_ref) == cfg
    got = aras.simulate_aras(g, codes, cfg)
    _assert_sim_equal(got, ref_aras.simulate_aras(g_ref, codes_ref, cfg_ref))
    assert got.instructions


def test_simulate_aras_partial_writes_equal_reference(resnet):
    """BRW on a quarter of the pool: the write planner hands out chunks
    that do not cover a segment, and continues them later (the partial
    branch of `plan_and_issue`)."""
    g_ref, codes_ref, g, codes = resnet
    cfg_ref = dataclasses.replace(
        ref_aras.ArasSimConfig.variant("BRW", record_instructions=True),
        accel=ref_resources.AcceleratorConfig(num_pes=24))
    cfg = _port_config(cfg_ref)
    got = aras.simulate_aras(g, codes, cfg)
    _assert_sim_equal(got, ref_aras.simulate_aras(g_ref, codes_ref, cfg_ref))
    partial = [i for i in got.instructions
               if i.kind == "write" and i.fraction < 1.0]
    assert partial, "the 24-PE run did not reach the partial-write branch"
    # a continued segment: written in more than one chunk
    names = [i.segment for i in got.instructions if i.kind == "write"]
    assert any(names.count(i.segment) > 1 for i in partial)


@pytest.mark.parametrize("name", NETS)
def test_upper_bound_and_tpu_equal_reference(name):
    g_ref, g = ref_nets.build_net(name), paper_nets.build_net(name)
    for pes in (96, 24):
        assert aras.upper_bound_cycles(
            g, resources.AcceleratorConfig(num_pes=pes)) == \
            ref_aras.upper_bound_cycles(
                g_ref, ref_resources.AcceleratorConfig(num_pes=pes))
    assert dataclasses.asdict(tpu.TpuConfig()) == \
        dataclasses.asdict(ref_tpu.TpuConfig())
    for kw in ({}, dict(dram_bw_bytes_per_s=3e9)):
        got = tpu.simulate_tpu(g, **kw)
        want = ref_tpu.simulate_tpu(g_ref, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.total_energy_j == want.total_energy_j


# ------------------------------------------------------------ scheduler
def _schedules(pair, variant="BRW"):
    g_ref, codes_ref, g, codes = pair
    return (scheduler.build_schedule(g, codes,
                                     aras.ArasSimConfig.variant(variant)),
            ref_scheduler.build_schedule(
                g_ref, codes_ref, ref_aras.ArasSimConfig.variant(variant)))


@pytest.mark.parametrize("net", ["resnet", "bert"])
@pytest.mark.parametrize("variant", ["BRW", "baseline"])
def test_build_schedule_equals_reference(request, net, variant):
    got, want = _schedules(request.getfixturevalue(net), variant)
    assert got.reuse_center == want.reuse_center
    assert len(got.encodings) == len(want.encodings)
    for e, e_ref in zip(got.encodings, want.encodings):
        assert (e.name, e.offset, e.clip_rate) == \
            (e_ref.name, e_ref.offset, e_ref.clip_rate)
        np.testing.assert_array_equal(e.hist, e_ref.hist)
    assert {k: dataclasses.astuple(v) for k, v in got.bank_plan.items()} == \
        {k: dataclasses.astuple(v) for k, v in want.bank_plan.items()}
    _assert_sim_equal(got.predicted, want.predicted)
    assert got.makespan_s == want.makespan_s
    assert [dataclasses.astuple(i) for i in got.writes()] == \
        [dataclasses.astuple(i) for i in want.writes()]
    assert [dataclasses.astuple(i) for i in got.computes()] == \
        [dataclasses.astuple(i) for i in want.computes()]
    assert scheduler.validate_schedule(got) == [] == \
        ref_scheduler.validate_schedule(want)


def test_validate_schedule_reports_what_the_reference_reports(resnet):
    """The same three faults put into both schedules: a compute moved
    before its predecessor ends and before its writes complete, one
    segment's writes dropped, one left at half its fraction."""
    got, want = _schedules(resnet)
    for s in (got, want):
        computes = s.computes()
        computes[5].t_start_cycles = computes[4].t_start_cycles
        dropped = computes[9].segment
        s.instructions = [i for i in s.instructions
                          if not (i.kind == "write" and i.segment == dropped)]
        half = next(i for i in s.instructions if i.kind == "write"
                    and i.segment == computes[12].segment)
        half.fraction = 0.5
    errors = scheduler.validate_schedule(got)
    assert errors == ref_scheduler.validate_schedule(want)
    assert len(errors) >= 3, errors


# ------------------------------------------------------------ paper bands
def test_schedule_is_valid_and_overlap_beats_naive(resnet):
    *_, g, codes = resnet
    sched = scheduler.build_schedule(g, codes, aras.ArasSimConfig.variant("BRW"))
    assert scheduler.validate_schedule(sched) == []
    naive = aras.simulate_aras(g, codes, aras.ArasSimConfig.variant("naive"))
    base = aras.simulate_aras(g, codes,
                              aras.ArasSimConfig.variant("baseline"))
    assert base.makespan_s < naive.makespan_s


def test_replication_weight_reuse_and_upper_bound(resnet, bert):
    for pair, expect_gain in ((resnet, True), (bert, False)):
        *_, g, codes = pair
        base = aras.simulate_aras(g, codes,
                                  aras.ArasSimConfig.variant("baseline"))
        br = aras.simulate_aras(g, codes, aras.ArasSimConfig.variant("BR"))
        brw = aras.simulate_aras(g, codes, aras.ArasSimConfig.variant("BRW"))
        if expect_gain:
            assert br.makespan_s < base.makespan_s * 0.75
            assert brw.total_pulses < br.total_pulses * 0.95
        else:
            assert br.makespan_s == pytest.approx(base.makespan_s, rel=1e-6)
        assert brw.makespan_s == pytest.approx(br.makespan_s, rel=1e-6)
        ub = aras.upper_bound_cycles(g, resources.AcceleratorConfig()) / 1e9
        for r in (base, brw):
            assert r.makespan_s >= ub * 0.999
        for k, v in brw.energy.items():
            assert v >= 0.0, k
        assert brw.energy["total"] == pytest.approx(
            sum(v for k, v in brw.energy.items() if k != "total"))


def test_paper_claim_bands(resnet, bert):
    """tests/test_scheduler_sim.py's bands on the port: ResNet speedup
    1.7-2.7x, BRW pulse ratio 0.70-0.95, energy ratio 0.6-0.88, BERT
    1.0x within 0.05; ARAS faster and cheaper than the TPU-like
    baseline."""
    *_, g, codes = resnet
    base = aras.simulate_aras(g, codes, aras.ArasSimConfig.variant("baseline"))
    brw = aras.simulate_aras(g, codes, aras.ArasSimConfig.variant("BRW"))
    assert 1.7 <= base.makespan_s / brw.makespan_s <= 2.7
    assert 0.70 <= brw.total_pulses / base.total_pulses <= 0.95
    assert 0.6 <= brw.total_energy_j / base.total_energy_j <= 0.88
    t = tpu.simulate_tpu(g)
    assert t.makespan_s / brw.makespan_s > 1.0
    assert brw.total_energy_j / t.total_energy_j < 1.0

    *_, g, codes = bert
    base = aras.simulate_aras(g, codes, aras.ArasSimConfig.variant("baseline"))
    brw = aras.simulate_aras(g, codes, aras.ArasSimConfig.variant("BRW"))
    assert base.makespan_s / brw.makespan_s == pytest.approx(1.0, abs=0.05)
