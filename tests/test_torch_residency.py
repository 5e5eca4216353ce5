"""The port's ARAS weight arena against the reference on the CPU:
`perturbed_variant` bit for bit; `WeightResidencyManager` over `ensure`
sequences (stats, slot map, resident map and every memoised pair cost bit
for bit) with independent tenants, a perturbed variant, an identical copy,
reuse off and an arena too small; an `InstallPipeline` begin/pump
sequence; and the two-tenant paged engine on `tests/test_install_overlap.py`'s
Poisson schedule under `drive_simulated` on a `VirtualClock`, in four
arms (instant `ensure`, the tick-budgeted pipeline, the pipeline with
overlap, and the pipeline with reuse off): per-request greedy tokens,
per-step install bytes and stall steps, and the summary equal to the
reference paged engine's (`kernel_backend="xla"`).

The reference quantizes its f32 params, so the port is given the same f32
params (not `params_from_reference`'s bf16: quantizing bf16-rounded
weights gives other codes, then other wire bytes and victims); the port's
model casts every matrix to bf16 at use, as the reference does, so its
logits from f32 params equal those from the bf16 params bit for bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.nn.model import init_params as ref_init_params
from repro.serving import EngineModel as RefEngineModel
from repro.serving import InstallCostModel as RefInstallCostModel
from repro.serving import InstallPipeline as RefInstallPipeline
from repro.serving import SchedulerConfig as RefSchedulerConfig
from repro.serving import ServingEngine as RefServingEngine
from repro.serving import VirtualClock as RefVirtualClock
from repro.serving import WeightResidencyManager as RefResidency
from repro.serving import drive_simulated as ref_drive_simulated
from repro.serving.variants import perturbed_variant as ref_variant
from repro_torch.configs import get_config
from repro_torch.serving import (EngineModel, InstallCostModel,
                                 InstallPipeline, SchedulerConfig,
                                 ServingEngine, VirtualClock,
                                 WeightResidencyManager, drive_simulated)
from repro_torch.serving import variants
from repro_torch.launch.steps import prefill_step  # after serving: it imports
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import params_from_reference

RCFG = ref_config("gemma-7b", smoke=True)
CFG = get_config("gemma-7b", smoke=True)
TURN_STEPS = 4
MAX_SEQ = 32


def _port(np_params):
    """The reference's f32 numpy params as f32 torch tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), np_params)


@pytest.fixture(scope="module")
def params():
    """{name: (reference numpy params, port f32 params)} for two
    independent inits (keys 0 and 1) and the reference's perturbed
    variant of the first."""
    a = jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0), RCFG))
    b = jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(1), RCFG))
    v = ref_variant(a)
    return {name: (p, _port(p)) for name, p in (("a", a), ("b", b),
                                                ("v", v))}


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        elif isinstance(want[k], (list, tuple)):
            assert len(got[k]) == len(want[k])
            for g, w in zip(got[k], want[k]):
                _assert_tree_equal(g, w)
        else:
            g = got[k].numpy()
            assert g.dtype == want[k].dtype
            np.testing.assert_array_equal(g, want[k])


def test_perturbed_variant_matches_reference(params, monkeypatch):
    """Bit for bit, including when the normals are drawn in chunks that do
    not divide the leaves (a sequential Generator gives the same stream)."""
    np_a, a = params["a"]
    want = params["v"][0]
    _assert_tree_equal(variants.perturbed_variant(a), want)
    monkeypatch.setattr(variants, "CHUNK", 1000)
    _assert_tree_equal(variants.perturbed_variant(a), want)
    # small leaves (norm scales) are not perturbed
    assert torch.equal(variants.perturbed_variant(a)["final_norm"]["scale"],
                       a["final_norm"]["scale"])


def test_perturbed_variant_of_bf16_params():
    """A bf16 leaf (full-width params live in bf16) keeps its dtype and
    takes noise of std scale·std(leaf)."""
    gen = torch.Generator().manual_seed(0)
    leaf = (torch.randn(64, 512, generator=gen) * 3.0).bfloat16()
    small = leaf[0]
    out = variants.perturbed_variant({"w": leaf, "b": small})
    assert out["w"].dtype == torch.bfloat16 and out["b"] is small
    noise = (out["w"].float() - leaf.float()).std().item()
    assert abs(noise / (0.02 * leaf.float().std().item()) - 1) < 0.1


def _residency_state(res):
    return (res.stats.as_dict(), list(res.slots), dict(res.resident),
            dict(res._cost_cache))


def _assert_same_residency(got, want):
    g_stats, g_slots, g_res, g_costs = _residency_state(got)
    w_stats, w_slots, w_res, w_costs = _residency_state(want)
    assert g_stats == w_stats
    assert g_slots == w_slots and g_res == w_res
    assert g_costs == w_costs


CASES = {
    # tenants, arena slots, reuse, ensure sequence (model, pinned)
    "independent": (("a", "b"), CFG.n_layers + 1, True,
                    [("a", ()), ("b", ()), ("a", ()), ("b", ("a",)),
                     ("b", ()), ("a", ())]),
    "variant": (("a", "v"), CFG.n_layers + 1, True,
                [("a", ()), ("v", ()), ("a", ()), ("v", ())]),
    "reuse-off": (("a", "b"), CFG.n_layers + 1, False,
                  [("a", ()), ("b", ()), ("a", ()), ("b", ())]),
    "copy": (("a", "a"), CFG.n_layers, True, [("a", ()), ("a2", ())]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_residency_matches_reference(params, case):
    names, slots, reuse, ops = CASES[case]
    if case == "copy":        # an identical second tenant
        tenants = {"a": params["a"], "a2": params["a"]}
    else:
        tenants = {n: params[n] for n in names}
    want = RefResidency({n: (p[0], RCFG) for n, p in tenants.items()}, slots,
                        reuse=reuse)
    got = WeightResidencyManager({n: (p[1], CFG) for n, p in tenants.items()},
                                 slots, reuse=reuse, device="cpu")
    assert got.fits(tenants) == want.fits(tenants)
    wires = []
    for step, (model, pinned) in enumerate(ops):
        if pinned and not want.fits({model, *pinned}):
            with pytest.raises(RuntimeError):
                want.ensure(model, step, pinned=set(pinned))
            with pytest.raises(RuntimeError):
                got.ensure(model, step, pinned=set(pinned))
        else:
            w = want.ensure(model, step, pinned=set(pinned))
            assert got.ensure(model, step, pinned=set(pinned)) == w
            wires.append(w)
        _assert_same_residency(got, want)
    assert [lw.offset for lw in got.store.layers] == \
        [lw.offset for lw in want.store.layers]
    if case == "copy":        # tests/test_serving.py:211
        assert wires[1] < 0.05 * wires[0]
    if case == "reuse-off":
        assert got.stats.wire_bytes == got.stats.raw_bytes
        assert got.stats.skips == 0.0
    if case in ("independent", "variant"):
        assert got.stats.cross_tenant_installs > 0


def test_residency_arena_too_small_raises(params):
    for make, p, cfg in ((RefResidency, params["a"][0], RCFG),
                         (WeightResidencyManager, params["a"][1], CFG)):
        kw = {} if make is RefResidency else {"device": "cpu"}
        with pytest.raises(ValueError):
            make({"a": (p, cfg)}, CFG.n_layers - 1, **kw)


def test_install_pipeline_matches_reference(params):
    """`tests/test_install_overlap.py::test_install_pipeline_unit_greedy_and_abort`'s
    sequence, plus a multi-tick install that commits once, on both."""
    def run(res_cls, pipe_cls, cost_cls, p, cfg, **kw):
        res = res_cls({"a": (p["a"], cfg), "b": (p["b"], cfg)}, CFG.n_layers,
                      reuse=True, **kw)
        res.ensure("a", step=0)
        log = []
        pipe = pipe_cls(res, cost_cls(bytes_per_tick=1 << 30))
        pipe.begin("b", step=1)
        log.append(pipe.pump(4, {"a", "b"}, step=1))
        log.append(pipe.pump(CFG.n_layers + 1, {"b"}, step=2))
        log.append((pipe.idle, res.is_resident("b"), pipe.pumped_ticks))
        pipe2 = pipe_cls(res, cost_cls(bytes_per_tick=8))
        pipe2.begin("a", step=3)
        log.append(pipe2.pump(2, {"a"}, step=3))
        log.append(pipe2.pump(2, {"a", "b"}, step=4))   # victim re-pinned
        log.append((pipe2.aborts, pipe2.queue_depth))
        per = max(lw.codes.size if isinstance(lw.codes, np.ndarray)
                  else lw.codes.numel() for lw in res.store.layers)
        pipe3 = pipe_cls(res, cost_cls(bytes_per_tick=max(per // 3, 1)))
        pipe3.begin("a", step=5)
        for step in range(6, 30):
            log.append((pipe3.pump(1, {"a"}, step), res.stats.installs,
                        pipe3.queue_depth))
            if pipe3.idle:
                break
        return log, _residency_state(res)

    np_p = {k: v[0] for k, v in params.items()}
    pt_p = {k: v[1] for k, v in params.items()}
    want = run(RefResidency, RefInstallPipeline, RefInstallCostModel, np_p,
               RCFG)
    got = run(WeightResidencyManager, InstallPipeline, InstallCostModel,
              pt_p, CFG, device="cpu")
    assert got == want
    assert want[0][5][0] == 1 and want[0][2][1]     # an abort; b resident


# ------------------------------------------------------------ the engine
def poisson_jobs(seed=0, n=12, rate=0.5):
    """`tests/test_install_overlap.py::poisson_jobs`: two-tenant Poisson
    arrivals in virtual time units (1.0 = one step)."""
    rng = np.random.default_rng(seed)
    t, jobs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.integers(3, 10))
        jobs.append((t, "a" if i % 2 == 0 else "b",
                     rng.integers(1, RCFG.vocab, plen).tolist(),
                     int(rng.integers(6, 12))))
    return jobs


ARMS = {"instant": dict(install_ticks_per_step=0),
        "sync": dict(install_ticks_per_step=1),
        "overlap": dict(install_ticks_per_step=1, overlap_installs=True),
        "reuse-off": dict(install_ticks_per_step=1, reuse=False)}


def _engine_run(pkg, params, arm, jobs):
    ref = pkg == "ref"
    EM, SE, SC, CM, VC, drive = (
        (RefEngineModel, RefServingEngine, RefSchedulerConfig,
         RefInstallCostModel, RefVirtualClock, ref_drive_simulated) if ref
        else (EngineModel, ServingEngine, SchedulerConfig, InstallCostModel,
              VirtualClock, drive_simulated))
    cfg = RCFG if ref else CFG
    extra = (dict(kv_layout="paged", kernel_backend="xla") if ref
             else dict(kv_layout="paged"))
    kw = {} if ref else {"device": "cpu"}
    clock = VC()
    eng = SE([EM("a", params["a"], cfg, kv_slots=3, max_seq=MAX_SEQ,
                 **extra),
              EM("b", params["b"], cfg, kv_slots=3, max_seq=MAX_SEQ,
                 **extra)],
             weight_arena_slots=CFG.n_layers + 1,
             sched=SC(max_prefill_per_step=2, model_turn_steps=TURN_STEPS),
             clock=clock, install_cost=CM(bytes_per_tick=1 << 30),
             **ARMS[arm], **kw)
    summary = drive(eng, clock, jobs, max_steps=10_000)
    tokens = {r.rid: list(r.generated) for r in eng.requests.values()}
    steps = [(s.install_wire_bytes, s.install_work_bytes,
              s.overlap_hidden_bytes, s.install_stall, s.n_decoded,
              s.n_prefills) for s in eng.metrics.steps]
    return tokens, steps, summary


@pytest.fixture(scope="module")
def engine_runs(params):
    """{arm: (reference run, port run)} on one Poisson schedule."""
    jobs = poisson_jobs()
    np_p = {k: v[0] for k, v in params.items()}
    pt_p = {k: v[1] for k, v in params.items()}
    return {arm: (_engine_run("ref", np_p, arm, jobs),
                  _engine_run("port", pt_p, arm, jobs)) for arm in ARMS}


@pytest.mark.parametrize("arm", list(ARMS))
def test_two_tenant_engine_matches_reference(engine_runs, arm):
    (w_tok, w_steps, w_sum), (g_tok, g_steps, g_sum) = engine_runs[arm]
    assert g_tok == w_tok
    assert g_steps == w_steps
    residency = ("install_raw_bytes", "install_wire_bytes", "installs",
                 "cold_installs", "cross_tenant_installs",
                 "install_mean_skip", "install_savings",
                 "install_cell_flips", "install_write_pulses",
                 "slots_retired")
    assert set(residency) <= set(g_sum)
    # every summary metric, the wear, energy and fault keys and the
    # latencies included: they come from the same VirtualClock schedule
    assert set(residency) | {"install_stall_steps", "install_work_bytes",
                             "overlap_hidden_bytes", "ttft_p95_s",
                             "install_energy_j", "wear_gini_weight",
                             "faults_survived"} <= set(g_sum)
    assert g_sum == w_sum
    assert g_sum["requests_finished"] == 12
    assert g_sum["cross_tenant_installs"] > 0


def test_two_tenant_engine_arms_agree_and_overlap_stalls_less(engine_runs):
    """Install budgeting and overlap never change a token; overlap stalls
    strictly less than the synchronous pipeline (test_install_overlap's
    claim, on the port)."""
    port = {arm: runs[1] for arm, runs in engine_runs.items()}
    assert port["sync"][0] == port["instant"][0] == port["overlap"][0] \
        == port["reuse-off"][0]
    assert port["reuse-off"][2]["install_wire_bytes"] == \
        port["reuse-off"][2]["install_raw_bytes"]
    sync, over = port["sync"][2], port["overlap"][2]
    assert sync["install_stall_steps"] > 0
    assert over["install_stall_steps"] < sync["install_stall_steps"]
    assert over["overlap_hidden_bytes"] > 0
    assert sync["overlap_hidden_bytes"] == 0


def test_pipeline_never_evicts_the_decoding_tenant_mid_turn(params):
    """`tests/test_install_overlap.py::test_pipeline_never_evicts_pinned_tenant_layers`
    on the port: with overlap, mid-turn prefetch takes free slots only; the
    decoding holder's layers are stolen no earlier than its final slice
    step."""
    clock = VirtualClock()
    eng = ServingEngine(
        [EngineModel(n, params[n][1], CFG, kv_slots=3, max_seq=MAX_SEQ,
                     kv_layout="paged") for n in ("a", "b")],
        weight_arena_slots=CFG.n_layers + 1,
        sched=SchedulerConfig(max_prefill_per_step=2,
                              model_turn_steps=TURN_STEPS),
        clock=clock, install_ticks_per_step=1, overlap_installs=True,
        install_cost=InstallCostModel(bytes_per_tick=1 << 30), device="cpu")
    pre, kept = {}, []

    def before_step(e):
        pre["resident"] = {n: e.residency.is_resident(n)
                           for n, a in e.arenas.items() if a.active_slots()}
        pre["holder"] = e.scheduler.current_turn_model
        pre["final"] = e.scheduler.turn_steps_left <= 1

    def after_step(e):
        for n, was in pre["resident"].items():
            if was and not pre["final"] and n == pre["holder"]:
                kept.append(e.residency.is_resident(n))

    drive_simulated(eng, clock, poisson_jobs(seed=3), max_steps=10_000,
                    before_step=before_step, after_step=after_step)
    assert kept and all(kept)


def test_f32_and_bf16_params_compute_the_same_logits(params):
    """The parity runs give the port f32 params; the model casts every
    matrix to bf16 at use, so the bf16 params the card holds give the same
    logits, bit for bit."""
    np_a, a = params["a"]
    b16 = params_from_reference(np_a, CFG, device="cpu")
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(b16))
    tokens = torch.tensor([[5, 17, 3, 99, 42, 7]])
    l32, _ = prefill_step(a, tokens, CFG, 8)
    l16, _ = prefill_step(b16, tokens, CFG, 8)
    assert torch.equal(l32, l16)


def test_engine_rejects_overlap_without_ticks(params):
    with pytest.raises(ValueError, match="install_ticks_per_step"):
        ServingEngine([EngineModel("a", params["a"][1], CFG,
                                   kv_layout="paged")],
                      overlap_installs=True, device="cpu")


def test_default_arena_holds_every_tenant(params):
    """Without weight_arena_slots every tenant's layers fit at once: both
    tenants run every step and only cold installs happen."""
    eng = ServingEngine([EngineModel("a", params["a"][1], CFG, max_seq=24,
                                     kv_layout="paged"),
                         EngineModel("b", params["b"][1], CFG, max_seq=24,
                                     kv_layout="paged")],
                        device="cpu")
    assert eng.residency.arena_slots == 2 * CFG.n_layers
    eng.submit("a", [3, 4, 5], max_new_tokens=3)
    eng.submit("b", [6, 7], max_new_tokens=3)
    eng.run()
    stats = eng.residency.stats
    assert stats.installs == stats.cold_installs == 2 * CFG.n_layers
    assert stats.cross_tenant_installs == 0
    assert not any(s.install_stall for s in eng.metrics.steps)


def test_dataclass_stats_fields_match_reference():
    from repro.serving.residency import ResidencyStats as RefStats
    from repro_torch.serving.residency import ResidencyStats
    assert [f.name for f in dataclasses.fields(ResidencyStats)] == \
        [f.name for f in dataclasses.fields(RefStats)]
