"""The port's ARAS streaming path against the reference on the CPU: the
quantized store (codes, offsets, zero points, centers with reuse on and
off and with offset groups), `delta_bytes`, `flip_counts` and the install
costs must be exact; `build_stream_plan` must give the same plan under the
same link; and the executor, in the regime of
`tests/test_streaming.py::test_executor_arena_smaller_than_model`
(gemma smoke, 4 layers, 2 arena slots; its layers also stacked as one
scanned segment), must install exactly as the reference does, keep every slot's codes equal to the store's, and give
logits within 2e-2 of the logit scale.  The dequantized weights are equal
bit for bit, but the reference's per-layer jit rounds its bf16 products
elsewhere than the whole-model jit the port follows, so a few logits
differ by a bf16 ulp or two.  The reference's
executor runs its delta installs through `delta_apply_ref`, never the
Pallas interpret path."""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels.delta_apply import ops as ref_delta_ops
from repro.kernels.delta_apply.ref import delta_apply_ref
from repro.nn.model import init_params as ref_init_params
from repro.streaming import delta as ref_delta
from repro.streaming import plan as ref_plan
from repro.streaming.executor import StreamingExecutor as RefExecutor
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.streaming import delta, plan
from repro_torch.streaming.executor import StreamingExecutor
from repro_torch.tree import tree_map

LINK = dict(peak_flops=1e14, hbm_bw=1e12, dma_bw=2e10, dma_latency_s=2e-5)


def _stretched_layers(n=6, extra=False):
    """`test_store_centering_reduces_wire_bytes`'s layers: outliers stretch
    each layer's range one way or the other, so code means diverge."""
    rng = np.random.default_rng(1)
    layers = []
    for i in range(n):
        w = rng.normal(0.0, 0.5, (64, 64)).astype(np.float32)
        w.flat[::257] = (6.0 if i % 2 == 0 else -6.0) * (1 + 0.2 * rng.random())
        ts = [w]
        if extra:
            ts.append(rng.normal(0.3 * (i % 3), 1, (16, 40)).astype(np.float32))
        layers.append((f"L{i}", ts))
    return layers


@pytest.mark.parametrize("kw", [
    dict(reuse=False), dict(reuse=True),
    dict(reuse=True, offset_groups=["a", "b"] * 3),
    dict(reuse=True, offset_groups=[0, 0, 1, 1, 0, 1], max_clip_rate=0.05),
    dict(reuse=True, offset_groups=[0, 1, 0, 1, 2, 2]),
], ids=["off", "on", "groups", "groups-loose", "groups-clipped"])
def test_store_matches_reference(kw):
    for extra in (False, True):
        layers = _stretched_layers(extra=extra)
        want = ref_delta.QuantizedStore(layers, **kw)
        got = delta.QuantizedStore(
            [(n, [torch.from_numpy(t) for t in ts]) for n, ts in layers],
            device="cpu", **kw)
        assert got.center == want.center
        for g, w in zip(got.layers, want.layers):
            np.testing.assert_array_equal(g.codes.numpy(), w.codes)
            assert (g.offset, g.shapes, g.sizes) == (w.offset, w.shapes, w.sizes)
            assert g.scales == w.scales and g.zero_points == w.zero_points
            for i in range(len(g.sizes)):
                np.testing.assert_array_equal(g.dequant(i).numpy(),
                                              w.dequant(i))
        for resident in (None, 0, 1, 3):
            for incoming in range(len(layers)):
                assert got.install_cost(resident, incoming) == \
                    want.install_cost(resident, incoming)
                for skip_equal in (True, False):
                    assert got.install_flips(resident, incoming,
                                             skip_equal=skip_equal) == \
                        want.install_flips(resident, incoming,
                                           skip_equal=skip_equal)
        if kw == dict(reuse=True) and not extra:    # the shift is exercised
            assert got.center is not None
            assert any(lw.offset for lw in got.layers)


@pytest.mark.parametrize("n_old,n_new", [(0, 10), (10, 10), (5, 17),
                                         (17, 5), (1000, 1333), (4096, 4096)])
def test_flip_counts_and_delta_bytes_match_reference(n_old, n_new):
    rng = np.random.default_rng(n_old * 7 + n_new)
    old = rng.integers(0, 256, n_old, dtype=np.uint8)
    new = rng.integers(0, 256, n_new, dtype=np.uint8)
    for skip_equal in (True, False):
        for o in ((None, old) if n_old == 0 else (old,)):
            assert delta.flip_counts(
                None if o is None else torch.from_numpy(o),
                torch.from_numpy(new), skip_equal=skip_equal) == \
                ref_delta.flip_counts(o, new, skip_equal=skip_equal)
    if n_old == n_new:
        for b in (new, old, np.clip(old.astype(int) + 1, 0, 255)
                  .astype(np.uint8)):
            assert delta.delta_bytes(torch.from_numpy(old),
                                     torch.from_numpy(b)) == \
                ref_delta.delta_bytes(old, b)


@pytest.mark.parametrize("replication", [True, False])
def test_stream_plan_matches_reference(replication):
    rng = np.random.default_rng(0)
    spec = [dict(name=f"L{i}", bytes_int8=int(rng.integers(1000, 20000)),
                 flops_per_token=float(rng.uniform(1e6, 5e7)),
                 tokens=int(rng.integers(64, 4096))) for i in range(10)]
    got = plan.build_stream_plan([plan.StreamLayer(**s) for s in spec],
                                 hbm_weight_budget_bytes=60_000,
                                 link=plan.LinkModel(**LINK),
                                 replication=replication)
    want = ref_plan.build_stream_plan([ref_plan.StreamLayer(**s) for s in spec],
                                      hbm_weight_budget_bytes=60_000,
                                      link=ref_plan.TpuLinkModel(**LINK),
                                      replication=replication)
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]
    for f in ("slot_bytes", "n_slots", "makespan_s", "serial_makespan_s",
              "overlap_speedup"):
        assert getattr(got, f) == getattr(want, f), f
    cm, rcm = plan.InstallCostModel(), ref_plan.InstallCostModel(
        bytes_per_s=plan.InstallCostModel().bytes_per_s,
        latency_s=plan.InstallCostModel().latency_s)
    for wire in (0, 1, 65536, 10**7):
        assert cm.ticks_for(wire) == rcm.ticks_for(wire)
        assert cm.install_s(wire, 2) == rcm.install_s(wire, 2)


N_LAYERS, SLOTS = 4, 2
TOKENS = np.random.default_rng(2).integers(0, 512, (2, 12))


@pytest.fixture(scope="module")
def reference_runs():
    """The reference executor on gemma smoke, 4 unscanned layers, 2 slots:
    (params, [(logits, metrics, stats, slot occupants, store codes)] for
    two forwards, the second from a warm arena)."""
    rcfg = dataclasses.replace(ref_config("gemma-7b", smoke=True),
                               n_layers=N_LAYERS, scan_layers=False)
    params = ref_init_params(jax.random.PRNGKey(1), rcfg)
    runs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_delta_ops, "apply_delta", delta_apply_ref)
        ex = RefExecutor(params, rcfg, arena_slots=SLOTS, plan_tokens=24,
                         link=ref_plan.TpuLinkModel(**LINK))
        for _ in range(2):
            logits, m = ex.forward({"tokens": jnp.asarray(TOKENS, jnp.int32)})
            runs.append((np.asarray(logits.astype(jnp.float32)), m,
                         dataclasses.asdict(ex.stats), ex.stats.mean_skip,
                         [occ for occ, _ in ex.slots]))
    codes = [lw.codes for lw in ex.store.layers]
    return jax.tree.map(np.asarray, params), runs, codes


@pytest.mark.parametrize("scanned", [False, True], ids=["4x1", "scanned"])
def test_executor_matches_reference(reference_runs, scanned):
    """The scanned variant stacks the same per-layer weights into (4, ...)
    leaves: the port slices them back per layer, as the reference's
    executor does, and must install and compute exactly the same."""
    np_params, runs, ref_codes = reference_runs
    params = tree_map(lambda a: torch.from_numpy(np.array(a)), np_params)
    if scanned:
        segs = params["stack"]["segments"]
        params["stack"]["segments"] = [tree_map(lambda *ls: torch.stack(ls),
                                                *segs)]
    cfg = dataclasses.replace(get_config("gemma-7b", smoke=True),
                              n_layers=N_LAYERS, scan_layers=scanned)
    got = StreamingExecutor(params, cfg, arena_slots=SLOTS, plan_tokens=24,
                            link=plan.LinkModel(**LINK), device="cpu")
    # every install leaves the slot holding exactly the store's codes
    install = got.install

    def checked(layer):
        install(layer)
        codes = got.slots[got.layer_slot[layer]][1]
        np.testing.assert_array_equal(codes.numpy(),
                                      got.store.layers[layer].codes.numpy())
    got.install = checked
    for want_logits, want_m, want_stats, want_skip, want_slots in runs:
        got_logits, got_m = got.forward({"tokens": torch.from_numpy(TOKENS)})
        assert dataclasses.asdict(got.stats) == want_stats
        assert got.stats.mean_skip == want_skip
        assert [occ for occ, _ in got.slots] == want_slots
        for k, v in want_m.items():
            if k != "wall_s":
                assert got_m[k] == v, k
        g = got_logits.float().numpy()
        scale = np.abs(want_logits).max()
        assert g.shape == want_logits.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, want_logits, rtol=0, atol=2e-2 * scale)
    for lw, codes in zip(got.store.layers, ref_codes):
        np.testing.assert_array_equal(lw.codes.numpy(), codes)
    kinds = [r["kind"] for r in got.install_log]
    assert kinds.count("cold") == SLOTS and "delta" in kinds
    for r in got.install_log:
        assert (r["cells"], r["pulses"]) == got.store.install_flips(
            r["resident"], r["layer"])


def test_streaming_cli_runs_on_cpu(capsys):
    serve._run_streaming(argparse.Namespace(
        arch="gemma-7b", smoke=True, device="cpu", arena_slots=2, batch=2,
        prompt_len=8, seed=0))
    out = capsys.readouterr().out
    assert out.startswith("streaming forward: ") and "wire" in out


def test_serve_cli_defaults_match_the_reference():
    """The streaming defaults of the reference CLI:
    src/repro/launch/serve.py:215,220 (--batch 4, --arena-slots 3)."""
    args = serve._parser().parse_args(["--streaming"])
    assert (args.arena_slots, args.batch) == (3, 4)


@pytest.mark.parametrize("flags", [[], ["--install-ticks-per-step", "1",
                                        "--overlap-installs"]],
                         ids=["instant", "overlap"])
def test_engine_cli_serves_two_tenants_on_cpu(capsys, flags):
    """`--engine` serves tenant-a and its perturbed variant tenant-b through
    a weight arena of n_layers + 1 slots: requests alternate, and a switch
    installs layers across tenants."""
    args = serve._parser().parse_args(
        ["--engine", "--smoke", "--device", "cpu", "--requests", "4",
         "--prompt-len", "8", "--gen", "6", "--turn-steps", "2", *flags])
    serve._run_engine(args)
    out = capsys.readouterr().out
    assert "4 requests across 2 models" in out
    assert "weight arena 3 slots" in out and "finished 4 requests" in out
    installs = [line for line in out.splitlines()
                if line.startswith("weight installs:")]
    assert installs and "(0 cross-tenant)" not in installs[0]
    assert ("install pipeline:" in out) == bool(flags)


def test_engine_cli_defaults_match_the_reference(monkeypatch):
    """The engine flags' defaults are the reference parser's
    (src/repro/launch/serve.py:221-243)."""
    import sys
    from repro.launch import serve as ref_serve
    seen = {}
    monkeypatch.setattr(ref_serve, "_run_engine",
                        lambda args: seen.setdefault("args", args))
    monkeypatch.setattr(sys, "argv", ["serve", "--engine"])
    ref_serve.main()
    want = vars(seen["args"])
    got = vars(serve._parser().parse_args(["--engine"]))
    for flag in ("weight_slots", "turn_steps", "install_ticks_per_step",
                 "install_bytes_per_tick", "overlap_installs", "requests",
                 "kv_slots", "page_size", "prompt_len", "gen", "arch"):
        assert got[flag] == want[flag], flag
