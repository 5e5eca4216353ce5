"""The port's live telemetry plane against the reference on the CPU at
gemma-7b smoke (`tests/test_telemetry.py`'s checks, held against the
reference engine, `kernel_backend="xla"`, on the same VirtualClock
schedules):

  * `P2Quantile`, `SlidingWindow` and `StreamStat` give the reference's
    values on the same seeded streams, and `SLOTracker` its breach and
    recover transitions;
  * with windows, a tight ITL SLO, the flight recorder and the watchdog
    on, the tokens are the telemetry-off run's, and the events JSONL, the
    Prometheus text, the `health()` snapshots (sampled mid-run and at the
    end) and the flight dumps equal the reference's byte for byte; both
    packages' validators accept the artifacts;
  * `health()` without telemetry and the per-tenant summary lines equal
    the reference's; the `/metrics` endpoint serves valid text on
    localhost.

The flight recorder's own checks are in `tests/test_torch_recorder.py`.
"""
import json
import os
import urllib.request

import numpy as np
import pytest

from repro.serving import SLOConfig as RefSLOConfig
from repro.serving import SLOTracker as RefSLOTracker
from repro.serving import StreamStat as RefStreamStat
from repro.serving import P2Quantile as RefP2Quantile
from repro.serving import SlidingWindow as RefSlidingWindow
from repro.serving import FlightRecorder as RefFlightRecorder
from repro.serving import TelemetryConfig as RefTelemetryConfig
from repro.serving import format_summary as ref_format_summary
from repro.serving import prometheus_text as ref_prometheus_text
from repro.serving import validate_events_jsonl as ref_validate_events
from repro.serving import validate_prometheus_text as ref_validate_prom
from repro.serving.telemetry import dumps_deterministic as ref_dumps
from repro_torch.serving import (FlightRecorder, P2Quantile, PromEndpoint,
                                 SLOConfig, SLOTracker, SlidingWindow,
                                 StreamStat, TelemetryConfig, format_summary,
                                 prometheus_text, validate_events_jsonl,
                                 validate_prometheus_text)
from repro_torch.serving import telemetry as telemetry_mod
from repro_torch.serving.telemetry import dumps_deterministic
from serving_pair import (CFG, N_PAGES, assert_reference_tokens, drive,
                          generated_by_rid, two_tenant_jobs)

STEP_DT = 0.01


def _same(a, b):
    """Equal, NaN included (an empty window's quantiles are NaN)."""
    return ref_dumps({"v": a}) == ref_dumps({"v": b})


def test_streaming_quantiles_match_reference():
    """`test_windowed_quantiles_manual_trials`' draws through both
    packages' estimators: every snapshot value equal."""
    rng = np.random.default_rng(7)
    for _ in range(40):
        n = int(rng.integers(1, 200))
        window = int(rng.integers(1, 65))
        xs = rng.normal(0.0, float(rng.uniform(0.1, 100.0)), n).tolist()
        got, want = StreamStat(window), RefStreamStat(window)
        for x in xs:
            got.observe(x)
            want.observe(x)
            assert _same(got.snapshot(), want.snapshot())
        tail = np.asarray(xs[-window:])
        assert got.p95() == pytest.approx(np.percentile(tail, 95))
    for p in (0.05, 0.5, 0.95):
        got, want = P2Quantile(p), RefP2Quantile(p)
        assert _same(got.value, want.value)
        for x in rng.lognormal(0.0, 0.5, size=3000):
            got.observe(x)
            want.observe(x)
        assert got.value == want.value and got.count == want.count
    win, ref_win = SlidingWindow(3), RefSlidingWindow(3)
    assert _same(win.quantile(50.0), ref_win.quantile(50.0))
    for x in (5.0, 1.0, 3.0, 9.0):
        win.observe(x)
        ref_win.observe(x)
    assert (len(win), win.total, win.last, win.quantile(50.0), win.mean()) \
        == (len(ref_win), ref_win.total, ref_win.last,
            ref_win.quantile(50.0), ref_win.mean())
    for bad in (lambda: SlidingWindow(0), lambda: P2Quantile(0.0),
                lambda: P2Quantile(1.0)):
        with pytest.raises(ValueError):
            bad()


def test_slo_tracker_transitions_match_reference():
    cfg = dict(ttft_p95_s=0.1, itl_p95_s=0.05, queue_wait_p95_s=0.2,
               short_window=4, long_window=8, min_samples=3)
    got, want = SLOTracker(SLOConfig(**cfg)), RefSLOTracker(
        RefSLOConfig(**cfg))
    rng = np.random.default_rng(1)
    transitions = []
    for i in range(400):
        name = ("ttft_p95", "itl_p95", "queue_wait_p95", "other")[i % 4]
        # bursts of over-limit samples, then recovery
        x = float(rng.exponential(0.4 if (i // 40) % 2 else 0.01))
        got.observe(name, x)
        want.observe(name, x)
        t = got.evaluate()
        assert t == want.evaluate()
        transitions += t
        assert got.any_breached == want.any_breached
        assert got.status() == want.status()
    kinds = {k for k, *_ in transitions}
    assert kinds == {"slo_breach", "slo_recover"}
    assert SLOConfig().targets() == {} == RefSLOConfig().targets()


def _telemetry_run(pkg, d, jobs, **knobs):
    """The two-tenant paged run with every plane on (window 16, a tight
    ITL SLO, events into `d`, a 32-step flight ring dumped into `d`, the
    watchdog at 300 s), `health()` sampled every 5 driven steps."""
    tcfg = RefTelemetryConfig if pkg == "ref" else TelemetryConfig
    slo = (RefSLOConfig if pkg == "ref" else SLOConfig)(itl_p95_s=1e-3)
    rec = RefFlightRecorder if pkg == "ref" else FlightRecorder
    os.makedirs(d, exist_ok=True)
    sampled = []
    eng, _ = drive(pkg, jobs, dt=STEP_DT, traced=True, drive_kwargs=dict(
        health_every=5, on_health=sampled.append),
        telemetry=tcfg(window=16, slo=slo,
                       events_path=os.path.join(d, "events.jsonl")),
        recorder=rec(32, out_dir=str(d)), stall_timeout_s=300.0, **knobs)
    eng.telemetry.close()
    return eng, sampled


_PLAIN = {}


def _plain(pkg):
    """`two_tenant_jobs()` with every plane off (traced on the engine's
    VirtualClock), once per package for the whole file."""
    if pkg not in _PLAIN:
        _PLAIN[pkg] = drive(pkg, two_tenant_jobs(), dt=STEP_DT, traced=True)
    return _PLAIN[pkg]


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def test_telemetry_artifacts_match_reference(tmp_path):
    """Everything on: the tokens of a telemetry-off run, and the events,
    health snapshots, flight dumps and Prometheus text of the reference,
    byte for byte."""
    jobs = two_tenant_jobs()
    plain, _ = _plain("port")
    ref, ref_sampled = _telemetry_run("ref", tmp_path / "ref", jobs)
    eng, sampled = _telemetry_run("port", tmp_path / "port", jobs)
    assert generated_by_rid(eng) == generated_by_rid(plain)
    assert_reference_tokens(eng, ref)
    assert sampled
    assert [dumps_deterministic(h) for h in sampled] == \
        [ref_dumps(h) for h in ref_sampled]
    h = eng.health()
    assert dumps_deterministic(h) == ref_dumps(ref.health())
    assert h["ok"] is False and h["slo"]["itl_p95"]["breached"] == 1
    assert h["kv_total_pages"] == 2 * N_PAGES
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "ref")
    assert "flight-000-slo_breach.json" in files
    dump = json.loads(files["flight-000-slo_breach.json"])
    assert dump["entries"] and dump["n_entries"] <= 32
    events = files["events.jsonl"].decode()
    assert validate_events_jsonl(events) == [] == ref_validate_events(events)
    snap = eng.telemetry.snapshot()
    assert snap["finishes"] == len(jobs) and set(snap["tenants"]) == {"a",
                                                                     "b"}
    assert ref_dumps(snap) == ref_dumps(ref.telemetry.snapshot())
    prom = prometheus_text(eng.metrics.registry, eng.telemetry)
    assert prom == ref_prometheus_text(ref.metrics.registry, ref.telemetry)
    assert validate_prometheus_text(prom) == [] == ref_validate_prom(prom)
    assert 'repro_slo_breached{target="itl_p95"} 1' in prom
    assert "repro_install_cell_flips_count" in prom


def test_health_without_telemetry_matches_reference():
    (eng, _), (ref, _) = _plain("port"), _plain("ref")
    h = eng.health()
    assert h["ok"] is True and "slo" not in h and "windows" not in h
    assert h["weight_slots_total"] == CFG.n_layers + 2
    assert h["slots_retired"] == 0 and h["pages_retired"] == 0
    assert dumps_deterministic(h) == ref_dumps(ref.health())


def test_per_tenant_summary_lines_match_reference():
    (eng, s), (ref, ref_s) = _plain("port"), _plain("ref")
    text, ref_text = format_summary(s), ref_format_summary(ref_s)
    for name in ("a", "b"):
        assert s[f"tenant.{name}.requests"] == 5
        assert f"tenant {name}: 5 requests" in text
    tenant = [ln for ln in text.splitlines() if ln.startswith("tenant ")]
    assert tenant == [ln for ln in ref_text.splitlines()
                      if ln.startswith("tenant ")]
    assert {k: v for k, v in s.items() if k.startswith("tenant.")} == \
        {k: v for k, v in ref_s.items() if k.startswith("tenant.")}


def test_prom_endpoint_and_validator_cli(tmp_path, capsys):
    """`/metrics` over localhost (no proxy) serves the registry text the
    validator accepts; the validator CLI exits 0 on valid artifacts and 1
    on broken ones."""
    eng, _ = _plain("port")
    endpoint = PromEndpoint(
        0, lambda: prometheus_text(eng.metrics.registry, eng.telemetry))
    try:
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(f"http://127.0.0.1:{endpoint.port}/metrics",
                         timeout=30) as r:
            body = r.read().decode()
    finally:
        endpoint.close()
    assert body == prometheus_text(eng.metrics.registry, eng.telemetry)
    assert validate_prometheus_text(body) == []
    good, bad = tmp_path / "prom.txt", tmp_path / "bad.txt"
    good.write_text(body)
    bad.write_text("repro_x{bad} 1\n")
    assert telemetry_mod._main(["--prom", str(good)]) == 0
    assert telemetry_mod._main(["--prom", str(bad)]) == 1
    assert "valid Prometheus text exposition" in capsys.readouterr().out
