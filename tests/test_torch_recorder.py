"""The port's flight recorder against the reference on the CPU at gemma-7b
smoke (`tests/test_telemetry.py`'s recorder and watchdog checks, on the
reference engine's VirtualClock schedules):

  * a fault run's ring and its `unit_retired` dumps equal the reference's;
  * a step made to overrun a short watchdog deadline leaves a
    `stall_suspected` dump and trace instant;
  * the recorder's SIGUSR1 and excepthook hooks dump, and are undone
    after the test.
"""
import json
import os
import signal
import sys
import threading
import time

import pytest

from repro.serving import FlightRecorder as RefFlightRecorder
from repro_torch.serving import FlightRecorder
from serving_pair import (assert_reference_tokens, drive, make_engine,
                          run_jobs, two_tenant_jobs)

STEP_DT = 0.01


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.fixture
def process_hooks(monkeypatch):
    """Undo the flight recorder's process-wide installs: the SIGUSR1
    handler and the excepthook come back as they were."""
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    prev = signal.getsignal(signal.SIGUSR1)
    yield
    signal.signal(signal.SIGUSR1, prev)


def test_recorder_fault_dumps_match_reference(tmp_path):
    """A seeded 2% fault run: every retirement triggers a `unit_retired`
    dump (capped at max_dumps), the ring stays bounded, and the dumps and
    triggers are the reference's."""
    jobs = two_tenant_jobs(seed=1, n=8)
    out = {}
    for pkg in ("ref", "port"):
        rec = (RefFlightRecorder if pkg == "ref" else FlightRecorder)(
            4, out_dir=str(tmp_path / pkg), max_dumps=2)
        os.makedirs(tmp_path / pkg)
        out[pkg], _ = drive(pkg, jobs, dt=STEP_DT, traced=True,
                            fault_rate=0.02, fault_seed=11, recorder=rec)
    eng, ref = out["port"], out["ref"]
    h = eng.health()
    assert h["slots_retired"] + h["pages_retired"] > 0
    reasons = [t["reason"] for t in eng.recorder.triggers]
    assert set(reasons) == {"unit_retired"}
    assert len(eng.recorder.dumps) == min(len(reasons), 2)
    assert len(eng.recorder) <= 4
    assert eng.recorder.triggers == ref.recorder.triggers
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "ref")
    entry = json.loads(files["flight-000-unit_retired.json"])["entries"][-1]
    assert {"step", "record", "health", "events"} <= set(entry)
    assert_reference_tokens(eng, ref)


def test_watchdog_stall_dump_on_an_overrunning_step(tmp_path):
    """A step that holds on until the watchdog has fired: its timer thread
    fires while the step runs on, leaving a `stall_suspected` trace
    instant and flight dump for that step.  (A healthy smoke step takes
    milliseconds; one slowed past the deadline by a loaded host fires too,
    and is counted like any other.)"""
    eng, clock = make_engine(
        "port", traced=True, stall_timeout_s=1.0,
        recorder=FlightRecorder(8, out_dir=str(tmp_path), max_dumps=64))
    fired, done = threading.Event(), []
    on_timeout = eng.watchdog.on_timeout

    def observed(step):
        on_timeout(step)
        done.append(step)
        if step == 3:
            fired.set()

    eng.watchdog.on_timeout = observed
    inner = eng._step_inner

    def slow_step():
        if eng._step_no == 3:   # runs on until its own timer has fired
            assert fired.wait(timeout=60), "the watchdog never fired"
        inner()

    eng._step_inner = slow_step
    run_jobs("port", eng, clock, two_tenant_jobs(n=4), dt=STEP_DT)
    deadline = time.monotonic() + 60
    while len(done) < eng.watchdog.fires and time.monotonic() < deadline:
        time.sleep(0.01)                # a late callback still dumping
    assert 3 in done and len(done) == eng.watchdog.fires
    stalls = [e["args"]["step"] for e in eng.tracer.events
              if e["name"] == "stall_suspected"]
    assert sorted(stalls) == sorted(done)
    docs = [json.loads(open(p).read()) for p in eng.recorder.dumps]
    assert [d["reason"] for d in docs] == ["stall_suspected"] * len(done)
    assert {"step": 3, "attrs": {"timeout_s": 1.0}} in [
        {"step": d["trigger_step"], "attrs": d["attrs"]} for d in docs]


def test_recorder_signal_and_crash_hooks(tmp_path, process_hooks):
    rec = FlightRecorder(4, out_dir=str(tmp_path))
    rec.install_signal_handler()
    os.kill(os.getpid(), signal.SIGUSR1)
    seen = []
    sys.excepthook = lambda *a: seen.append(a[0])
    rec.install_excepthook()
    sys.excepthook(ValueError, ValueError("boom"), None)
    assert seen == [ValueError]
    assert [os.path.basename(p) for p in rec.dumps] == \
        ["flight-000-sigusr1.json", "flight-001-crash.json"]
    assert rec.triggers[1] == {"reason": "crash", "step": None,
                               "error": "ValueError('boom')"}
