"""Simulated-time driving harness for the serving engine — PyTorch port of
`repro.serving.harness`.

One canonical arrival-clocked loop shared by the install-overlap, wear,
fault and telemetry tests, so "submit at virtual arrival time, step while
there is work, advance the clock" has a single definition: the engine runs
on a `VirtualClock` and every latency/stall metric comes out bit-for-bit
reproducible, no device or wall clock involved.  (The reference's
`step_dt` cost model serves its chunked-prefill benchmarks, which the
port does not have.)
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

Job = Tuple[float, str, Sequence[int], int]   # (arrival_t, model, prompt, gen)


def drive_simulated(eng, clock, jobs: Iterable[Job], *, dt: float = 1.0,
                    max_steps: int = 100_000,
                    before_step: Optional[Callable] = None,
                    after_step: Optional[Callable] = None,
                    health_every: int = 0,
                    on_health: Optional[Callable] = None
                    ) -> Dict[str, float]:
    """Drive `eng` over `jobs` in virtual time and return its summary.

    Each iteration submits every job whose arrival time has passed, steps
    the engine if it has work, and advances `clock` by `dt` (idle waits
    included, so arrival gaps cost virtual time too).  `before_step` /
    `after_step` hooks receive the engine around each step — the tests use
    them to assert invariants mid-flight.  `health_every` > 0 calls
    `on_health(eng.health())` every that-many driven steps — the live
    router-probe snapshot sampled at deterministic virtual times.  Raises
    RuntimeError instead of spinning forever if the workload does not
    drain within `max_steps`.
    """
    pending = sorted(jobs)
    n_steps = 0
    for _ in range(max_steps):
        if not pending and not eng.has_work():
            break
        while pending and pending[0][0] <= clock.t:
            _, model, prompt, gen = pending.pop(0)
            eng.submit(model, prompt, max_new_tokens=gen)
        if eng.has_work():
            if before_step is not None:
                before_step(eng)
            eng.step()
            n_steps += 1
            if (health_every > 0 and on_health is not None
                    and n_steps % health_every == 0):
                on_health(eng.health())
            if after_step is not None:
                after_step(eng)
        clock.advance(dt)
    else:
        raise RuntimeError(
            f"simulated drive did not drain the workload in {max_steps} "
            "steps — engine livelock?")
    return eng.summary(clock.t)
