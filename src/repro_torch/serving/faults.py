"""Deterministic stuck-at fault injection for ReRAM-backed arenas — a copy
of `repro.serving.faults` (standard library only) for the port, whose
decisions equal the reference's for every (seed, plane, unit, ordinal).

ReRAM cells wear out and fail under repeated SET/RESET pulses; Hamun
(PAPERS.md) prolongs accelerator lifespan by steering writes away from
worn cells *and* by surviving the cells that fail anyway.  This module
provides the failure half: a seeded, deterministic stuck-at fault model
in the spirit of the yzlite ReRAM wrapper (SNIPPETS.md), sampled at the
write sites the engine already owns — weight-slot installs and KV page
allocations.

Design constraints, in order:

* **Deterministic.**  Whether write #k to unit u of plane p faults is a
  pure function of ``(seed, plane, unit, k)`` — no global RNG state, no
  dependence on wall clock or iteration order.  Two runs with the same
  seed and the same schedule fault the same units at the same writes,
  which is what makes the token-equivalence sweeps in
  ``tests/test_faults.py`` and ``tests/test_torch_faults.py`` real
  property tests.
* **Zero cost when off.**  The engine only constructs a ``FaultModel``
  when ``fault_rate > 0``; every check site is guarded on the model
  being present, so ``fault_rate=0`` is bit-for-bit today's behavior.
* **Stuck-at semantics.**  A fault is detected *at write time* (program
  -and-verify, as real ReRAM controllers do) and the unit is then
  retired permanently — the caller remaps to a healthy unit and never
  re-issues the bad one.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

__all__ = ["FaultModel"]

# hash-derived uniforms: take 8 bytes of blake2b -> [0, 1)
_DENOM = float(1 << 64)


class FaultModel:
    """Seeded stuck-at faults at a configurable per-write rate.

    ``check(plane, unit)`` is called once per physical write (weight
    install into an arena slot, KV page program) and returns ``True``
    when that write hits a failing cell.  Each call advances a
    per-``(plane, unit)`` write ordinal, so the decision sequence for a
    unit is a fixed pseudorandom stream keyed by the seed — replaying
    the same schedule replays the same faults.
    """

    def __init__(self, rate: float, seed: int = 0) -> None:
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.seed = int(seed)
        # write ordinal per (plane, unit): the k in "k-th write to u"
        self._ordinal: Dict[Tuple[str, int], int] = {}
        self.checks = 0
        self.faults = 0

    def _uniform(self, plane: str, unit: int, ordinal: int) -> float:
        payload = f"{self.seed}:{plane}:{unit}:{ordinal}".encode()
        digest = hashlib.blake2b(payload, digest_size=8).digest()
        return int.from_bytes(digest, "big") / _DENOM

    def check(self, plane: str, unit: int) -> bool:
        """Does this write to ``unit`` of ``plane`` hit a bad cell?"""
        key = (plane, int(unit))
        ordinal = self._ordinal.get(key, 0)
        self._ordinal[key] = ordinal + 1
        self.checks += 1
        if self.rate <= 0.0:
            return False
        faulted = self._uniform(plane, key[1], ordinal) < self.rate
        if faulted:
            self.faults += 1
        return faulted

    def stats(self) -> Dict[str, int]:
        return {"fault_checks": self.checks, "faults_injected": self.faults}
