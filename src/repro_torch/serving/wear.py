"""Wear telemetry: per-slot / per-page write, cell-flip, and pulse counts —
a copy of `repro.serving.wear` (numpy only) for the port.

ARAS §V-C minimizes HOW MUCH each install writes (equal 2-bit cells are
skipped, pulses track |Δ level|); Hamun-style endurance management needs to
know WHERE those writes land before any wear-aware policy can steer them.
`WearPlane` is one physical write plane tracked id by id — the weight
arena's slots, or a paged tenant's KV page pool — and `WearMap` is the
engine-owned registry of planes.  Leaf modules record into an injected
plane exactly like they emit into the injected tracer
(`WeightResidencyManager._install` for weight-slot flips/pulses,
`PagedKVArena` for page programs); the spread summaries (Gini, hottest-N,
write-count histogram) and the deterministic JSON export live here so the
victim picker and page allocator have observables to steer by.  Every
output equals the reference's, byte for byte once serialized.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_METRICS = ("writes", "flips", "pulses")


def gini_coefficient(counts) -> float:
    """Gini coefficient of a non-negative count vector: 0 = perfectly even
    wear, → 1 = one location takes every write.  Degenerate inputs (empty,
    single slot, all-zero) are 0.0 by convention — no spread to speak of."""
    x = np.sort(np.asarray(counts, np.float64))
    n = x.size
    total = float(x.sum())
    if n <= 1 or total <= 0.0:
        return 0.0
    idx = np.arange(1, n + 1, dtype=np.float64)
    return float(2.0 * float((idx * x).sum()) / (n * total) - (n + 1) / n)


class WearPlane:
    """Write accounting over ids `first .. first + n - 1` of one plane.

    `first` shifts the id space so reserved ids stay untracked — KV planes
    start at 1 because device page 0 is the scratch page and never takes
    an accounted write."""

    __slots__ = ("name", "first", "writes", "flips", "pulses", "by_group",
                 "retired")

    def __init__(self, name: str, n: int, first: int = 0):
        if n < 1:
            raise ValueError(f"wear plane {name!r} needs at least one slot")
        self.name = name
        self.first = first
        self.writes = np.zeros(n, np.int64)
        self.flips = np.zeros(n, np.int64)
        self.pulses = np.zeros(n, np.int64)
        # (id, group) -> [writes, flips, pulses]: the slot×layer-group
        # dimension — which layer family produced each slot's wear
        self.by_group: Dict[Tuple[int, object], List[int]] = {}
        # ids permanently pulled from service after a stuck-at fault —
        # the fault-degradation half of the Hamun story; the owning
        # arena stops issuing them, this plane just remembers them
        self.retired: set = set()

    @property
    def n(self) -> int:
        return int(self.writes.size)

    def record(self, idx: int, *, writes: int = 1, flips: int = 0,
               pulses: int = 0, group=None) -> None:
        i = idx - self.first
        self.writes[i] += writes
        self.flips[i] += flips
        self.pulses[i] += pulses
        if group is not None:
            acc = self.by_group.setdefault((idx, group), [0, 0, 0])
            acc[0] += writes
            acc[1] += flips
            acc[2] += pulses

    def retire(self, idx: int) -> None:
        """Mark id `idx` permanently failed (stuck-at fault detected at
        program time).  Idempotent; wear already accrued stays counted —
        the pulses were spent even though the write didn't verify."""
        self.retired.add(int(idx))

    def counts(self, metric: str = "writes") -> np.ndarray:
        if metric not in _METRICS:
            raise KeyError(f"unknown wear metric {metric!r} "
                           f"(expected one of {_METRICS})")
        return getattr(self, metric)

    def total(self, metric: str = "writes") -> int:
        return int(self.counts(metric).sum())

    def gini(self, metric: str = "writes") -> float:
        return gini_coefficient(self.counts(metric))

    def hottest(self, k: int = 3, metric: str = "writes"
                ) -> List[Tuple[int, int]]:
        """Top-k (id, count) by wear, hottest first; ties break toward the
        lower id so the ranking (and the JSON export) is deterministic."""
        c = self.counts(metric)
        order = np.lexsort((np.arange(c.size), -c))[:k]
        return [(int(i) + self.first, int(c[i])) for i in order]

    def histogram(self, metric: str = "writes", bins: int = 8) -> Dict:
        """Write-count histogram over the plane's ids (the ROADMAP's
        endurance observable): how many locations sit in each wear band."""
        c = self.counts(metric)
        hi = max(int(c.max()), 1)
        counts, edges = np.histogram(c, bins=min(bins, hi), range=(0, hi))
        return {"edges": [float(e) for e in edges],
                "counts": [int(v) for v in counts]}

    def summary(self) -> Dict[str, float]:
        return {
            "n_slots": float(self.n),
            "writes": float(self.total("writes")),
            "flips": float(self.total("flips")),
            "pulses": float(self.total("pulses")),
            "gini_writes": self.gini("writes"),
            "gini_flips": self.gini("flips"),
            "retired": float(len(self.retired)),
        }

    def as_json(self) -> Dict:
        """Deterministic strict-JSON document (`serve.py --wear-json`)."""
        return {
            "first": self.first,
            "writes": [int(v) for v in self.writes],
            "flips": [int(v) for v in self.flips],
            "pulses": [int(v) for v in self.pulses],
            "gini": {m: self.gini(m) for m in _METRICS},
            "hottest": [[i, c] for i, c in self.hottest()],
            "retired": sorted(self.retired),
            "histogram": self.histogram(),
            "by_group": {
                f"{i}/{g}": list(v) for (i, g), v in sorted(
                    self.by_group.items(),
                    key=lambda kv: (kv[0][0], str(kv[0][1])))},
        }


class WearMap:
    """Engine-owned registry of wear planes, one per physical write plane
    (plane "weight" for the arena slots, "kv:<tenant>" per page pool)."""

    def __init__(self):
        self.planes: Dict[str, WearPlane] = {}

    def add_plane(self, name: str, n: int, first: int = 0) -> WearPlane:
        if name in self.planes:
            raise ValueError(f"wear plane {name!r} already registered")
        plane = WearPlane(name, n, first=first)
        self.planes[name] = plane
        return plane

    def plane(self, name: str) -> WearPlane:
        return self.planes[name]

    def gini(self, metric: str = "writes", prefix: str = "") -> float:
        """Spread over the concatenated counts of every plane whose name
        starts with `prefix` (all planes by default) — cross-tenant KV
        wear is one question, not one per pool."""
        parts = [p.counts(metric) for name, p in self.planes.items()
                 if name.startswith(prefix)]
        return gini_coefficient(np.concatenate(parts)) if parts else 0.0

    def as_json(self) -> Dict:
        return {name: self.planes[name].as_json()
                for name in sorted(self.planes)}
