"""Multi-model weight-arena residency: §V-C weight reuse across tenants —
PyTorch port of `repro.serving.residency`.

The engine serves several models off one device weight arena of
layer-sized slots.  Every tenant's big tensors are quantized into ONE
`QuantizedStore`, so the §V-C mean-centering picks a single Center across
*all* tenants — cross-model deltas then skip as many cells as cross-layer
deltas do inside one model.  When the step scheduler switches which
model's slots decode, the manager installs that model's layer codes,
choosing for each incoming layer the victim slot whose current occupant
minimizes the delta wire bytes (greedy min-delta assignment = "order
installs by delta similarity"), and accounts raw vs wire bytes exactly
like `streaming/executor.py` does for a single model.

The store is built on the engine's device, so every pair cost the greedy
asks for counts its cell deltas there and its programming pulses with the
`pulse_count` kernel on a CUDA device.  Costs, victims, stats and the
install pipeline's schedule are the reference's bit for bit when the
store quantizes the same values (f32 params on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.nn.config import ModelConfig
from repro_torch.serving.tracing import NULL_TRACER
from repro_torch.streaming.delta import QuantizedStore
from repro_torch.streaming.executor import layer_blocks, split_block
from repro_torch.streaming.plan import InstallCostModel


def model_layer_tensors(params: Any, cfg: ModelConfig
                        ) -> List[List[torch.Tensor]]:
    """Per-layer big (quantizable) tensors, by the streaming executor's
    block extraction: scanned segments are unstacked into individual
    layers, leaves in jax's flatten order."""
    out = []
    for bp in layer_blocks(params, cfg):
        _, leaves, flags = split_block(bp)
        out.append([leaf for leaf, f in zip(leaves, flags) if f])
    return out


@dataclasses.dataclass
class ResidencyStats:
    raw_bytes: int = 0
    wire_bytes: int = 0
    installs: int = 0
    cold_installs: int = 0
    cross_tenant_installs: int = 0
    skips: float = 0.0
    # device-side write activity (wear/energy telemetry): cells actually
    # programmed and incremental pulses issued, equal-skip aware under reuse
    cell_flips: int = 0
    write_pulses: int = 0
    # arena slots permanently pulled from service after a stuck-at fault
    # was detected at program time (Hamun-style graceful degradation)
    slots_retired: int = 0

    @property
    def mean_skip(self) -> float:
        return self.skips / max(self.installs, 1)

    @property
    def savings(self) -> float:
        """Fraction of raw install traffic the delta stream avoided."""
        if self.raw_bytes == 0:
            return 0.0
        return 1.0 - self.wire_bytes / self.raw_bytes

    def as_dict(self) -> Dict[str, float]:
        return {
            "install_raw_bytes": float(self.raw_bytes),
            "install_wire_bytes": float(self.wire_bytes),
            "installs": float(self.installs),
            "cold_installs": float(self.cold_installs),
            "cross_tenant_installs": float(self.cross_tenant_installs),
            "install_mean_skip": self.mean_skip,
            "install_savings": self.savings,
            "install_cell_flips": float(self.cell_flips),
            "install_write_pulses": float(self.write_pulses),
            "slots_retired": float(self.slots_retired),
        }


class WeightResidencyManager:
    # structured-event sink for committed installs; the engine swaps in
    # its shared Tracer, standalone use keeps the no-op
    tracer = NULL_TRACER
    # wear telemetry sinks, injected like the tracer: `wear` is the weight
    # arena's WearPlane (per-slot writes/flips/pulses, keyed by layer
    # group), `flip_hist` a MetricsRegistry histogram of per-install flips;
    # the engine injects both, standalone use records nothing
    wear = None
    flip_hist = None
    # wear-aware victim blending (Hamun policy half): weight > 0 adds a
    # per-prior-write penalty to each victim slot's delta cost so installs
    # rotate toward cold slots; 0 keeps the pure greedy min-delta picker
    # bit for bit.  The engine sets it from its `wear_aware` knob.
    wear_weight = 0.0
    # stuck-at fault model (serving/faults.py), injected like the tracer;
    # None = fault-free, every check site skipped
    faults = None

    def __init__(self, models: Dict[str, Tuple[Any, ModelConfig]],
                 arena_slots: int, *, reuse: bool = True, device="cuda"):
        store_input: List[Tuple[str, List[torch.Tensor]]] = []
        offset_groups: List[int] = []
        self.layer_ids: Dict[str, List[int]] = {}
        self.model_of: List[str] = []
        for name, (params, cfg) in models.items():
            per_layer = model_layer_tensors(params, cfg)
            ids = []
            for i, tensors in enumerate(per_layer):
                ids.append(len(store_input))
                store_input.append((f"{name}/L{i}", tensors))
                offset_groups.append(i)   # align tenants layer-by-layer
                self.model_of.append(name)
            self.layer_ids[name] = ids
        # checked before the store is built: quantizing is the costly part
        biggest = max(len(ids) for ids in self.layer_ids.values())
        if arena_slots < biggest:
            raise ValueError(
                f"weight arena of {arena_slots} slots cannot hold the "
                f"largest model ({biggest} layers)")
        # layer-group label per store layer (the §V-C offset group)
        self.group_of: List[int] = offset_groups
        # reuse=False is the paper's baseline: every cell programmed on every
        # install (raw stream, no centering).  reuse=True is §V-C applied
        # across tenants: equal-cell skipping + pooled per-layer-group
        # centering so model variants stay code-aligned.
        self.reuse = reuse
        self.store = QuantizedStore(store_input, reuse=reuse,
                                    offset_groups=offset_groups,
                                    device=device)

        self.arena_slots = arena_slots
        self.slots: List[Optional[int]] = [None] * arena_slots  # store idx
        self.resident: Dict[int, int] = {}                      # layer -> slot
        self._stamp = [0] * arena_slots                         # LRU step
        # slots retired after a detected stuck-at fault — never issued again
        self.retired: Set[int] = set()
        # one prior write to a slot weighs `wear_weight` raw layer installs
        # in the blended victim cost
        self._wear_unit = max(1, int(np.mean(
            [lay.codes.numel() for lay in self.store.layers])))
        self.stats = ResidencyStats()
        # Codes are immutable after store construction, so the (occupant,
        # incoming) pair cost is memoizable — tenant turns repeat the same
        # pairs every switch.
        self._cost_cache: Dict[Tuple[Optional[int], int],
                               Tuple[int, float, int, int]] = {}

    # ---------------------------------------------------------- capacity
    def layers_of(self, models: Iterable[str]) -> int:
        return sum(len(self.layer_ids[m]) for m in set(models))

    def fits(self, models: Iterable[str]) -> bool:
        """Can all these tenants be simultaneously resident?  Retired
        (faulted) slots no longer count toward capacity."""
        return self.layers_of(models) <= self.arena_slots - len(self.retired)

    def resident_fraction(self, model: str) -> float:
        ids = self.layer_ids[model]
        return sum(1 for l in ids if l in self.resident) / max(len(ids), 1)

    def is_resident(self, model: str) -> bool:
        """Every layer of `model` currently occupies an arena slot."""
        return all(l in self.resident for l in self.layer_ids[model])

    def touch(self, model: str, step: int) -> None:
        """Refresh the LRU stamp of `model`'s resident layers (a tenant that
        decoded this step must not look like an eviction candidate)."""
        for l in self.layer_ids[model]:
            slot = self.resident.get(l)
            if slot is not None:
                self._stamp[slot] = step

    # ----------------------------------------------------------- install
    def _cost(self, occupant: Optional[int], layer: int
              ) -> Tuple[int, float, int, int]:
        """(wire bytes, skip ratio, cells flipped, programming pulses) to
        install `layer` over `occupant`.  The installer ships whichever
        stream is cheaper — the entropy-coded cell delta or the raw codes —
        so a dissimilar occupant never costs MORE than a cold install;
        the device-side flip/pulse counts depend only on resident-vs-
        incoming cells, not on which stream shipped.  With reuse off every
        install ships raw and the programmer rewrites every cell."""
        key = (occupant, layer)
        got = self._cost_cache.get(key)
        if got is None:
            raw = self.store.layers[layer].codes.numel()
            flips, pulses = self.store.install_flips(
                occupant, layer, skip_equal=self.reuse)
            if not self.reuse:
                got = (raw, 0.0, flips, pulses)
            else:
                wire, skip = self.store.install_cost(occupant, layer)
                if wire >= raw:
                    wire, skip = raw, 0.0
                got = (wire, skip, flips, pulses)
            self._cost_cache[key] = got
        return got

    def _victim_key(self, slot: int, wire: int) -> Tuple[int, int]:
        """Victim-ranking key blending delta cost with slot wear.  With
        `wear_weight` 0 this is `(wire, 0)` — the pure greedy min-delta
        order.  With weight w > 0 each prior write to the slot penalizes it
        by `w * mean_layer_size` wire-byte-equivalents, and the raw write
        count breaks exact-cost ties toward the coldest slot."""
        if self.wear_weight <= 0.0 or self.wear is None:
            return (wire, 0)
        writes = int(self.wear.writes[slot])
        penalty = int(round(self.wear_weight * self._wear_unit * writes))
        return (wire + penalty, writes)

    def _install(self, layer: int, slot: int, step: int) -> Optional[int]:
        """Commit `layer` into `slot`; returns wire bytes, or None when the
        program-and-verify detects a stuck-at fault — the slot is then
        retired (its occupant, if any, is no longer resident) and the caller
        must remap the layer to a healthy slot."""
        occupant = self.slots[slot]
        wire, skip, flips, pulses = self._cost(occupant, layer)
        if self.faults is not None and self.faults.check("weight", slot):
            # the pulses were spent before verify failed: wear still lands,
            # then the slot leaves service for good
            if self.wear is not None:
                self.wear.record(slot, flips=flips, pulses=pulses,
                                 group=self.group_of[layer])
                self.wear.retire(slot)
            self.stats.cell_flips += flips
            self.stats.write_pulses += pulses
            self.stats.slots_retired += 1
            self.retired.add(slot)
            if occupant is not None:
                self.resident.pop(occupant, None)
            self.slots[slot] = None
            if self.tracer.enabled:
                self.tracer.instant("slot_retired", slot=slot, layer=layer,
                                    model=self.model_of[layer])
            return None
        raw = self.store.layers[layer].codes.numel()
        self.stats.raw_bytes += raw
        self.stats.wire_bytes += wire
        self.stats.installs += 1
        self.stats.skips += skip
        self.stats.cell_flips += flips
        self.stats.write_pulses += pulses
        if self.wear is not None:
            self.wear.record(slot, flips=flips, pulses=pulses,
                             group=self.group_of[layer])
        if self.flip_hist is not None:
            self.flip_hist.observe(flips)
        if occupant is None:
            self.stats.cold_installs += 1
        else:
            self.resident.pop(occupant, None)
            if self.model_of[occupant] != self.model_of[layer]:
                self.stats.cross_tenant_installs += 1
        self.slots[slot] = layer
        self.resident[layer] = slot
        self._stamp[slot] = step
        if self.tracer.enabled:
            self.tracer.instant(
                "install_land", layer=layer, slot=slot, wire=wire,
                model=self.model_of[layer],
                victim=(None if occupant is None
                        else self.model_of[occupant]))
        return wire

    def ensure(self, model: str, step: int,
               pinned: Set[str] = frozenset()) -> int:
        """Make every layer of `model` resident; returns wire bytes moved.

        Victim slots are those holding no layer of a pinned (actively
        decoding) tenant.  Installs are ordered greedily by delta
        similarity: at each step the (incoming layer, victim slot) pair with
        the cheapest delta stream installs first, so similar cross-tenant
        layers land on top of each other.
        """
        pinned = set(pinned) | {model}
        missing = [l for l in self.layer_ids[model] if l not in self.resident]
        if not missing:
            self.touch(model, step)
            return 0

        def evictable(slot: int) -> bool:
            occ = self.slots[slot]
            return occ is None or self.model_of[occ] not in pinned

        candidates = [s for s in range(self.arena_slots)
                      if s not in self.retired and evictable(s)]
        if len(candidates) < len(missing):
            raise RuntimeError(
                f"weight arena too small: need {len(missing)} slots for "
                f"{model}, only {len(candidates)} evictable")

        wire_total = 0
        while missing:
            best = None
            for layer in missing:
                for slot in candidates:
                    wire = self._cost(self.slots[slot], layer)[0]
                    # ties (e.g. reuse off: everything raw) break LRU-first
                    key = (*self._victim_key(slot, wire), self._stamp[slot])
                    if best is None or key < best[0]:
                        best = (key, layer, slot)
            _, layer, slot = best
            wire = self._install(layer, slot, step)
            candidates.remove(slot)
            if wire is None:
                # slot died at program time: the layer stays missing and
                # retries on the next-best healthy slot
                if len(candidates) < len(missing):
                    raise RuntimeError(
                        f"weight arena exhausted by faults: need "
                        f"{len(missing)} slots for {model}, only "
                        f"{len(candidates)} healthy evictable left")
                continue
            wire_total += wire
            missing.remove(layer)
        self.touch(model, step)
        self.store.drop_device_copies()
        return wire_total


class InstallPipeline:
    """Budgeted, overlappable layer installs — ARAS §IV applied to tenant
    switches.

    Where `ensure()` installs a whole tenant synchronously at the turn
    boundary, the pipeline spreads the same greedy min-delta installs over
    per-step tick budgets so they run *while* the outgoing tenant's final
    decode steps still compute.  One tick is the DMA work one decode step
    hides (`InstallCostModel.bytes_per_tick` wire bytes); an install
    commits — and its stats land in `ResidencyStats` — only when its whole
    tick cost has been pumped, mirroring a transfer that completes
    mid-turn.

    Victim choice is `ensure()`'s rule evaluated incrementally: each unit
    picks the (incoming layer, evictable slot) pair with the cheapest delta
    stream, tie-broken toward the incoming tenant's earliest layers, so the
    target's first-executed layers become resident first (the order its
    first post-switch decode step needs them).
    """

    # structured-event sink for begin/abort/victim-pick decisions; the
    # engine swaps in its shared Tracer, standalone use keeps the no-op
    tracer = NULL_TRACER

    def __init__(self, residency: WeightResidencyManager,
                 cost: InstallCostModel):
        self.res = residency
        self.cost = cost
        self.target: Optional[str] = None
        self._missing: List[int] = []
        # in-flight install: [layer, slot, ticks_left, ticks_total, wire]
        self._cur: Optional[List[int]] = None
        self.pumped_ticks = 0
        self.aborts = 0

    @property
    def idle(self) -> bool:
        return self.target is None

    @property
    def queue_depth(self) -> int:
        """Layers still queued for the current target, the in-flight
        partial install included — the live install-backlog counter."""
        return len(self._missing) + (self._cur is not None)

    def begin(self, model: str, step: int) -> None:
        """(Re)target the pipeline.  Retargeting drops any in-flight
        partial install — its ticks are sunk cost, counted in `aborts`."""
        missing = [l for l in self.res.layer_ids[model]
                   if l not in self.res.resident]
        if self.target == model:
            if self._cur is not None:
                missing = [l for l in missing if l != self._cur[0]]
            self._missing = missing
            return
        if self._cur is not None:
            self.aborts += 1
            self.tracer.instant("install_abort", layer=self._cur[0],
                                reason="retarget", target=model)
            self._cur = None
        self.target = model
        self._missing = missing
        self.tracer.instant("install_begin", target=model,
                            missing=len(missing), step=step)

    def _evictable(self, slot: int, pinned: Set[str]) -> bool:
        if slot in self.res.retired:
            return False
        occ = self.res.slots[slot]
        return occ is None or self.res.model_of[occ] not in pinned

    def _pick(self, pinned: Set[str]) -> Optional[Tuple[int, int, int]]:
        best = None
        for slot in range(self.res.arena_slots):
            if not self._evictable(slot, pinned):
                continue
            for layer in self._missing:
                wire = self.res._cost(self.res.slots[slot], layer)[0]
                key = (*self.res._victim_key(slot, wire), layer,
                       self.res._stamp[slot])
                if best is None or key < best[0]:
                    best = (key, layer, slot)
        if best is None:
            return None
        _, layer, slot = best
        # key[0] is the wear-blended cost, not the wire bytes — re-read the
        # memoized cost for the tick budget
        wire = self.res._cost(self.res.slots[slot], layer)[0]
        return layer, slot, wire

    def pump(self, ticks: int, pinned: Set[str], step: int
             ) -> Tuple[int, int]:
        """Spend up to `ticks` install ticks toward the target's missing
        layers.  Returns (wire bytes committed, wire bytes processed) — the
        latter includes the pro-rata share of partially pumped installs, so
        the engine can attribute this step's DMA work to overlap-hidden vs
        stalled time."""
        if self.target is None:
            return 0, 0
        pinned = set(pinned) | {self.target}
        committed = 0
        processed = 0.0
        while ticks > 0:
            if self._cur is None:
                if not self._missing:
                    break
                pick = self._pick(pinned)
                if pick is None:
                    break               # nothing evictable right now
                layer, slot, wire = pick
                self._missing.remove(layer)   # _missing never holds in-flight
                t = self.cost.ticks_for(wire)
                self._cur = [layer, slot, t, t, wire]
                if self.tracer.enabled:
                    self.tracer.instant("install_victim", layer=layer,
                                        slot=slot, wire=wire, ticks=t)
            elif not self._evictable(self._cur[1], pinned):
                # our victim got re-pinned (e.g. the outgoing tenant's turn
                # did not actually end) — drop the partial transfer and put
                # the layer back on the queue
                self.aborts += 1
                self.tracer.instant("install_abort", layer=self._cur[0],
                                    reason="victim repinned")
                self._missing.append(self._cur[0])
                self._cur = None
                continue
            layer, slot, left, total, wire = self._cur
            spend = min(ticks, left)
            ticks -= spend
            left -= spend
            self.pumped_ticks += spend
            processed += wire * (spend / total)
            self._cur[2] = left
            if left == 0:
                done = self.res._install(layer, slot, step)
                self._cur = None
                if done is None:
                    # the victim slot faulted at program time — it is now
                    # retired; re-queue the layer so the next unit picks a
                    # healthy slot
                    self._missing.append(layer)
                else:
                    committed += done
        if self._cur is None and not self._missing:
            self.target = None          # fully resident: pipeline drains
        self.res.store.drop_device_copies()
        return committed, int(round(processed))
