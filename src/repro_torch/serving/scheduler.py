"""Admission control and step scheduling for the serving engine.

Slot-based continuous batching: between decode steps the scheduler admits
waiting requests into free KV slots (each admission runs that request's
prefill — the step mixes prefill and decode work), and picks which tenants
decode this step.  When every active tenant's weights fit the device weight
arena simultaneously, all of them decode every step; otherwise the
scheduler time-slices tenants in turns of `model_turn_steps` so the weight
arena is rewritten once per turn instead of once per step — the ARAS
install-amortization discipline applied across models.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.serving.request import Request, RequestStatus
from repro_torch.serving.tracing import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_queue: int = 256          # admission control: reject beyond this
    max_active: Optional[int] = None  # global concurrent-slot budget
    policy: str = "fcfs"          # fcfs | sjf (shortest prompt first)
    max_prefill_per_step: int = 2  # prefill/decode mixing ratio cap
    model_turn_steps: int = 8     # tenant time-slice when weights don't fit
    # Chunked prefill: cap on prompt tokens a single step may spend on
    # chunk work (None = drain every pending chunk immediately).  With a
    # budget, a long prompt's prefill is spread over several steps and the
    # concurrent decode batch keeps emitting a token every step — the ARAS
    # §V discipline of slicing oversized work into scheduler-sized pieces.
    # A step always advances at least one chunk, so a budget smaller than
    # the chunk size degrades to one-chunk-per-step rather than stalling.
    # The budget is cache-aware: prompt tokens served from the radix-tree
    # prefix cache (skipped chunks) cost no compute and are not charged —
    # only chunks the model actually runs count against it.
    prefill_token_budget: Optional[int] = None

    def __post_init__(self):
        if self.policy not in ("fcfs", "sjf"):
            raise ValueError(f"unknown queue policy {self.policy!r} "
                             "(expected 'fcfs' or 'sjf')")
        if (self.prefill_token_budget is not None
                and self.prefill_token_budget < 1):
            raise ValueError("prefill_token_budget must be >= 1 (or None "
                             "for unbudgeted prefill)")


class StepScheduler:
    # structured-event sink for admission/requeue/turn decisions; the
    # engine swaps in its shared Tracer, standalone use keeps the no-op
    tracer = NULL_TRACER

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        self.queue: List[Request] = []
        self.rejected = 0
        self._turn_model: Optional[str] = None
        self._turn_left = 0

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def prefill_token_budget(self) -> float:
        """Prompt tokens this step may spend on chunked-prefill work."""
        b = self.cfg.prefill_token_budget
        return float("inf") if b is None else float(b)

    def queue_wait(self, now: float) -> float:
        """Longest wait among currently-queued requests (0 when empty):
        the head-of-line age `ServingEngine.health()` publishes for the
        router tier — a cheap single pass, no history walk."""
        if not self.queue:
            return 0.0
        return max(now - r.arrival_t for r in self.queue)

    # --------------------------------------------------------- admission
    def submit(self, req: Request) -> bool:
        if len(self.queue) >= self.cfg.max_queue:
            req.status = RequestStatus.REJECTED
            self.rejected += 1
            self.tracer.instant("sched_reject", rid=req.rid,
                                queue_depth=len(self.queue))
            return False
        self.queue.append(req)
        return True

    def requeue(self, req: Request) -> None:
        """Preempted requests go to the head: they already hold progress."""
        req.status = RequestStatus.PREEMPTED
        self.queue.insert(0, req)

    def next_admits(self, free_slots: Dict[str, int], n_active: int,
                    can_admit: Optional[Callable[[Request], bool]] = None
                    ) -> List[Request]:
        """Pop up to `max_prefill_per_step` requests that have a free KV
        slot (slot arenas) or decode row (paged arenas) in their tenant's
        arena and fit the global active budget.  `can_admit` adds the
        paged-layout page check — "enough free pages for this request's
        non-shared blocks?" — on top of the per-tenant row count."""
        budget = (float("inf") if self.cfg.max_active is None
                  else self.cfg.max_active)
        order = list(self.queue)
        if self.cfg.policy == "sjf":
            # preempted requests keep their head-of-queue priority (they
            # hold generated progress); only fresh arrivals sort by length
            order.sort(key=lambda r: (
                r.status is not RequestStatus.PREEMPTED,
                len(r.serving_prompt())))
        free = dict(free_slots)
        admits: List[Request] = []
        for req in order:
            if len(admits) >= self.cfg.max_prefill_per_step:
                break
            if n_active + len(admits) >= budget:
                break
            if free.get(req.model, 0) <= 0:
                continue
            if can_admit is not None and not can_admit(req):
                continue
            free[req.model] -= 1
            admits.append(req)
        for req in admits:
            self.queue.remove(req)
        return admits

    # ------------------------------------------------------ decode picks
    @property
    def current_turn_model(self) -> Optional[str]:
        return self._turn_model

    @property
    def turn_steps_left(self) -> int:
        return self._turn_left

    @property
    def turn_ending(self) -> bool:
        """True right after a `pick_models` that handed the turn holder its
        final time-slice step — the install pipeline's cue that the holder's
        slots can be overwritten behind this step's execution front."""
        return self._turn_model is not None and self._turn_left <= 0

    def refund_turn_step(self) -> None:
        """Give the turn holder back one slice step.  The engine calls this
        when the holder spent the step stalled on weight installs instead of
        decoding, so install latency never eats the decode slice (which
        could otherwise rotate a never-resident tenant forever)."""
        if self._turn_model is not None:
            self._turn_left += 1

    def peek_next_model(self, demand_models: Sequence[str]) -> Optional[str]:
        """The tenant the rotation will hand the turn to next — what the
        install pipeline should prefetch during the current holder's final
        steps.  None when no turn is active (co-resident tenants switch
        nothing)."""
        demand = sorted(set(demand_models))
        if not demand or self._turn_model is None:
            return None
        after = [m for m in demand if m > self._turn_model]
        return after[0] if after else demand[0]

    def pick_models(self, demand_models: Sequence[str], residency
                    ) -> List[str]:
        """Which tenants run this step (decode AND admissions — prefill only
        happens on a scheduled, weight-resident tenant).  All tenants with
        demand run when co-resident in the weight arena; otherwise the
        scheduler holds one tenant for `model_turn_steps` steps so installs
        amortize.  The turn is stateful — tenants joining or draining
        mid-turn never remap the current pick."""
        demand = sorted(set(demand_models))
        if not demand:
            self._turn_model, self._turn_left = None, 0
            return []
        if residency is None or residency.fits(demand):
            self._turn_model, self._turn_left = None, 0
            return demand
        if self._turn_model not in demand or self._turn_left <= 0:
            # rotate cyclically past the previous turn holder
            after = [m for m in demand if m > (self._turn_model or "")]
            self._turn_model = after[0] if after else demand[0]
            self._turn_left = max(self.cfg.model_turn_steps, 1)
            self.tracer.instant("turn_rotate", model=self._turn_model,
                                steps=self._turn_left)
        self._turn_left -= 1
        return [self._turn_model]
