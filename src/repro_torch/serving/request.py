"""Request lifecycle for the continuous-batching engine.

A request is a (tenant model, prompt, token budget) triple plus the mutable
serving state the engine tracks: which KV slot it occupies, what it has
generated so far, and the timestamps the metrics surface aggregates.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"   # chunked prefill in flight, no token yet
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    rid: int
    model: str
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival_t: float
    # sampling: temperature <= 0 is greedy argmax (the default); otherwise
    # temperature/top-k sampling from fold_in(PRNGKey(seed or rid), n) for
    # the n-th generated token (deterministic across schedules).
    temperature: float = 0.0
    top_k: int = 0
    seed: Optional[int] = None
    status: RequestStatus = RequestStatus.QUEUED
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    preemptions: int = 0
    last_token_t: Optional[float] = None
    max_itl: Optional[float] = None   # worst inter-token gap seen
    # when the first prefill chunk (or the monolithic prefill) ran — splits
    # TTFT into time spent queued vs time spent chunk-prefilling
    prefill_start_t: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def serving_prompt(self) -> Tuple[int, ...]:
        """The token prefix a (re-)prefill must run over.  After a
        preemption this includes everything generated so far, so the next
        prefill's last-position logits produce exactly the token the evicted
        decode would have produced."""
        return self.prompt + tuple(self.generated)

    def note_token(self, t: float) -> None:
        """Record a token emission time; tracks the worst inter-token gap,
        which is where install stalls at tenant-turn boundaries surface."""
        if self.last_token_t is not None:
            gap = t - self.last_token_t
            self.max_itl = gap if self.max_itl is None else max(self.max_itl,
                                                                gap)
        self.last_token_t = t

    @property
    def latency(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.arrival_t

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    @property
    def ttft_queue(self) -> Optional[float]:
        """TTFT share spent waiting for admission (arrival → first chunk)."""
        if self.prefill_start_t is None:
            return None
        return self.prefill_start_t - self.arrival_t

    @property
    def ttft_prefill(self) -> Optional[float]:
        """TTFT share spent prefilling (first chunk → first token) — the
        part a prefill-token budget trades against decode interference."""
        if self.first_token_t is None or self.prefill_start_t is None:
            return None
        return self.first_token_t - self.prefill_start_t
