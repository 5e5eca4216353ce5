"""Prompt-length bucketing and chunked-prefill progress tracking — port of
`repro.serving.bucketing`.

Chunking makes every full prefill chunk exactly `prefill_chunk` tokens;
the geometric bucket ladder pads the final partial chunk up to the nearest
rung, so the distinct chunk shapes an engine runs are at most the ladder
size (`O(log_growth(chunk))`) instead of one per prompt length.  The
reference bounds its jit traces with it; the port keeps the same shapes,
so a captured step per shape stays bounded the same way.

Ladder guarantees:
  * coverage   — bucket_for(n) >= n for every n <= the top rung;
  * monotone   — rungs strictly increase, bucket_for is non-decreasing;
  * bounded waste — bucket_for(n) <= growth * n.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple


def bucket_ladder(lo: int, hi: int, growth: float) -> List[int]:
    """Geometric rungs lo, ~lo·g, ... capped at hi (always the top rung)."""
    if lo < 1 or hi < 1:
        raise ValueError("ladder bounds must be >= 1")
    if growth <= 1.0:
        raise ValueError("bucket growth must be > 1 (use bucketing=off "
                         "instead of a degenerate ladder)")
    if hi <= lo:
        return [hi]
    rungs = [lo]
    while rungs[-1] < hi:
        rungs.append(min(max(math.ceil(rungs[-1] * growth),
                             rungs[-1] + 1), hi))
    return rungs


def bucket_for(n: int, ladder: List[int]) -> int:
    """Smallest rung >= n (the top rung for anything larger)."""
    for rung in ladder:
        if rung >= n:
            return rung
    return ladder[-1]


@dataclasses.dataclass
class PrefillProgress:
    """Chunked-prefill state of one request: the prompt being prefilled,
    the batch-1 staging cache the chunks accumulate into, and how far they
    got.  Survives mid-prefill preemption — pages and the decode row are
    released, but the staging (per-request memory, not pool) keeps every
    completed chunk's K/V, so readmission resumes at `done`.  A
    prefix-cache hit advances `done` without compute: `skipped` counts
    tokens whose K/V came out of cached pages instead of a chunk run."""
    tokens: Tuple[int, ...]          # full serving prompt (incl. generated)
    caches: Any                      # batch-1 staging cache tree
    done: int = 0                    # prompt tokens covered so far
    skipped: int = 0                 # of those, sourced from cached pages
    staging_len: int = 0             # this request's staging-ladder rung
    logits: Any = None               # final chunk's next-token logits
    start_t: Optional[float] = None  # first chunk launch (TTFT split)

    @property
    def finished(self) -> bool:
        return self.done >= len(self.tokens)
