"""Slot-managed KV-cache arena for continuous batching — PyTorch port of
`repro.serving.kv_arena`.

The arena is one device cache tree with a leading *slot* axis (the batch
axis of `nn.model.init_cache`), plus host-side occupancy bookkeeping that
mirrors the crossbar-row `_Occupancy` discipline in the ARAS simulator: a
freed slot keeps its stale contents until the next occupant's prefill
overwrites them — like a released crossbar row holding the previous
layer's codes — and correctness relies on the per-slot position mask, not
on zeroing.  Requests join and leave between decode steps; a slot write
only ever touches its own row, so eviction cannot corrupt an in-flight
neighbor.
"""
from __future__ import annotations

from collections import deque
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.model import init_cache
from repro_torch.nn.transformer import stack_plan
from repro_torch.tree import tree_map


def slot_write(cfg: ModelConfig, caches, one, slot: int) -> None:
    """Write a batch-1 cache `one` into arena row `slot`, in place (the
    reference's `_cached_slot_write`): every leaf of every segment — K/V,
    MLA latents, and the recurrent state of hybrid, mLSTM and sLSTM
    layers.  Scanned segments carry the stacked layer axis first, so the
    slot axis is 1 there and 0 on unrolled ones.  As
    `dynamic_update_slice` does, the write covers `one`'s own extent from
    index 0 on every other axis: a staging shorter than `max_seq` leaves
    the row's later positions stale."""
    def write(a, o, ax):
        idx = [slice(0, n) for n in o.shape]
        idx[ax] = slice(slot, slot + 1)
        a[tuple(idx)] = o.to(a.dtype)

    for seg_a, seg_o, (_, _, scanned) in zip(caches, one, stack_plan(cfg)):
        tree_map(lambda a, o, ax=1 if scanned else 0: write(a, o, ax),
                 seg_a, seg_o)


class KVArena:
    layout = "slot"

    def __init__(self, cfg: ModelConfig, n_slots: int, max_seq: int,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.caches = init_cache(cfg, n_slots, max_seq, device=self.device)
        self.owner: List[Optional[int]] = [None] * n_slots   # rid or None
        self.pos = np.zeros(n_slots, np.int32)
        self.last_token = np.zeros(n_slots, np.int32)
        self._free: deque = deque(range(n_slots))
        self.evictions = 0

    # ------------------------------------------------------------- slots
    @property
    def n_free(self) -> int:
        return len(self._free)

    def active_slots(self) -> List[int]:
        return [s for s, o in enumerate(self.owner) if o is not None]

    def owner_of(self, slot: int) -> Optional[int]:
        return self.owner[slot]

    def alloc(self, rid: int) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.popleft()
        self.owner[slot] = rid
        return slot

    def evict(self, slot: int) -> Optional[int]:
        """Release a slot (finish or preemption).  Contents stay stale on
        the device — the occupancy map is the only thing that changes."""
        rid = self.owner[slot]
        if rid is None:
            return None
        self.owner[slot] = None
        self._free.append(slot)
        self.evictions += 1
        return rid

    # ------------------------------------------------------------ caches
    def install(self, slot: int, one_caches: Any, first_token: int,
                prompt_len: int) -> None:
        """Write a freshly prefilled batch-1 cache into `slot` and arm its
        decode state (next write position = prompt_len)."""
        slot_write(self.cfg, self.caches, one_caches, slot)
        self.pos[slot] = prompt_len
        self.last_token[slot] = first_token

    def decode_inputs(self):
        """(tokens (S,), pos (S,)) on the arena's device, covering every
        slot; inactive slots carry stale values whose decode output the
        engine discards."""
        return tuple(torch.from_numpy(a.copy()).to(self.device)
                     for a in (self.last_token, self.pos))

    def advance(self, slot: int, token: int) -> None:
        self.pos[slot] += 1
        self.last_token[slot] = token
