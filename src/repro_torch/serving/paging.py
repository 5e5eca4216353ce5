"""Paged KV-cache subsystem — PyTorch port of `repro.serving.paging`:
block page tables, prefix sharing, and COW.

  * `PageAllocator` — the host-side occupancy map over fixed-size KV pages
    (copied from the reference): free-list allocation (FIFO, or
    coldest-first by the pool's wear plane), per-request page tables,
    refcounted prefix sharing through the radix tree, copy-on-write when a
    shared page is about to diverge, and program-and-verify against an
    injected stuck-at fault model that retires a faulted page for good.
    A freed page keeps its stale device contents until the next occupant
    overwrites them — correctness comes from position masks.
  * `PagedKVArena` — the device side: one page-pool cache tree per tenant
    (the prefill cache layout with the batch axis reinterpreted as the
    page axis) plus per-row decode state.  Requests address their KV
    through an `(n_rows, n_pages)` page-table array consumed by the paged
    decode path in `nn/attention.py`.  A chunked prefill stages its row
    (`stage`), reserves pages chunk by chunk (`grow`), seeds its staging
    cache from shared prefix pages (`load_prefix`, `page_read`) and
    installs the rest at its last chunk (`finish_stage`).  Every page it
    programs (install, staged install, COW copy) is counted, in bytes and
    in the injected wear plane, with the shared pages an install skipped.

Device page 0 is reserved as a scratch page: inactive decode rows keep
all-zero page tables, so their (discarded) decode writes land in the
scratch page instead of corrupting a reallocated neighbor.

Pool and staging writes (page install, staged install, COW copy, decode
append, prefix read-back) update their tensors in place; the reference
donates them to a jitted function instead.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.attention import _kv_dequant
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.transformer import layer_kind, stack_plan
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.tracing import NULL_TRACER
from repro_torch.tree import tree_map


class PageAllocator:
    """Host-side occupancy map over `n_pages` KV pages of `page_size` tokens.

    Physical page ids run 1..n_pages; id 0 is the arena's reserved scratch
    page and is never handed out."""

    # structured-event sink for eviction/COW/donation decisions; the
    # engine swaps in its shared Tracer, standalone use keeps the no-op
    tracer = NULL_TRACER
    # stuck-at fault model (serving/faults.py) + the wear-plane name its
    # checks key on, injected by the engine; None = fault-free allocation
    faults = None
    fault_plane = "kv"
    # wear-plane over this pool's page ids, shared with the owning arena;
    # enable_wear_aware() switches the free structure to coldest-first
    wear = None

    def __init__(self, n_pages: int, page_size: int, *,
                 retain: bool = False, max_cached: Optional[int] = None):
        if n_pages < 1 or page_size < 1:
            raise ValueError("need n_pages >= 1 and page_size >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self.retain = retain
        # FIFO free deque by default; enable_wear_aware() rebuilds it as a
        # (writes, page) min-heap so allocation hands out the coldest page
        # first — valid because pages only accrue writes while allocated,
        # so a free page's wear never changes under it
        self._free = deque(range(1, n_pages + 1))
        self.wear_aware = False
        # pages permanently pulled from service after a stuck-at fault —
        # never re-issued (neither free nor referenced)
        self.retired: set = set()
        self.pages_retired = 0
        self.refcount = np.zeros(n_pages + 1, np.int32)
        self.tables: Dict[int, List[int]] = {}      # rid -> physical pages
        # prefix index + retention layer: radix tree over token-block
        # edges; the tree's incremental evictable count watches our
        # refcounts, so every crossing of the ==1 boundary is reported
        # back through note_refcount (see _pin / free_page)
        self.tree = RadixPrefixCache(
            page_size, max_cached=max_cached,
            refcount_of=lambda page: int(self.refcount[page]))
        # lifetime stats
        self.pages_allocated = 0
        self.shared_hits = 0
        self.cow_copies = 0

    # ------------------------------------------------------------- sizing
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    def occupancy(self) -> float:
        return self.n_used / self.n_pages

    def blocks_for(self, n_tokens: int) -> int:
        return max(-(-n_tokens // self.page_size), 1)

    # ---------------------------------------------------------- low level
    def enable_wear_aware(self, plane) -> None:
        """Switch free-page ordering from FIFO to coldest-first, steered by
        `plane` (the pool's WearPlane): the free structure becomes a
        (writes, page) min-heap, so every allocation programs the least-
        worn free page.  Ties break toward the lower page id, keeping the
        order deterministic."""
        self.wear = plane
        self.wear_aware = True
        heap = [(int(plane.writes[p - plane.first]), p) for p in self._free]
        heapq.heapify(heap)
        self._free = heap

    def _free_push(self, page: int) -> None:
        if self.wear_aware:
            heapq.heappush(
                self._free,
                (int(self.wear.writes[page - self.wear.first]), page))
        else:
            self._free.append(page)

    def _free_pop(self) -> int:
        if self.wear_aware:
            return heapq.heappop(self._free)[1]
        return self._free.popleft()

    def _take_page(self) -> Optional[int]:
        """Pop free pages until one takes the program cleanly
        (program-and-verify): a page that faults is retired for good (never
        re-issued), the free list is topped back up through LRU eviction
        when retirement drains it, and None means no healthy page is left —
        the caller unwinds with no side effects and degrades like any other
        pool exhaustion (preempt, resume when pages free up)."""
        while True:
            if not self._free and not self.ensure_free(1):
                return None
            page = self._free_pop()
            if (self.faults is not None
                    and self.faults.check(self.fault_plane, page)):
                self.retired.add(page)
                self.pages_retired += 1
                if self.wear is not None:
                    self.wear.retire(page)
                self.tracer.instant("page_retired", page=page,
                                    plane=self.fault_plane)
                continue
            self.refcount[page] = 1
            self.pages_allocated += 1
            return page

    def free_page(self, page: int) -> None:
        """Drop one reference; the page returns to the free list (contents
        left stale on device) only when the last holder lets go.  A dying
        live page takes its tree node with it, cascading through any
        retained subtree below (whose refs come back through this very
        method — by_page is cleared first, so re-entry is a no-op)."""
        if self.refcount[page] <= 0:
            raise ValueError(f"double free of page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self.tree.drop_page(page, self.free_page)
            self._free_push(page)
        elif self.refcount[page] == 1:
            # last external holder left a retained page: it just became
            # solely tree-held, i.e. evictable — tell the tree's count
            self.tree.note_refcount(page)

    def _pin(self, page: int) -> None:
        """Take one shared reference on a resident prefix page.  The 1→2
        crossing makes a retained page non-evictable; the tree's
        incremental count hears about it here."""
        self.refcount[page] += 1
        self.shared_hits += 1
        if self.refcount[page] == 2:
            self.tree.note_refcount(page)

    def _sole(self, page: int) -> bool:
        """Nobody but the tree holds this page — the eviction predicate."""
        return self.refcount[page] == 1

    # ------------------------------------------------------ prefix sharing
    def match_prefix(self, tokens: Tuple[int, ...],
                     touch: bool = True) -> List[int]:
        """Longest chain of resident pages whose token prefixes match
        `tokens` block by block — a radix-tree walk, one dict probe per
        block (O(blocks) incremental hashing, not the old O(blocks·len)
        full-prefix tuples).  Full blocks match on block-boundary edges;
        the final partial block matches only an exact-tuple edge (a page
        holding *more* than the lookup key would require mid-page writes
        during prefill, where sharing buys nothing over writing a fresh
        page).  `touch=False` keeps pure capacity probes out of the LRU
        order."""
        return self.tree.match(tuple(tokens), touch=touch)

    def register(self, rid: int, tokens: Tuple[int, ...]) -> None:
        """Publish a freshly installed table's pages under their token
        prefixes so later requests can share them.  First writer wins; a
        page is only ever indexed under one key."""
        self.tree.register(tuple(tokens), self.tables[rid])

    # ----------------------------------------------------------- eviction
    def evictable_pages(self, exclude: FrozenSet[int] = frozenset()) -> int:
        """Pages on-demand eviction could free right now (exact, so
        admission promises only what `ensure_free` can deliver).  O(1)
        plus O(|exclude| chain) — the incrementally maintained count, not
        a tree walk (the scheduling hot path calls this per overflow)."""
        return self.tree.evictable_count(frozenset(exclude))

    def ensure_free(self, need: int) -> bool:
        """LRU-evict retained pages until `need` pages are free.  False
        when the cache cannot cover the shortfall (callers pre-check with
        `evictable_pages` to fail without side effects)."""
        evicted = 0
        while len(self._free) < need:
            if not self.tree.evict_lru(self._sole, self.free_page):
                return False
            evicted += 1
        if evicted:
            self.tracer.instant("kv_evict", n_pages=evicted,
                                cached_left=self.tree.n_cached)
        return True

    # ------------------------------------------------------ request level
    def alloc_table(self, rid: int, tokens: Tuple[int, ...]
                    ) -> Optional[Tuple[List[int], int]]:
        """Build rid's page table over `tokens`: refcount shared prefix
        pages, allocate fresh pages for the rest.  Returns (table,
        n_shared), or None *with no side effects* when the pool cannot
        cover the non-shared tail."""
        if rid in self.tables:
            raise ValueError(f"rid {rid} already holds a table")
        n_blocks = self.blocks_for(len(tokens))
        shared = self.match_prefix(tokens)
        for page in shared:          # pin first: pinned pages never evict
            self._pin(page)
        need = n_blocks - len(shared)
        if need > self.n_free + self.evictable_pages():
            for page in shared:      # unpin — no side effects on failure
                self.free_page(page)
            self.shared_hits -= len(shared)
            return None
        self.ensure_free(need)
        fresh: List[int] = []
        for _ in range(need):
            page = self._take_page()
            if page is None:         # faults drained the pool mid-build
                for p in fresh:
                    self.free_page(p)
                for p in shared:
                    self.free_page(p)
                self.shared_hits -= len(shared)
                return None
            fresh.append(page)
        table = list(shared) + fresh
        self.tables[rid] = table
        return table, len(shared)

    def begin_table(self, rid: int, tokens: Tuple[int, ...]) -> int:
        """Chunked-prefill admission: open rid's table with just the shared
        prefix pages (refcounted now — sharing is checked against the whole
        prompt, which is known up front).  Fresh pages for the non-shared
        tail are reserved chunk by chunk through grow_table; a reservation
        that loses the race to decode neighbors fails cleanly there.
        Returns the number of shared pages."""
        if rid in self.tables:
            raise ValueError(f"rid {rid} already holds a table")
        shared = self.match_prefix(tokens)
        for page in shared:
            self._pin(page)
        self.tables[rid] = list(shared)
        return len(shared)

    def grow_table(self, rid: int, n_blocks: int) -> bool:
        """Reserve fresh pages until rid's table covers `n_blocks` blocks
        (one prefill chunk's worth at a time).  False with *no side effects*
        when the pool cannot cover the growth — the caller preempts the
        prefill, which resumes at its last completed chunk."""
        need = n_blocks - len(self.tables[rid])
        if need <= 0:
            return True
        if need > self.n_free + self.evictable_pages():
            return False
        self.ensure_free(need)
        added: List[int] = []
        for _ in range(need):
            page = self._take_page()
            if page is None:         # faults drained the pool mid-growth
                for p in added:
                    self.free_page(p)
                return False
            added.append(page)
        self.tables[rid].extend(added)
        return True

    def extend(self, rid: int) -> Optional[int]:
        """Append one fresh page to rid's table (decode crossed a page
        boundary), LRU-evicting a retained page if the free list is empty.
        None when the pool is exhausted — the caller preempts."""
        if not self.ensure_free(1):
            return None
        page = self._take_page()
        if page is None:
            return None
        self.tables[rid].append(page)
        return page

    def cow(self, rid: int, block: int) -> Optional[Tuple[int, int]]:
        """Make rid's `block` exclusively owned before a write.  Returns
        (src, dst) when a device page copy is required, (page, page) when
        the page was already exclusive, None when the pool is exhausted
        (after LRU-evicting any retained pages it could)."""
        old = self.tables[rid][block]
        if self.refcount[old] <= 1:
            return old, old
        if not self.ensure_free(1):
            return None
        new = self._take_page()
        if new is None:
            return None
        self.free_page(old)          # our ref only; other holders keep it
        self.tables[rid][block] = new
        self.cow_copies += 1
        self.tracer.instant("kv_cow", rid=rid, block=block, src=old, dst=new)
        return old, new

    def free_table(self, rid: int,
                   donate_tokens: Optional[Tuple[int, ...]] = None) -> None:
        """Release rid's table.  With retention on and `donate_tokens` (the
        token sequence the table holds valid K/V for — prompt + generated
        minus the just-emitted last token), the pages enter the radix tree
        retained instead of returning to the free list: the next request
        sharing the prefix finds them resident."""
        table = self.tables.pop(rid)
        if (self.retain and donate_tokens
                and len(table) == self.blocks_for(len(donate_tokens))):
            ev0 = self.tree.evictions
            gained = self.tree.donate(tuple(donate_tokens), table,
                                      self.free_page)
            # cap-enforcement evictions happen inside donate, not
            # ensure_free — surface them here so the trace accounts for
            # every LRU eviction the summary reports
            self.tracer.instant("kv_donate", rid=rid, n_pages=len(table),
                                retained=gained,
                                cap_evictions=self.tree.evictions - ev0)
        else:
            for page in table:
                self.free_page(page)



# ---------------------------------------------------------------- device
def init_page_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                   dtype=torch.bfloat16, device="cuda"):
    """Page-pool cache tree: the prefill cache layout with the batch axis
    reinterpreted as the page axis; stacked segments get (L, P, ...)
    leaves.  int8 GQA configs hold codes plus per-(token, head) f32 scales;
    MLA configs hold latent pools {c_kv (P, page, kv_lora_rank), k_rope
    (P, page, rope)} in `dtype`, int8 or not, as the reference does."""
    dev = resolve_device(device)
    int8 = cfg.kv_cache_dtype == "int8"
    caches = []
    for _, length, scanned in stack_plan(cfg):
        lead = (length,) if scanned else ()
        if cfg.attn_type == "mla":
            caches.append({"attn": {
                name: torch.zeros(lead + (n_pages, page_size, width),
                                  dtype=dtype, device=dev)
                for name, width in (("c_kv", cfg.kv_lora_rank),
                                    ("k_rope", cfg.qk_rope_dim))}})
            continue
        shape = lead + (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        kv_dt = torch.int8 if int8 else dtype
        entry = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
                 "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
        if int8:
            entry["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=dev)
            entry["v_scale"] = torch.zeros_like(entry["k_scale"])
        caches.append({"attn": entry})
    return caches


def page_write(cfg: ModelConfig, pool, one, block: int, page: int) -> None:
    """Copy logical block `block` of a batch-1 prefill cache `one` into
    physical page `page` of the pool, in place (the reference's
    `_cached_page_write`)."""
    for seg_pool, seg_one, (_, _, scanned) in zip(pool, one, stack_plan(cfg)):
        def upd(a, o, scanned=scanned):
            ps = a.shape[2] if scanned else a.shape[1]
            if scanned:   # a (L, P, ps, ...), o (L, 1, Lbuf, ...)
                a[:, page] = o[:, 0, block * ps:(block + 1) * ps]
            else:         # a (P, ps, ...), o (1, Lbuf, ...)
                a[page] = o[0, block * ps:(block + 1) * ps]
        tree_map(upd, seg_pool, seg_one)


def page_read(cfg: ModelConfig, one, pool, block: int, page: int) -> None:
    """Copy physical page `page` of the pool into logical block `block` of
    a batch-1 staging cache `one`, in place: the inverse of `page_write`
    (the reference's `_cached_page_read`).  bf16 pools copy bit for bit;
    int8 pools dequantize the page's codes with its per-(token, head)
    scales into the raw staging K/V, so a reloaded prefix carries the
    quantization error decode attends after install.  MLA latent pools
    copy every leaf bit for bit."""
    int8 = cfg.kv_cache_dtype == "int8" and cfg.attn_type != "mla"
    for seg_one, seg_pool, (_, _, scanned) in zip(one, pool,
                                                  stack_plan(cfg)):
        po, pa = seg_one["attn"], seg_pool["attn"]
        for f in po:
            if scanned:   # pool (L, P, ps, ...), staging (L, 1, Lbuf, ...)
                src, dst = pa[f][:, page], po[f][:, 0]
                scale = pa[f + "_scale"][:, page] if int8 else None
            else:         # pool (P, ps, ...), staging (1, Lbuf, ...)
                src, dst = pa[f][page], po[f][0]
                scale = pa[f + "_scale"][page] if int8 else None
            if int8:
                src = _kv_dequant(src, scale, dst.dtype)
            ax = 1 if scanned else 0      # the page's token axis
            ps = src.shape[ax]
            dst.narrow(ax, block * ps, ps).copy_(src)


def page_copy(cfg: ModelConfig, pool, src: int, dst: int) -> None:
    """COW page copy: pool page `src` -> pool page `dst`, in place (the
    reference's `_cached_page_copy`)."""
    for seg, (_, _, scanned) in zip(pool, stack_plan(cfg)):
        def cp(a, scanned=scanned):
            if scanned:
                a[:, dst] = a[:, src]
            else:
                a[dst] = a[src]
        tree_map(cp, seg)


class PagedKVArena:
    """Device page pool + per-row decode state for one tenant.

    Rows are decode-batch positions (the decode step always runs `n_rows`
    rows; inactive rows decode discarded garbage against the reserved
    scratch page).  Pages are the storage unit: a request holds
    ceil(len/page_size) of them, up to the whole pool."""

    layout = "paged"
    # structured-event sink (shared with self.allocator); the engine
    # swaps in its Tracer, standalone use keeps the no-op
    tracer = NULL_TRACER
    # wear-telemetry sink, injected like the tracer: the engine's
    # WearPlane over this pool's page ids (1..n_pages; the scratch page 0
    # never takes an accounted write).  Standalone use records nothing.
    wear = None

    def __init__(self, cfg: ModelConfig, n_rows: int, n_pages: int,
                 page_size: int, *, prefix_cache: bool = False,
                 prefix_cache_pages: int = 0, device="cuda"):
        for start, _, _ in stack_plan(cfg):
            if layer_kind(cfg, start) != "attn":
                raise ValueError(
                    "paged KV needs a pure-attention stack; "
                    f"layer {start} of {cfg.name} is "
                    f"{layer_kind(cfg, start)!r} (use kv_layout='slot')")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_rows = n_rows
        self.page_size = page_size
        self.prefix_cache = bool(prefix_cache)
        # chunk-skip reloads pool pages into the staging carry-in (int8
        # pools dequantize on the way out, `page_read`), so every tenant
        # with the prefix cache on skips covered chunks
        self.skip_ok = self.prefix_cache
        self.allocator = PageAllocator(
            n_pages, page_size, retain=self.prefix_cache,
            max_cached=(prefix_cache_pages or None) if prefix_cache
            else None)
        self.caches = init_page_pool(cfg, n_pages + 1, page_size,
                                     device=self.device)
        # Device bytes one logical page write programs: a page write copies
        # this page's slice of EVERY pool leaf (all layers — see
        # page_write), so per-page bytes = per-leaf page-axis slice summed
        # across leaves.  Feeds the KV write-energy conversion.
        self.page_bytes = sum(
            leaf.numel() * leaf.element_size() // (n_pages + 1)
            for seg in self.caches for leaf in seg["attn"].values())
        # write-side accounting: physical page programs (prefill scatter,
        # staged install, COW copies) and the programs retained-page /
        # live-prefix sharing avoided (shared pages an install skipped)
        self.kv_page_writes = 0
        self.kv_bytes_written = 0
        self.kv_page_writes_avoided = 0
        self.owner: List[Optional[int]] = [None] * n_rows
        self.pos = np.zeros(n_rows, np.int32)
        self.last_token = np.zeros(n_rows, np.int32)
        # page-table rows consumed by the decode step; 0 = scratch page
        self.tables_np = np.zeros((n_rows, n_pages), np.int32)
        self._n_shared: Dict[int, int] = {}   # rid -> shared prefix pages
        self._free_rows: deque = deque(range(n_rows))

    # ------------------------------------------------------------ sizing
    @property
    def max_tokens(self) -> int:
        """Per-request ceiling: the whole pool (not a per-slot constant)."""
        return self.allocator.n_pages * self.page_size

    @property
    def n_free(self) -> int:
        """Free decode rows (the scheduler's per-tenant admission count)."""
        return len(self._free_rows)

    def blocks_for(self, n_tokens: int) -> int:
        return self.allocator.blocks_for(n_tokens)

    def can_admit(self, tokens: Tuple[int, ...]) -> bool:
        """Enough free pages for the non-shared tail — counting retained
        pages LRU eviction could free on demand — and a free row."""
        if not self._free_rows:
            return False
        a = self.allocator
        need = self.blocks_for(len(tokens))
        if need <= a.n_free:
            return True     # fits even with zero sharing
        shared = a.match_prefix(tuple(tokens), touch=False)
        need -= len(shared)
        # matched pages are about to be pinned, not consumed — exclude
        # them from the evictable count so the promise stays exact
        ok = need <= a.n_free + a.evictable_pages(frozenset(shared))
        if self.tracer.enabled:
            self.tracer.instant("kv_admit", ok=ok, need=need,
                                free=a.n_free, shared=len(shared))
        return ok

    # ------------------------------------------------------------- rows
    def active_slots(self) -> List[int]:
        return [r for r, o in enumerate(self.owner) if o is not None]

    def owner_of(self, row: int) -> Optional[int]:
        return self.owner[row]

    def alloc(self, rid: int, tokens: Tuple[int, ...]) -> Optional[int]:
        """Claim a row and a page table covering `tokens`; None (no side
        effects) when rows or pages are short."""
        if not self._free_rows:
            return None
        got = self.allocator.alloc_table(rid, tuple(tokens))
        if got is None:
            return None
        table, n_shared = got
        row = self._free_rows.popleft()
        self.owner[row] = rid
        self._n_shared[rid] = n_shared
        self.tables_np[row, :] = 0
        self.tables_np[row, :len(table)] = table
        return row

    def evict(self, row: int,
              donate: Optional[Tuple[int, ...]] = None) -> Optional[int]:
        """Release a row (finish or preemption): refcounts drop, pages whose
        last holder left return to the free list with stale contents.
        `donate` (a finished request's prompt + generated tokens) instead
        retains the pages in the prefix cache: the table holds valid K/V
        for the first `pos` of them (the just-emitted last token was never
        written), so that prefix is what enters the tree."""
        rid = self.owner[row]
        if rid is None:
            return None
        tokens = None
        if donate is not None and self.prefix_cache:
            tokens = tuple(donate)[:int(self.pos[row])]
        self.allocator.free_table(rid, donate_tokens=tokens)
        self._n_shared.pop(rid, None)
        self.owner[row] = None
        self.tables_np[row, :] = 0
        self._free_rows.append(row)
        return rid

    # ------------------------------------------------------------ caches
    def _note_page_write(self, page: int) -> None:
        """One physical page programmed (prefill scatter, staged install,
        or COW copy) — the KV-plane analogue of a weight install."""
        self.kv_page_writes += 1
        self.kv_bytes_written += self.page_bytes
        if self.wear is not None:
            self.wear.record(page)

    def install(self, row: int, one_caches: Any, first_token: int,
                tokens: Tuple[int, ...]) -> None:
        """Scatter a freshly prefilled batch-1 cache into this row's
        non-shared pages (shared prefix pages already hold identical K/V),
        publish the pages for future sharing, and arm decode state."""
        rid = self.owner[row]
        table = self.allocator.tables[rid]
        self.kv_page_writes_avoided += self._n_shared[rid]
        for i in range(self._n_shared[rid], len(table)):
            page_write(self.cfg, self.caches, one_caches, i, table[i])
            self._note_page_write(table[i])
        self.allocator.register(rid, tuple(tokens))
        self.pos[row] = len(tokens)
        self.last_token[row] = first_token

    # --------------------------------------------- chunked-prefill staging
    def stage(self, rid: int, tokens: Tuple[int, ...]) -> Optional[int]:
        """Chunked-prefill admission: claim a decode row and open a
        chunk-granular page reservation (shared prefix pages refcounted
        now, fresh pages reserved per chunk through grow()).  The row's
        page table stays aimed at the scratch page until finish_stage: the
        batched decode step computes this row meanwhile, and its write must
        land in the scratch page, not in reserved real pages."""
        if not self._free_rows:
            return None
        n_shared = self.allocator.begin_table(rid, tuple(tokens))
        row = self._free_rows.popleft()
        self.owner[row] = rid
        self._n_shared[rid] = n_shared
        self.tables_np[row, :] = 0
        self.pos[row] = 0
        self.last_token[row] = 0
        return row

    def grow(self, rid: int, n_blocks: int) -> bool:
        """Reserve pages for the next prefill chunk; False = pool exhausted
        (the engine preempts the prefill, staging intact)."""
        return self.allocator.grow_table(rid, n_blocks)

    def covered_tokens(self, rid: int, n_tokens: int) -> int:
        """Prompt tokens of rid covered by its shared (cached or live)
        prefix pages — the ceiling for chunk-skip.  An exact-tuple tail
        match shares a partial page, so the cover is capped at the
        prompt itself."""
        return min(self._n_shared.get(rid, 0) * self.page_size, n_tokens)

    def load_prefix(self, rid: int, staging: Any, n_tokens: int) -> Any:
        """Seed a staging cache, in place, with rid's shared prefix pages
        covering its first `n_tokens` positions: every page overlapping
        [0, n_tokens) is read whole.  Positions >= n_tokens are recomputed
        (overwritten) by the next chunk.  Returns the staging."""
        table = self.allocator.tables[rid]
        n_blocks = -(-n_tokens // self.page_size)
        if n_blocks > self._n_shared.get(rid, 0):
            raise ValueError("load_prefix beyond the shared prefix")
        for i in range(n_blocks):
            page_read(self.cfg, staging, self.caches, i, table[i])
        return staging

    def finish_stage(self, row: int, staging: Any, first_token: int,
                     tokens: Tuple[int, ...]) -> None:
        """Last chunk done: write the staged K/V (the install source: int8
        tenants' quantized) into the reserved pages that are not shared
        with the prefix tree (shared pages already hold the same values),
        publish the prefix, point the row's page table at the real pages,
        and arm decode state."""
        rid = self.owner[row]
        table = self.allocator.tables[rid]
        if len(table) != self.blocks_for(len(tokens)):
            raise ValueError("finish_stage before the table covered the "
                             "prompt")
        self.kv_page_writes_avoided += self._n_shared[rid]
        for i in range(self._n_shared[rid], len(table)):
            page_write(self.cfg, self.caches, staging, i, table[i])
            self._note_page_write(table[i])
        self.allocator.register(rid, tuple(tokens))
        self.tables_np[row, :] = 0
        self.tables_np[row, :len(table)] = table
        self.pos[row] = len(tokens)
        self.last_token[row] = first_token

    def prepare_decode(self, row: int) -> bool:
        """Before a decode step writes this row's token at `pos`: extend the
        table if `pos` crossed into a new block, and COW the target page if
        it is shared.  False when the pool is exhausted (caller preempts)."""
        rid = self.owner[row]
        table = self.allocator.tables[rid]
        block = int(self.pos[row]) // self.page_size
        if block >= self.tables_np.shape[1]:
            return False               # request outgrew the whole pool
        if block == len(table):
            page = self.allocator.extend(rid)
            if page is None:
                return False
            self.tables_np[row, block] = page
            return True
        got = self.allocator.cow(rid, block)
        if got is None:
            return False
        src, dst = got
        if src != dst:
            page_copy(self.cfg, self.caches, src, dst)
            self.tables_np[row, block] = dst
            self._note_page_write(dst)
        return True

    def decode_inputs(self):
        """(tokens (R,), pos (R,), tables (R, n_pages)) on the arena's
        device, covering every row; inactive rows carry stale state aimed
        at the scratch page."""
        return tuple(torch.from_numpy(a.copy()).to(self.device)
                     for a in (self.last_token, self.pos, self.tables_np))

    def advance(self, row: int, token: int) -> None:
        self.pos[row] += 1
        self.last_token[row] = token

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        a = self.allocator
        return {
            "kv_pages_total": float(a.n_pages),
            "kv_pages_used": float(a.n_used),
            "kv_page_occupancy": a.occupancy(),
            "kv_pages_allocated": float(a.pages_allocated),
            "kv_shared_page_hits": float(a.shared_hits),
            "kv_cow_copies": float(a.cow_copies),
            "kv_prefix_cached_pages": float(a.tree.n_cached),
            "kv_prefix_evictions": float(a.tree.evictions),
            "kv_page_writes": float(self.kv_page_writes),
            "kv_bytes_written": float(self.kv_bytes_written),
            "kv_page_writes_avoided": float(self.kv_page_writes_avoided),
            "kv_pages_retired": float(a.pages_retired),
        }
