"""Radix-tree prefix cache over KV pages: retained blocks + LRU eviction.

ARAS §V-C avoids expensive writes by exploiting similarity between what is
already resident and what is about to be written.  The paging layer applies
that to *live* KV (refcounted prefix sharing between concurrent requests),
but an exact-tuple index dies with the last live reference: once the
original holder exits, an identical system prompt re-prefills from scratch.
This module is the retention layer — a radix tree over token-*block* edges
whose nodes pin physical pages in the `PageAllocator`:

  * each node covers one `page_size`-token block and names the physical
    page holding its K/V; a node's path from the root spells the full
    token prefix the page is valid for (hash-chained per-block keys: one
    lookup step hashes one block tuple, so a whole-prompt match costs
    O(blocks) dict probes instead of the old O(blocks·len) full-prefix
    tuples — quadratic in prompt length);
  * a *retained* node owns one allocator refcount on its page, so the page
    survives its last live holder (finished requests donate their
    prompt+generated pages into the tree instead of freeing them);
  * non-retained nodes index pages of live requests only (the
    publish-on-install behavior) and vanish when the page's refcount hits
    zero — including cascade removal of any subtree hanging below them,
    which releases retained descendants' refcounts so no page leaks
    unreachable;
  * eviction is LRU over *evictable leaves*: retained nodes whose page is
    referenced by nobody but the tree and that have no surviving children
    (an inner node can only go after its subtree — removing it first would
    orphan reachable pages).  The allocator evicts on demand whenever an
    admission, a mid-prefill reservation, a decode append, or a COW would
    otherwise fail, and on the retained-page budget (`max_cached`).

Both eviction-side queries are incremental rather than O(tree) walks:

  * `evict_lru` pops candidates off a lazily-invalidated min-heap keyed on
    LRU stamp.  Stale entries (node gone, grew children, or re-stamped)
    are discarded on pop — every state transition into candidacy pushes a
    fresh entry, so a retained leaf always has an entry carrying its
    current stamp.  Entries that fail only the *caller's* predicate
    (`sole`/`exclude`) are set aside and re-pushed, since they stay
    candidates for later calls.
  * `evictable_count` maintains the exact size of the maximal evictable
    set (a node is in it iff its whole subtree is retained, solely
    tree-held, and not excluded) via per-node `n_bad_kids` bookkeeping:
    a node is *good* iff it is retained, externally unreferenced, and has
    no bad child; badness propagates upward on every transition, so the
    count is O(1) and per-call `exclude` handling is O(excluded chain).
    The allocator reports refcount crossings of the ==1 boundary through
    `note_refcount`, and `evictable_walk` keeps the O(tree) reference
    implementation for invariant tests to compare against.

Only the final block of a donated sequence may be partial; partial edges
are always leaves (nothing descends past a partial block) and match only
an exact-tuple lookup, like the index they replace.  Everything here is
host-side bookkeeping — pages keep their device contents; validity comes
from position masks, exactly like a released crossbar row.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Tuple

Tokens = Tuple[int, ...]


class RadixNode:
    """One block edge: `edge` (≤ page_size tokens) extends the parent's
    prefix, `page` holds its K/V.  `retained` means the tree owns one
    allocator refcount on the page; `stamp` is the LRU clock.  `ok` and
    `n_bad_kids` are the incremental evictable-count bookkeeping: `ok`
    means the whole subtree rooted here is evictable (retained, solely
    tree-held, no bad child anywhere); `n_bad_kids` counts children whose
    `ok` is False."""

    __slots__ = ("edge", "page", "parent", "children", "retained", "stamp",
                 "ok", "n_bad_kids")

    def __init__(self, edge: Tokens, page: int, parent: "RadixNode",
                 stamp: int):
        self.edge = edge
        self.page = page
        self.parent = parent
        self.children: Dict[Tokens, "RadixNode"] = {}
        self.retained = False
        self.stamp = stamp
        self.ok = False
        self.n_bad_kids = 0


class RadixPrefixCache:
    """The tree plus its page index.  Refcounts live in the PageAllocator;
    the tree reports which refs it owns (retained nodes) and takes a
    `free_ref` callback wherever it gives one back.  `refcount_of` (the
    allocator's live refcount lookup) feeds the incremental evictable
    count; standalone trees default to "always solely held"."""

    def __init__(self, page_size: int, max_cached: Optional[int] = None,
                 refcount_of: Optional[Callable[[int], int]] = None):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if max_cached is not None and max_cached < 0:
            raise ValueError("max_cached must be >= 0 (None = unbounded)")
        self.page_size = page_size
        self.max_cached = max_cached
        self._refcount_of = refcount_of or (lambda page: 1)
        self._root = RadixNode((), -1, None, 0)   # sentinel, never matched
        self._root.parent = None
        self._by_page: Dict[int, RadixNode] = {}
        self._tick = 0
        # LRU candidate heap: (stamp, seq, page).  Lazily invalidated —
        # entries go stale when the node is removed, grows children, or is
        # re-stamped; evict_lru discards those on pop.
        self._heap: List[Tuple[int, int, int]] = []
        self._heap_seq = 0
        # incremental evictable count: number of `ok` nodes
        self._n_good = 0
        # stats (surfaced through PagedKVArena.stats)
        self.n_cached = 0          # retained nodes currently resident
        self.evictions = 0         # LRU evictions (pages returned to pool)

    # ------------------------------------------------------------ helpers
    def _edges(self, tokens: Tokens) -> Iterable[Tokens]:
        ps = self.page_size
        n = len(tokens)
        for i in range(0, max(n, 1), ps):
            yield tuple(tokens[i:min(i + ps, n)])

    def _bump(self) -> int:
        self._tick += 1
        return self._tick

    def __len__(self) -> int:
        return len(self._by_page)

    # -------------------------------------------- incremental bookkeeping
    def _recompute_up(self, node: Optional[RadixNode]) -> None:
        """Recompute `ok` from this node upward until nothing flips.  Each
        flip adjusts the parent's `n_bad_kids`, which may flip the parent
        in turn — badness (and goodness) propagate along root paths only,
        so the walk is bounded by the node's depth and amortizes O(1)
        across an operation's contiguous chain of updates."""
        while node is not None and node is not self._root:
            new_ok = (node.retained and node.n_bad_kids == 0
                      and self._refcount_of(node.page) == 1)
            if new_ok == node.ok:
                break
            node.ok = new_ok
            self._n_good += 1 if new_ok else -1
            parent = node.parent
            parent.n_bad_kids += -1 if new_ok else 1
            node = parent

    def _attach(self, parent: RadixNode, child: RadixNode) -> None:
        """Insert `child` (fresh, ok=False) under `parent`, keeping the
        n_bad_kids invariant and the good-count consistent."""
        parent.children[child.edge] = child
        self._by_page[child.page] = child
        parent.n_bad_kids += 1           # fresh child starts not-ok
        self._recompute_up(child)        # may turn ok (retained donations)
        self._recompute_up(parent)       # parent may have just gone bad

    def _detach_count(self, node: RadixNode) -> None:
        """Account a node leaving the tree: drop its good-count share or
        its parent's bad-kid share (exactly one applies)."""
        if node.ok:
            self._n_good -= 1
        else:
            node.parent.n_bad_kids -= 1

    def note_refcount(self, page: int) -> None:
        """The allocator's refcount for `page` crossed the ==1 boundary
        (a sharer pinned a retained page, or the last external holder
        left).  Re-evaluates the holding node's evictability."""
        node = self._by_page.get(page)
        if node is not None:
            self._recompute_up(node)

    def _heap_push(self, node: RadixNode) -> None:
        """Push a candidate entry if `node` is currently a retained leaf.
        Called on every transition *into* candidacy (became retained,
        became a leaf) and on stamp bumps of existing candidates, so a
        retained leaf always owns an entry with its current stamp."""
        if node.retained and not node.children:
            self._heap_seq += 1
            heapq.heappush(self._heap,
                           (node.stamp, self._heap_seq, node.page))

    # ------------------------------------------------------------- lookup
    def match(self, tokens: Tokens, touch: bool = True) -> List[int]:
        """Pages covering the longest resident block-aligned prefix of
        `tokens` (the final partial block matches only an exact edge, and
        partial edges are leaves).  One dict probe per block — the
        hash-chained incremental match.  `touch=False` for pure capacity
        checks, so scheduler probing does not pollute the LRU order."""
        if not tokens:
            return []
        node, pages = self._root, []
        stamp = self._bump() if touch else None
        for edge in self._edges(tokens):
            child = node.children.get(edge)
            if child is None:
                break
            pages.append(child.page)
            if stamp is not None:
                child.stamp = stamp
                self._heap_push(child)   # re-stamped candidates re-enter
            node = child
            if len(edge) < self.page_size:
                break              # partial edges never have children
        return pages

    # ------------------------------------------------------------ publish
    def register(self, tokens: Tokens, pages: List[int]) -> None:
        """Index a live request's freshly installed pages (non-retained:
        the tree owns no refcount; the nodes die with the pages).  First
        writer wins per block; on a collision the existing node stays and
        insertion descends through it — the token path, not the physical
        page, determines content, so deeper blocks still attach soundly."""
        node = self._root
        stamp = self._bump()
        for i, edge in enumerate(self._edges(tokens)):
            if i >= len(pages) or not edge:
                break
            page = pages[i]
            child = node.children.get(edge)
            if child is None:
                if page in self._by_page:
                    break          # one page, one key — like the old index
                child = RadixNode(edge, page, node, stamp)
                self._attach(node, child)
            child.stamp = stamp
            self._heap_push(child)
            node = child
            if len(edge) < self.page_size:
                break

    def donate(self, tokens: Tokens, pages: List[int],
               free_ref: Callable[[int], None]) -> int:
        """A finished request's pages enter the tree *retained* instead of
        being freed: for each block, either the caller's refcount transfers
        to the tree (fresh node, or marking a live node retained) or it is
        released through `free_ref` (node already retained, or a collision
        with a different physical page).  Returns blocks newly retained.
        Enforces `max_cached` by LRU-evicting the overflow."""
        node = self._root
        stamp = self._bump()
        gained = 0
        blocked = False
        for i, edge in enumerate(self._edges(tokens)):
            if i >= len(pages) or not edge:
                break
            page = pages[i]
            if blocked:
                free_ref(page)
                continue
            child = node.children.get(edge)
            if child is None:
                if page in self._by_page:
                    # page already indexed under another key: cannot insert,
                    # and with no node here deeper blocks have no parent
                    free_ref(page)
                    blocked = True
                    continue
                child = RadixNode(edge, page, node, stamp)
                child.retained = True
                self._attach(node, child)
                self.n_cached += 1
                gained += 1
            elif child.page == page:
                if child.retained:
                    free_ref(page)          # tree already owns a ref
                else:
                    child.retained = True   # absorb the caller's ref
                    self.n_cached += 1
                    gained += 1
                    self._recompute_up(child)
            else:
                # collision: identical token block on a different physical
                # page — keep the resident one, release ours, but keep
                # descending (content is a function of the token path)
                free_ref(page)
            child.stamp = stamp
            self._heap_push(child)
            node = child
            if len(edge) < self.page_size:
                break
        if self.max_cached is not None:
            while self.n_cached > self.max_cached:
                if not self.evict_lru(lambda p: True, free_ref):
                    break
        return gained

    # ----------------------------------------------------------- removal
    def drop_page(self, page: int, free_ref: Callable[[int], None]) -> None:
        """The page's last external refcount just dropped: unindex its node
        and cascade through the subtree below it (now unreachable), giving
        retained descendants' refcounts back through `free_ref`."""
        node = self._by_page.get(page)
        if node is None:
            return
        assert not node.retained, (
            f"page {page} hit refcount 0 while the tree still held a ref")
        parent = node.parent
        parent.children.pop(node.edge, None)
        self._detach_count(node)
        subtree = [node]
        i = 0
        while i < len(subtree):
            subtree.extend(subtree[i].children.values())
            i += 1
        for sub in subtree:        # unindex first: free_ref may re-enter
            self._by_page.pop(sub.page, None)
        for sub in subtree[1:]:
            if sub.ok:
                self._n_good -= 1
            if sub.retained:
                sub.retained = False
                self.n_cached -= 1
                free_ref(sub.page)
        self._recompute_up(parent)
        self._heap_push(parent)    # parent may have just become a leaf

    # ---------------------------------------------------------- eviction
    def _evictable_leaf(self, sole: Callable[[int], bool],
                        exclude: FrozenSet[int]) -> Optional[RadixNode]:
        """O(tree) reference scan for the LRU evictable leaf — kept for
        invariant tests; production eviction uses the candidate heap."""
        best: Optional[RadixNode] = None
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
                continue
            if (node.retained and node.page not in exclude
                    and sole(node.page)
                    and (best is None or node.stamp < best.stamp)):
                best = node
        return best

    def evict_lru(self, sole: Callable[[int], bool],
                  free_ref: Callable[[int], None],
                  exclude: FrozenSet[int] = frozenset()) -> bool:
        """Evict the least-recently-used evictable leaf: retained, no
        children, and `sole(page)` (nobody but the tree holds it).  Gives
        the tree's refcount back through `free_ref` — which returns the
        page to the allocator's free list.  False when nothing is
        evictable.

        The victim comes off the stamp-ordered candidate heap: stale
        entries (node gone, grew children, or re-stamped) are discarded —
        a fresh entry was pushed at each of those transitions — while
        structurally valid candidates failing only this call's
        `sole`/`exclude` predicate are set aside and re-pushed, since
        they remain candidates for later calls."""
        victim: Optional[RadixNode] = None
        aside: List[Tuple[int, int, int]] = []
        while self._heap:
            entry = heapq.heappop(self._heap)
            stamp, _, page = entry
            node = self._by_page.get(page)
            if (node is None or not node.retained or node.children
                    or node.stamp != stamp):
                continue               # stale: candidacy re-pushed elsewhere
            if page in exclude or not sole(page):
                aside.append(entry)    # still a candidate for later calls
                continue
            victim = node
            break
        for entry in aside:
            heapq.heappush(self._heap, entry)
        if victim is None:
            return False
        parent = victim.parent
        parent.children.pop(victim.edge, None)
        self._by_page.pop(victim.page, None)
        self._detach_count(victim)
        victim.retained = False
        self.n_cached -= 1
        self.evictions += 1
        self._recompute_up(parent)
        self._heap_push(parent)        # parent may have just become a leaf
        free_ref(victim.page)
        return True

    def evictable_count(self, exclude: FrozenSet[int] = frozenset()) -> int:
        """How many pages on-demand eviction could actually free right now
        — the incremental good-node count, adjusted for this call's
        `exclude` set.  Exact: the admission path uses this, and an
        optimistic count would let `can_admit` promise pages `evict_lru`
        cannot deliver, livelocking the engine's requeue loop.

        Goodness is downward-closed (a good node's subtree is all good)
        and badness upward-closed, so excluding a page can only strike its
        node and that node's currently-good ancestors — O(chain depth)
        with a visited set, and `exclude` sets are match-prefix root
        chains on the hot path."""
        if not exclude:
            return self._n_good
        n = self._n_good
        seen = set()
        for page in exclude:
            node = self._by_page.get(page)
            while (node is not None and node is not self._root
                   and node.ok and id(node) not in seen):
                seen.add(id(node))
                n -= 1
                node = node.parent
        return n

    def evictable_walk(self, sole: Callable[[int], bool],
                       exclude: FrozenSet[int] = frozenset()) -> int:
        """O(tree) reference implementation of `evictable_count`: the
        maximal set S where a node is in S iff it is retained, solely
        tree-held, not excluded, and its whole subtree is in S (children
        must go before parents).  Kept for the invariant tests to assert
        the incremental bookkeeping never drifts.  Iterative (pre-order
        collect, reverse for children-before-parents) — a long retained
        conversation is one linear chain deep enough to blow the
        recursion limit."""
        order: List[RadixNode] = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            order.append(node)
            stack.extend(node.children.values())
        ok: Dict[int, bool] = {}
        total = 0
        for node in reversed(order):
            self_ok = (node.retained and node.page not in exclude
                       and sole(node.page)
                       and all(ok[id(c)] for c in node.children.values()))
            ok[id(node)] = self_ok
            if self_ok:
                total += 1
        return total

    # Back-compat alias: the O(tree) walk under its original name.
    evictable = evictable_walk
