"""Paged KV-cache page pool: fixed-size pages, per-slot block tables.

The port's copy of ``repro.serving.kv_pool``: ``KVPool``, ``PrefixHit`` and
``pages_for`` are the reference's pure-Python bookkeeping, line for line;
``logical_to_physical`` is rewritten on torch tensors.

Layout
------
The decode cache for full-attention segments is one **pooled** array per
segment, ``(n_layers, P, page_size, KV, hd)``: ``P = num_pages + 1`` physical
pages shared by every lane of the decode batch.  Physical page **0 is the
null page** — the allocator never hands it out; block-table entries of ``-1``
are clamped onto it so eager speculative writes from dead/retired lanes land
somewhere harmless (null-page contents are garbage by construction and are
always masked out of attention by position validity).

Each lane owns a **block-table row** ``tbl[slot, :max_pages]`` (int32,
``-1`` = unmapped): logical token position ``t`` of that lane lives at
physical slot ``tbl[slot, t // page_size] * page_size + t % page_size``.
The block table itself is a device array inside the cache pytree (it is
read by every decode step); *ownership* — which physical pages belong to
which request, the free list, refcounts, the prefix index, watermarks —
lives host-side in ``KVPool``, which is pure Python bookkeeping and never
touches device memory.

Rollback rule
-------------
Speculative writes are eager: a block-step writes K+1 tokens at positions
``len .. len+K`` before verification.  Rejected tokens are rolled back by
**truncating the lane length only** (``commit_cache`` advances ``lengths``
by the accepted count) — no page is copied, freed, or zeroed; the stale
slots are overwritten by the next block's eager writes and are excluded
from attention by the ``pos <= qpos`` mask meanwhile.  Pages return to the
pool only on retirement / preemption (``KVPool.free``).

Adaptive speculation depth (ROADMAP: adaptive-depth contract) changes how
MANY eager writes a block makes — a lane at depth ``k`` writes ``k+1``
tokens — but not this rule: provisioning math splits into
**reservation-class** decisions (admission gating, prompt trim,
watermarks), which assume the worst-case depth ``k_max`` so a lane can
never be admitted into a pool that couldn't survive it drafting deep, and
**growth-class** decisions (per-superstep page growth), which use the
lane's live depth plus the controller's cooldown-derived rise bound.  A
lane that throttles below its provisioned depth may still eagerly write
up to the dispatch depth ``K_blk``; those surplus writes land inside the
lane's provisioned pages (or on the null page past the table) and are the
same rejected-draft garbage this section already covers — never committed,
never attended.

Prefix sharing (refcounts / COW / eviction)
-------------------------------------------
Prompt-prefix pages are content-addressed and shareable:

* **Refcounts.**  Every live page carries a refcount = the number of
  owners whose block tables map it.  ``alloc`` grants pages at refcount 1;
  ``acquire_prefix`` increments the count of each matched page while
  splicing it into the new owner's page list; ``free(owner)`` becomes a
  refcount *decrement* — a page leaves live use only when its last owner
  releases it.
* **Content index.**  ``publish_prefix(owner, tokens)`` registers the
  owner's page-aligned prompt prefix in a hash-chain index keyed on
  ``(parent_page_id, page_tokens)`` — parent 0 is the chain root, and the
  exact token tuple in the key means a hit is an exact content match (no
  hash collisions, ever).  A trailing partial page (fewer than
  ``page_size`` prompt tokens) is indexed separately per parent so it can
  seed copy-on-write.
* **Sharing is safe by construction.**  Shared pages hold strictly
  prompt-prefix tokens, committed before any speculation starts; eager
  speculative writes land only at positions >= the committed length, so a
  published FULL page is never mutated while shared.  A published partial
  page may keep growing past its indexed tokens (the donor appends
  generated tokens), but the indexed prefix slots themselves are
  append-frozen — which is why partial pages are never refcount-shared,
  only used as **copy-on-write sources**: the consumer copies the page
  device-side into a fresh exclusively-owned page before appending
  (slots past the matched prefix are garbage, overwritten by the
  consumer's own tail prefill exactly like uninitialized pool slots).
* **Eviction.**  When a published page's refcount drops to 0 it is NOT
  returned to the free list: it parks in an LRU set of evictable cached
  pages, still indexed, still hittable.  Evictable pages count as free
  for every admission/watermark decision (``can_alloc`` /
  ``available_pages``) but are reclaimed lazily: ``alloc`` evicts
  oldest-first only when the strictly-free list cannot cover the grant,
  dropping the page's index entry — and, for full pages, every descendant
  key in its subtree (child keys embed the parent's page id, which may be
  recycled; a stale child key would splice KV computed under a different
  prefix) — as it goes.  Reclaiming is pure host
  bookkeeping — page contents are never zeroed, and correctness never
  depends on them (an evicted page is unreachable from the index).

Invariants (checked by the property tests in tests/test_paged_kv.py and
tests/test_prefix_cache.py)
-------------------------------------------------------------------
* ``free_pages + cached_pages + live_pages == num_pages`` at every step,
* a live page's refcount equals the number of owners whose page list
  contains it; a page is in at most one owner's list once,
* indexed pages are always live or cached — never on the free list,
* ``alloc`` is all-or-nothing (no partial grants),
* double-``free`` and foreign-page frees raise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold `tokens` cache slots (ceil division, min 1)."""
    return max(1, -(-tokens // page_size))


def logical_to_physical(tbl: torch.Tensor, pos: torch.Tensor, page_size: int):
    """THE addressing rule: map logical token positions to physical pool
    slots through a block table.  tbl (..., MPS) int32 (-1 = unmapped);
    pos (..., L) integer logical positions with matching leading dims.
    Returns (page, phys): the owning page id per position (-1 where
    unmapped or beyond the table, int32) and the flat physical slot index
    (int64), with invalid positions clamped onto the null page 0.  This one
    function is shared by the paged write, the slot splice and the kernel's
    plain version, so the layout can never silently diverge."""
    mps = tbl.shape[-1]
    pos = pos.long()
    pidx = torch.div(pos, page_size, rounding_mode="floor")
    page = torch.where(pidx < mps, torch.gather(tbl, -1, pidx.clamp(0, mps - 1)),
                       torch.full_like(pidx, -1, dtype=tbl.dtype))
    phys = torch.where(page < 0, 0, page).long() * page_size + pos % page_size
    return page, phys


@dataclass(frozen=True)
class PrefixHit:
    """Result of ``KVPool.acquire_prefix``.

    ``pages``: shared full pages already spliced into the owner's page
    list (refcounts incremented) — ``tokens = len(pages) * page_size``
    prompt tokens are resident through them.  ``cow_page``/``cow_tokens``:
    a partially-matching cached page usable as a copy-on-write source for
    ``cow_tokens`` further tokens (0 = no partial match).  The COW source
    is NOT acquired — the caller must copy it device-side into a freshly
    allocated page before appending."""
    pages: Tuple[int, ...]
    tokens: int
    cow_page: int = 0
    cow_tokens: int = 0

    @property
    def hit_tokens(self) -> int:
        return self.tokens + self.cow_tokens


@dataclass
class KVPool:
    """Host-side free-list allocator over physical page ids ``1..num_pages``.

    Page id 0 (the null page) is reserved at construction and never
    allocated.  ``alloc`` grants the lowest-numbered free pages
    (deterministic, keeps tests reproducible); fixed-size pages mean the
    pool has no external fragmentation — the only waste is the unused tail
    of each owner's last page (see ``utilization``).  Prefix-cache state
    (refcounts, content index, LRU evictables) is documented in the module
    docstring above.
    """
    num_pages: int
    page_size: int
    _free: List[int] = field(init=False)
    _free_set: Set[int] = field(init=False)
    _owned: Dict[int, List[int]] = field(init=False, default_factory=dict)
    _ref: Dict[int, int] = field(init=False, default_factory=dict)
    # refcount-0 published pages in LRU order (dict = insertion-ordered;
    # oldest first); still indexed, still hittable, lazily reclaimed
    _cached: Dict[int, None] = field(init=False, default_factory=dict)
    # (parent_page_id, page_tokens) -> canonical page, full pages only
    _index: Dict[Tuple[int, Tuple[int, ...]], int] = field(
        init=False, default_factory=dict)
    # parent page -> {partial_tokens: page}: COW seed candidates
    _partials: Dict[int, Dict[Tuple[int, ...], int]] = field(
        init=False, default_factory=dict)
    # page -> its index key (a page carries at most one key)
    _page_key: Dict[int, tuple] = field(init=False, default_factory=dict)
    peak_used: int = field(init=False, default=0)
    alloc_calls: int = field(init=False, default=0)
    free_calls: int = field(init=False, default=0)
    failed_allocs: int = field(init=False, default=0)
    prefix_lookups: int = field(init=False, default=0)
    prefix_hits: int = field(init=False, default=0)
    prefix_misses: int = field(init=False, default=0)
    prefix_hit_tokens: int = field(init=False, default=0)
    evictions: int = field(init=False, default=0)

    def __post_init__(self):
        if self.num_pages < 1:
            raise ValueError("KVPool needs at least one allocatable page")
        if self.page_size < 1:
            raise ValueError("page_size must be positive")
        # ascending grant order: keep as a reversed stack so pop() is O(1)
        self._free = list(range(self.num_pages, 0, -1))
        self._free_set = set(self._free)

    # ---------------- capacity queries ----------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Refcount-0 published pages: evictable, lazily reclaimed."""
        return len(self._cached)

    @property
    def available_pages(self) -> int:
        """What admission math may count on: strictly free + evictable."""
        return len(self._free) + len(self._cached)

    @property
    def used_pages(self) -> int:
        """Live pages (refcount > 0); excludes evictable cached pages."""
        return self.num_pages - len(self._free) - len(self._cached)

    def pages_for(self, tokens: int) -> int:
        return pages_for(tokens, self.page_size)

    def can_alloc(self, n: int, watermark: int = 0) -> bool:
        """Would an ``alloc(n)`` succeed while keeping `watermark` pages
        available?  Evictable cached pages count as free here — they are
        reclaimable on demand — so a warm cache never blocks admission."""
        return self.available_pages - n >= watermark

    # ---------------- free-list / eviction internals ----------------

    def _push_free(self, p: int) -> None:
        self._free.append(p)
        self._free_set.add(p)

    def _pop_free(self) -> int:
        p = self._free.pop()
        self._free_set.discard(p)
        return p

    def _drop_key(self, page: int) -> None:
        key = self._page_key.pop(page, None)
        if key is None:
            return
        if key[0] == "full":
            self._index.pop(key[1], None)
            # Cascade: child keys are keyed on THIS page id.  If the id is
            # recycled and republished at another depth, a stale child key
            # would splice KV computed under a different prefix/position —
            # so the whole subtree must leave the index with its root.
            self._invalidate_children(page)
        else:
            sub = self._partials.get(key[1])
            if sub is not None:
                sub.pop(key[2], None)
                if not sub:
                    del self._partials[key[1]]

    def _invalidate_children(self, page: int) -> None:
        kids = [(k, pg) for k, pg in self._index.items() if k[0] == page]
        for k, pg in kids:
            del self._index[k]
            if self._page_key.get(pg) == ("full", k):
                del self._page_key[pg]
            self._invalidate_children(pg)
        sub = self._partials.pop(page, None)
        if sub:
            for rest, pg in sub.items():
                if self._page_key.get(pg) == ("partial", page, rest):
                    del self._page_key[pg]

    def _evict_one(self) -> int:
        """Reclaim the least-recently-used evictable page: drop its index
        entry and push it onto the free list.  Contents are NOT zeroed —
        an unindexed page is unreachable, so stale KV is as harmless as
        any other uninitialized pool slot."""
        page = next(iter(self._cached))
        del self._cached[page]
        self._drop_key(page)
        self._push_free(page)
        self.evictions += 1
        return page

    # ---------------- alloc / free ----------------

    def alloc(self, n: int, owner: int) -> Optional[List[int]]:
        """Grant `n` fresh (exclusively-owned, refcount-1) pages to `owner`
        (all-or-nothing).  Returns the page ids or None if free + evictable
        cannot satisfy the request; evictable pages are reclaimed
        oldest-first only as needed (lazy eviction)."""
        self.alloc_calls += 1
        if n < 0:
            raise ValueError("cannot allocate a negative page count")
        if n > self.available_pages:
            self.failed_allocs += 1
            return None
        while len(self._free) < n:
            self._evict_one()
        got = [self._pop_free() for _ in range(n)]
        for p in got:
            self._ref[p] = 1
        self._owned.setdefault(owner, []).extend(got)
        self.peak_used = max(self.peak_used, self.used_pages)
        return got

    def ensure(self, owner: int, pages: int) -> Optional[List[int]]:
        """Incremental provisioning: top `owner` up to `pages` total pages,
        granting only the missing delta (all-or-nothing).  Returns the NEWLY
        granted page ids ([] when the owner already holds enough) or None if
        the pool cannot satisfy the delta — the owner's existing pages are
        untouched either way.  The one growth primitive shared by decode
        page growth and chunked-prefill provisioning; growth deliberately
        ignores the ADMISSION watermark — that headroom exists precisely so
        live lanes can keep growing while admission holds back.  Shared
        prefix pages count toward the owner's total like any others."""
        need = pages - len(self._owned.get(owner, ()))
        if need <= 0:
            return []
        if need > self.available_pages:
            self.failed_allocs += 1
            return None
        return self.alloc(need, owner=owner)

    def free(self, owner: int) -> int:
        """Release ALL of `owner`'s pages (retirement or preemption):
        decrement each page's refcount; pages reaching refcount 0 return
        to the free list — unless published in the prefix index, in which
        case they park as LRU-evictable cached pages.  Returns the number
        of pages that left live use (still-shared pages are not counted)."""
        self.free_calls += 1
        pages = self._owned.pop(owner, None)
        if pages is None:
            raise KeyError(f"owner {owner} holds no pages (double free?)")
        released = 0
        for p in pages:
            if p in self._free_set:      # pragma: no cover - invariant guard
                raise RuntimeError(f"page {p} already free")
            r = self._ref[p] - 1
            if r > 0:                    # still mapped by another owner
                self._ref[p] = r
                continue
            del self._ref[p]
            if p in self._page_key:      # published: cache it, don't free it
                self._cached[p] = None   # (re)inserted at the MRU end
            else:
                self._push_free(p)
            released += 1
        return released

    def owned(self, owner: int) -> List[int]:
        return list(self._owned.get(owner, ()))

    def owners(self) -> List[int]:
        return list(self._owned)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    # ---------------- prefix cache ----------------

    def _retain(self, page: int) -> None:
        r = self._ref.get(page)
        if r is not None:
            self._ref[page] = r + 1
        else:                            # evictable -> live again
            del self._cached[page]
            self._ref[page] = 1

    def acquire_prefix(self, owner: int, tokens: Sequence[int]) -> PrefixHit:
        """Longest-cached-prefix lookup for a new owner's prompt `tokens`:
        walk the hash chain from the root over page-aligned windows,
        splicing every matched FULL page into `owner`'s page list
        (refcount +1, logical order preserved).  The remaining tail is
        probed against the parent's partial-page entries for the longest
        common prefix — returned as a COW source, NOT acquired.  `owner`
        must hold no pages yet (admission runs before any allocation)."""
        if owner in self._owned:
            raise ValueError(f"owner {owner} already holds pages — "
                             f"acquire_prefix must run before allocation")
        self.prefix_lookups += 1
        ps = self.page_size
        toks = [int(t) for t in tokens]
        parent, matched = 0, 0
        shared: List[int] = []
        while len(toks) - matched >= ps:
            page = self._index.get(
                (parent, tuple(toks[matched:matched + ps])))
            if page is None:
                break
            self._retain(page)
            shared.append(page)
            parent = page
            matched += ps
        cow_page = cow_tokens = 0
        rest = toks[matched:]
        if rest:
            for ptoks, page in (self._partials.get(parent) or {}).items():
                j = 0
                for a, b in zip(ptoks, rest):
                    if a != b:
                        break
                    j += 1
                if j > cow_tokens:
                    cow_tokens, cow_page = j, page
        if shared:
            self._owned[owner] = shared
            self.peak_used = max(self.peak_used, self.used_pages)
        if matched + cow_tokens > 0:
            self.prefix_hits += 1
            self.prefix_hit_tokens += matched + cow_tokens
        else:
            self.prefix_misses += 1
        return PrefixHit(tuple(shared), matched, cow_page, cow_tokens)

    def publish_prefix(self, owner: int, tokens: Sequence[int]) -> int:
        """Register `owner`'s prompt prefix `tokens` in the content index
        once its prefill has fully committed.  Full pages chain through the
        CANONICAL parent (an identical page published earlier wins, so
        chains stay reachable from the root); the trailing partial page (if
        any) is indexed per parent as a COW seed.  Idempotent: pages that
        are already indexed, or whose key is already canonical elsewhere,
        are skipped.  Returns the number of newly published pages."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        pages = self._owned.get(owner, ())
        parent, new, i = 0, 0, 0
        while (i + 1) * ps <= len(toks) and i < len(pages):
            key = (parent, tuple(toks[i * ps:(i + 1) * ps]))
            canon = self._index.get(key)
            if canon is None:
                page = pages[i]
                if page in self._page_key:   # pragma: no cover - one key per
                    break                    # page; stop rather than corrupt
                self._index[key] = page
                self._page_key[page] = ("full", key)
                canon = page
                new += 1
            parent = canon
            i += 1
        else:
            rest = tuple(toks[i * ps:])
            if rest and i < len(pages):
                page = pages[i]
                sub = self._partials.setdefault(parent, {})
                if rest not in sub and page not in self._page_key:
                    sub[rest] = page
                    self._page_key[page] = ("partial", parent, rest)
                    new += 1
        return new

    # ---------------- observability ----------------

    def utilization(self, live_tokens: int = -1) -> dict:
        """Pool stats.  `live_tokens` (sum of committed lane lengths) turns
        the page-internal slack into a fragmentation ratio; pass -1 to skip."""
        used = self.used_pages
        out = {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "used_pages": used,
            "free_pages": self.free_pages,
            "cached_pages": self.cached_pages,
            "available_pages": self.available_pages,
            "peak_used_pages": self.peak_used,
            "utilization": used / self.num_pages,
            "peak_utilization": self.peak_used / self.num_pages,
            "alloc_calls": self.alloc_calls,
            "free_calls": self.free_calls,
            "failed_allocs": self.failed_allocs,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_evictions": self.evictions,
            "indexed_pages": len(self._page_key),
        }
        if live_tokens >= 0:
            cap = used * self.page_size
            out["internal_fragmentation"] = (
                0.0 if cap == 0 else 1.0 - live_tokens / cap)
        return out
