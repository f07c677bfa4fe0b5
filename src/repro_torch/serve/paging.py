"""Block-paged KV memory for the serve loop (a copy of
``repro/serve/paging.py``: the port imports nothing of ``repro``, and
tests/test_torch_paging.py holds the two copies to the same tables,
refcounts and plans).

Pure-host bookkeeping on numpy — no tensor is touched here.  Three
layers:

``PagePool``
    refcounted allocator over a fixed pool of KV pages.  Page 0 is
    reserved as the *sink*: free slots and slots still mid-prefill keep
    their device page-table rows pointed at it, so the junk K/V writes a
    decode burst makes through those rows land somewhere harmless.

``PrefixCache``
    content-hash prefix cache.  Each cached entry maps the hash of a
    prompt's *leading i pages worth of tokens* to the physical page that
    holds positions ``[i*ps, (i+1)*ps)``.  Keys are cumulative (the key
    for page i hashes tokens ``[0, min((i+1)*ps, plen))``), so a match is
    a chain walk from page 0 and two different histories can never alias
    a page.  Partial tail pages are cached too — an identical re-prompt
    shares them copy-on-write.

``PagedKV``
    per-slot page tables on top of the pool + cache: admission planning
    (how many fresh pages, which shared pages, which copy-on-write),
    release, and the masked int32 table rows the device cache consumes.

Every invariant here (no double-allocation, freed pages return,
referenced shared pages never reclaimed) is asserted in
``tests/test_torch_paging.py``.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: physical page 0 is never allocated; masked page-table rows point here
SINK_PAGE = 0


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class PagePool:
    """Refcounted fixed-size page allocator (host-side, deterministic).

    Pages are handed out lowest-index-first so repeated runs produce
    identical tables.  ``alloc`` gives refcount 1; ``ref`` pins a page a
    second consumer (a prefix-cache entry, a sharing slot) also holds;
    ``free`` drops one reference and returns the page to the free list
    only when nobody holds it.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is the "
                             f"reserved sink), got {n_pages}")
        self.n_pages = int(n_pages)
        self._ref = [0] * self.n_pages
        self._free: List[int] = list(range(1, self.n_pages))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - 1 - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("PagePool exhausted")
        page = self._free.pop(0)
        self._ref[page] = 1
        return page

    def ref(self, page: int) -> None:
        if page == SINK_PAGE or self._ref[page] <= 0:
            raise ValueError(f"ref of unallocated page {page}")
        self._ref[page] += 1

    def free(self, page: int) -> None:
        if page == SINK_PAGE or self._ref[page] <= 0:
            raise ValueError(f"free of unallocated page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            bisect.insort(self._free, page)


class PrefixCache:
    """Content-hash map from prompt prefixes to shared physical pages.

    ``match`` walks the chain page by page and returns the longest run
    of cached pages whose cumulative token hash agrees with the new
    prompt.  ``register`` inserts a finished prompt's pages (bumping
    their refcount so slot release can't reclaim them).  ``evict``
    drops least-recently-used entries whose page nobody else references
    — deepest pages first, so a chain never loses a shallow link while a
    deeper link stays cached (an entry whose chain head is gone can
    never match again, yet would keep its page refcounted forever).

    Every key touched by one match/register walk gets the SAME lru
    stamp: a walk always starts at the chain head, so within a chain a
    deeper entry is never newer than a shallower one, and the
    deepest-first (``-tokens``) tie-break decides eviction order inside
    a walk.
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._page: Dict[bytes, int] = {}       # key -> physical page
        self._tokens: Dict[bytes, int] = {}     # key -> tokens covered
        self._used: Dict[bytes, int] = {}       # key -> lru clock
        self._clock = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._page)

    def _key(self, tokens: np.ndarray, n: int) -> bytes:
        return hashlib.blake2b(
            np.ascontiguousarray(tokens[:n], dtype=np.int32).tobytes(),
            digest_size=16).digest()

    def match(self, tokens: Sequence[int],
              peek: bool = False) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: (pages, tokens covered).

        ``peek`` skips the hit/miss counters and LRU touch (used by
        admission-feasibility checks that may run before the real
        admit)."""
        toks = np.asarray(tokens, dtype=np.int32)
        plen = len(toks)
        ps = self.page_size
        pages: List[int] = []
        covered = 0
        if not peek:
            self._clock += 1            # one stamp for the whole walk
        for i in range(_ceil_div(plen, ps)):
            n = min((i + 1) * ps, plen)
            key = self._key(toks, n)
            if key not in self._page:
                break
            pages.append(self._page[key])
            covered = n
            if not peek:
                self._used[key] = self._clock
        if not peek:
            if covered > 0:
                self.hits += 1
            else:
                self.misses += 1
        return pages, covered

    def register(self, tokens: Sequence[int], pages: Sequence[int],
                 pool: PagePool) -> int:
        """Cache ``pages`` as the prefix chain for ``tokens``; returns
        how many new entries were inserted (already-cached prefixes are
        left alone, so a re-registered prompt is a no-op — but the whole
        chain is LRU-stamped, so extending a chain never leaves its head
        older than the new deeper links)."""
        toks = np.asarray(tokens, dtype=np.int32)
        plen = len(toks)
        ps = self.page_size
        added = 0
        self._clock += 1                # one stamp for the whole walk
        for i, page in enumerate(pages):
            n = min((i + 1) * ps, plen)
            key = self._key(toks, n)
            if key not in self._page:
                pool.ref(page)
                self._page[key] = page
                self._tokens[key] = n
                added += 1
            self._used[key] = self._clock
        return added

    def evict(self, pool: PagePool, n_pages: int) -> int:
        """Drop up to ``n_pages`` cache-only entries (page refcount 1 —
        no slot maps them), oldest first and deepest-chain first within
        an age; returns how many pages were actually freed."""
        victims = sorted(
            (key for key, page in self._page.items()
             if pool.refcount(page) == 1),
            key=lambda k: (self._used[k], -self._tokens[k]))
        freed = 0
        for key in victims:
            if freed >= n_pages:
                break
            pool.free(self._page.pop(key))
            self._tokens.pop(key)
            self._used.pop(key)
            freed += 1
        return freed

    def drop_all(self, pool: PagePool) -> int:
        """Release every entry (shutdown / reset path)."""
        n = 0
        for key, page in list(self._page.items()):
            pool.free(page)
            del self._page[key], self._tokens[key], self._used[key]
            n += 1
        return n


@dataclasses.dataclass(frozen=True)
class AdmitPlan:
    """What an admission decided: how much of the prompt rides on shared
    pages, and which page must be copy-on-write duplicated because the
    slot will write into it (the recomputed last prompt token or the
    first divergent append lands mid-page)."""
    shared_tokens: int            # prompt positions served from cache
    cow_src: Tuple[int, ...]      # pages to copy from ...
    cow_dst: Tuple[int, ...]      # ... into these freshly-owned pages
    n_pages: int                  # total pages mapped for the slot
    prefix_hit: bool


class PagedKV:
    """Slot-granular view over one PagePool: page tables + admission.

    The engine owns one of these per cache.  All methods are host-only;
    the device sees the tables through :meth:`table_row` /
    :meth:`masked_tables`.
    """

    def __init__(self, n_slots: int, n_pages: int, page_size: int,
                 max_pages: int, prefix_cache: bool = True):
        self.n_slots = int(n_slots)
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        self.pool = PagePool(n_pages)
        self.prefix: Optional[PrefixCache] = \
            PrefixCache(page_size) if prefix_cache else None
        self.tables: List[List[int]] = [[] for _ in range(self.n_slots)]

    # -- capacity -----------------------------------------------------
    def total_pages(self, need_tokens: int) -> int:
        return _ceil_div(need_tokens, self.page_size)

    def pages_needed(self, tokens: Sequence[int],
                     need_tokens: int) -> int:
        """Fresh pages an admission would pull from the pool (shared
        full pages ride on the prefix cache; a copy-on-write dst counts
        as fresh)."""
        total = self.total_pages(need_tokens)
        if self.prefix is None or len(tokens) <= 1:
            return total
        _, matched = self.prefix.match(tokens, peek=True)
        shared = min(matched, len(tokens) - 1)
        return total - shared // self.page_size

    def can_admit(self, tokens: Sequence[int],
                  need_tokens: int) -> bool:
        return self.pages_needed(tokens, need_tokens) <= self.pool.n_free

    def try_reclaim(self, tokens: Sequence[int],
                    need_tokens: int) -> bool:
        """Evict cache-only prefix pages until the admission fits;
        returns whether it now fits."""
        if self.prefix is not None:
            short = self.pages_needed(tokens, need_tokens) \
                - self.pool.n_free
            if short > 0:
                self.prefix.evict(self.pool, short)
        return self.can_admit(tokens, need_tokens)

    # -- admission / release ------------------------------------------
    def admit(self, slot: int, tokens: Sequence[int],
              need_tokens: int) -> AdmitPlan:
        """Map pages for a request needing ``need_tokens`` cache rows.

        Shared full prefix pages are referenced in place; if the first
        position this slot will write falls inside a cached page, that
        page is duplicated (COW) so the shared copy stays read-only.
        The caller must have checked :meth:`can_admit`."""
        if self.tables[slot]:
            raise ValueError(f"slot {slot} already mapped")
        ps = self.page_size
        total = self.total_pages(need_tokens)
        if total > self.max_pages:
            raise ValueError(f"request needs {total} pages > max_pages "
                             f"{self.max_pages}")
        shared = 0
        mapped: List[int] = []
        cow_src: List[int] = []
        cow_dst: List[int] = []
        hit = False
        if self.prefix is not None and len(tokens) > 1:
            pages, matched = self.prefix.match(tokens)
            # always recompute >=1 prompt token so admission still
            # produces the first-token logits
            shared = min(matched, len(tokens) - 1)
            hit = shared > 0
            n_full = shared // ps
            for page in pages[:n_full]:
                self.pool.ref(page)
                mapped.append(page)
            if shared % ps:
                # position `shared` lands mid-page: duplicate the cached
                # page so this slot's writes don't touch the shared copy
                src = pages[n_full]
                dst = self.pool.alloc()
                cow_src.append(src)
                cow_dst.append(dst)
                mapped.append(dst)
        while len(mapped) < total:
            mapped.append(self.pool.alloc())
        self.tables[slot] = mapped
        return AdmitPlan(shared_tokens=shared, cow_src=tuple(cow_src),
                         cow_dst=tuple(cow_dst), n_pages=total,
                         prefix_hit=hit)

    def register_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """After a slot's prompt is fully written, publish its pages
        (including a partial tail page) to the prefix cache."""
        if self.prefix is None:
            return 0
        n = _ceil_div(len(tokens), self.page_size)
        return self.prefix.register(tokens, self.tables[slot][:n],
                                    self.pool)

    def release(self, slot: int) -> None:
        for page in self.tables[slot]:
            self.pool.free(page)
        self.tables[slot] = []

    # -- device view --------------------------------------------------
    def table_row(self, slot: int) -> np.ndarray:
        """This slot's true table, sink-padded to ``max_pages``."""
        row = np.full((self.max_pages,), SINK_PAGE, dtype=np.int32)
        pages = self.tables[slot]
        row[:len(pages)] = pages
        return row

    def masked_tables(self, live_slots: Sequence[int]) -> np.ndarray:
        """(n_slots, max_pages) device tables: rows for slots not in
        ``live_slots`` are all-sink, so decode writes through them land
        in the sink page instead of someone's real KV."""
        out = np.full((self.n_slots, self.max_pages), SINK_PAGE,
                      dtype=np.int32)
        for slot in live_slots:
            out[slot] = self.table_row(slot)
        return out
