"""Prefix KV caching, in the engine (port of
``llm_in_practise_tpu/serve/prefix_cache.py``).

The reference platform gets prompt-prefix reuse from vLLM's automatic
prefix caching (``--enable-prefix-caching``) and from LMCache's remote
pool. Two forms here, one per KV layout:

- :class:`PrefixCache` (contiguous layout): after a prompt prefills, its
  per-layer KV rows are copied into an LRU keyed by the token tuple. A
  new request reuses the longest cached strict prefix: the rows go into
  its slot and only the suffix prefills, at the offset cache index
  (positions and causal masking follow from the index, so the math is a
  cold prefill's). A full-prompt hit skips prefill (the stored
  last-position logits give the first token).
- :class:`PagedPrefixIndex` (paged layout): hash-per-page chains over the
  physical pages themselves, refcounted, zero copies.

:class:`PrefixLRU` is the generic store under :class:`PrefixCache`; the
host pool and the pool server of :mod:`.kv_pool` reuse it through its
eviction hook (``on_evict``), the exact-key ``peek`` and ``pop_lru``. A
contiguous engine with tiers chains an offload onto its L1's
``on_evict``. The page index's evictions under pool pressure count as
``prefix_evict`` reclaims of the HBM ledger's ``kv_pool.pages``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import OrderedDict

from llm_in_practise_tpu_torch.obs.hbm import get_ledger


@dataclasses.dataclass
class PrefixEntry:
    length: int           # true token count of the cached prefix
    bucket: int           # stored rows per layer (the prompt's width)
    rows: list            # per-layer {key: (1, bucket, ...) tensor}
    last_logits: object   # (1, vocab) logits at the final prefix position
    # the cache layout the rows were sliced from: the KV buffers' slot axis
    # (the port's caches are all slot axis 0; a JAX scan-layout engine's
    # entries, slot axis 1, reach a port engine only through a shared
    # pool, and admission filters them out)
    slot_axis: int = 0
    # page-wise entries (paged producers): rows span
    # ceil(length / page_size) * page_size positions; 0 = a row entry of
    # the prompt's width
    page_size: int = 0


class PrefixLRU:
    """Token-budget LRU keyed by exact token tuples, with
    longest-strict-prefix lookup.

    Generic over the value type: ``length_of(value)`` returns the value's
    true token count. ``on_evict(key, value)`` fires, outside the lock,
    for every budget eviction: the tiers' offload hooks attach here.
    """

    def __init__(self, *, max_tokens: int, min_prefix: int,
                 length_of=None, on_evict=None):
        self.max_tokens = max_tokens
        self.min_prefix = min_prefix
        self.on_evict = on_evict
        self._length_of = length_of or (lambda v: v.length)
        # the engine thread mutates while other threads read
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()
        self._total_tokens = 0  # guarded-by: _lock
        self.hits = 0
        self.misses = 0

    @property
    def cached_tokens(self) -> int:
        with self._lock:
            return self._total_tokens

    @property
    def n_entries(self) -> int:
        # deliberately not __len__: an empty cache must stay truthy
        with self._lock:
            return len(self._entries)

    def lookup(self, prompt_ids, usable=None):
        """Longest cached value that is a prefix of ``prompt_ids``.
        ``usable(value)`` (optional) filters candidates: the engine
        rejects prefixes whose suffix prefill would not fit the cache."""
        prompt = tuple(prompt_ids)
        with self._lock:
            best_key, best = None, None
            for key, value in self._entries.items():
                length = self._length_of(value)
                if length < self.min_prefix or length > len(prompt):
                    continue
                if best is not None and length <= self._length_of(best):
                    continue
                if prompt[:length] != key:
                    continue
                if usable is not None and not usable(value):
                    continue
                best_key, best = key, value
            if best is None:
                self.misses += 1
                return None
            self._entries.move_to_end(best_key)
            self.hits += 1
            return best

    def put(self, prompt_ids, value) -> None:
        length = self._length_of(value)
        if length < self.min_prefix:
            return
        key = tuple(prompt_ids[:length])
        evicted: list[tuple[tuple, object]] = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._total_tokens -= self._length_of(old)
            self._entries[key] = value
            self._total_tokens += length
            while (self._total_tokens > self.max_tokens
                   and len(self._entries) > 1):
                ekey, evalue = self._entries.popitem(last=False)
                self._total_tokens -= self._length_of(evalue)
                evicted.append((ekey, evalue))
        if self.on_evict is not None:
            for ekey, evalue in evicted:
                self.on_evict(ekey, evalue)

    def peek(self, key):
        """Exact-key read that leaves the LRU order alone (accounting
        hooks), or None."""
        with self._lock:
            return self._entries.get(tuple(key))

    def pop_lru(self):
        """Evict and return the least recently used ``(key, value)``, or
        None when empty. Unlike :meth:`put`'s budget loop this empties
        the store: a caller enforcing a budget of its own (bytes) owns
        the floor."""
        with self._lock:
            if not self._entries:
                return None
            key, value = self._entries.popitem(last=False)
            self._total_tokens -= self._length_of(value)
        if self.on_evict is not None:
            self.on_evict(key, value)
        return key, value

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._total_tokens = 0


class PrefixCache(PrefixLRU):
    """The contiguous engine's L1: device-tensor prefix entries + reuse
    accounting."""

    def __init__(self, *, max_tokens: int = 32768, min_prefix: int = 16,
                 on_evict=None):
        super().__init__(max_tokens=max_tokens, min_prefix=min_prefix,
                         on_evict=on_evict)
        self.full_hits = 0
        self.tokens_saved = 0

    def lookup(self, prompt_ids, usable=None) -> PrefixEntry | None:
        entry = super().lookup(prompt_ids, usable)
        if entry is not None:
            self.tokens_saved += entry.length
            if entry.length == len(prompt_ids):
                self.full_hits += 1
        return entry


@dataclasses.dataclass
class _PageEntry:
    eid: int              # this entry's chain id (children key on it)
    page: int             # physical page holding the KV rows
    parent_eid: int       # 0 = chain root


class PagedPrefixIndex:
    """Page-granular prefix sharing for ``kv_layout="paged"`` engines,
    the vLLM automatic-prefix-caching idiom at its native grain.

    Page ``i`` of a prompt is keyed by ``(parent_entry_id,
    tokens_of_page_i)``, where ``parent_entry_id`` identifies the entry
    of pages ``0..i-1``. A lookup walks the chain and returns every
    consecutively matched FULL page: a request sharing 3 of a cached
    prompt's 5 pages reuses exactly those 3 physical pages (refcounted,
    zero device copies) and prefills only the tail. Exact-token keys make
    collisions impossible.

    Copy-on-write contract: only FULL pages are indexed, a hit is capped
    at ``(len(prompt) - 1) // page_size`` pages (the last position is
    always recomputed, for its logits), so slots never write inside a
    shared page; the engine's defensive fork covers any path that would.

    Refcounts: the index holds ONE pool reference per indexed page (taken
    at :meth:`register`); every lookup hit takes one more per matched
    page for the caller. Eviction (LRU under a token budget, or on demand
    through :class:`~.paged_kv.PagePool`'s ``reclaim`` hook) drops the
    index's reference; pages still mapped by live slots survive until
    those slots release them. Evicting an entry cascades to its
    descendants: a child whose parent is gone can never match again.

    Counter names are :class:`PrefixCache`'s; ``full_hits`` counts
    maximal hits (every matchable page of the prompt matched).
    """

    def __init__(self, pool, *, max_tokens: int = 32768,
                 min_prefix: int | None = None):
        self.pool = pool
        self.page_size = pool.page_size
        self.max_tokens = max_tokens
        self.min_prefix = (min_prefix if min_prefix is not None
                           else pool.page_size)
        self._lock = threading.Lock()
        # (parent_eid, page-token tuple) -> _PageEntry, LRU-ordered
        self._entries: "OrderedDict[tuple, _PageEntry]" = OrderedDict()  # guarded-by: _lock
        self._children: dict[int, list[tuple]] = {}  # guarded-by: _lock
        self._eid = itertools.count(1)
        self.hits = 0           # guarded-by: _lock
        self.misses = 0         # guarded-by: _lock
        self.full_hits = 0      # guarded-by: _lock
        self.tokens_saved = 0   # guarded-by: _lock

    @property
    def n_entries(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def cached_tokens(self) -> int:
        with self._lock:
            return len(self._entries) * self.page_size

    def _chain_keys(self, token_ids):
        """Yield each full page's ``(page_index, tokens)`` in order."""
        P = self.page_size
        for i in range(len(token_ids) // P):
            yield i, tuple(token_ids[i * P: (i + 1) * P])

    def lookup(self, prompt_ids) -> list[int]:
        """Physical pages holding the longest indexed full-page prefix of
        ``prompt_ids`` (possibly empty). One pool reference per returned
        page is taken FOR THE CALLER: map them or release them."""
        plen = len(prompt_ids)
        # at least the last position must be recomputed for its logits
        max_pages = max(0, (plen - 1) // self.page_size)
        pages: list[int] = []
        with self._lock:
            parent = 0
            for i, toks in self._chain_keys(prompt_ids):
                if i >= max_pages:
                    break
                entry = self._entries.get((parent, toks))
                if entry is None:
                    break
                self._entries.move_to_end((parent, toks))
                pages.append(entry.page)
                parent = entry.eid
            if len(pages) * self.page_size < self.min_prefix:
                pages = []   # too short to be worth it; no refs taken
            if not pages:
                self.misses += 1
                return []
            self.hits += 1
            if len(pages) == max_pages:
                self.full_hits += 1
            self.tokens_saved += len(pages) * self.page_size
        self.pool.share(pages)
        return pages

    def register(self, token_ids, pages: list[int]) -> int:
        """Index every full page of ``token_ids`` whose chain position is
        not yet present; ``pages[i]`` holds positions ``[i*P, (i+1)*P)``.
        Returns how many entries were created (each pinned with one pool
        reference)."""
        if len(token_ids) < self.min_prefix:
            return 0
        new_pages: list[int] = []
        evict: list[int] = []
        with self._lock:
            parent = 0
            created = 0
            for i, toks in self._chain_keys(token_ids):
                if i >= len(pages):
                    break
                key = (parent, toks)
                entry = self._entries.get(key)
                if entry is not None:
                    # chain position already indexed (maybe by another
                    # slot's identical prefix): reuse ITS entry; the
                    # registering slot keeps its private copy
                    self._entries.move_to_end(key)
                    parent = entry.eid
                    continue
                entry = _PageEntry(eid=next(self._eid), page=int(pages[i]),
                                   parent_eid=parent)
                self._entries[key] = entry
                self._children.setdefault(parent, []).append(key)
                new_pages.append(entry.page)
                parent = entry.eid
                created += 1
            while (len(self._entries) * self.page_size > self.max_tokens
                   and len(self._entries) > 1):
                evict.extend(self._evict_lru_locked())
        if new_pages:
            self.pool.share(new_pages)
        if evict:
            self.pool.release(evict)
        return created

    def _evict_locked(self, key) -> list[int]:
        """Remove ``key`` and every descendant; returns their pages (the
        caller releases them OUTSIDE the lock). An iterative worklist:
        one long conversation indexes as one chain, deeper than Python's
        recursion limit."""
        root = self._entries.get(key)
        if root is None:
            return []
        siblings = self._children.get(root.parent_eid)
        if siblings is not None and key in siblings:
            siblings.remove(key)
        pages: list[int] = []
        work = [key]
        while work:
            entry = self._entries.pop(work.pop(), None)
            if entry is None:
                continue
            pages.append(entry.page)
            work.extend(self._children.pop(entry.eid, []))
        return pages

    def _evict_lru_locked(self) -> list[int]:
        if not self._entries:
            return []
        return self._evict_locked(next(iter(self._entries)))

    def evict_pages(self, n: int) -> int:
        """The pool's ``reclaim`` hook: drop LRU entries until ``n`` index
        references were released (their pages become allocatable once no
        slot maps them). Returns how many references were dropped."""
        dropped: list[int] = []
        with self._lock:
            while len(dropped) < n and self._entries:
                dropped.extend(self._evict_lru_locked())
        if dropped:
            get_ledger().note_reclaim("kv_pool.pages", "prefix_evict")
            self.pool.release(dropped)
        return len(dropped)

    def clear(self) -> None:
        with self._lock:
            pages = [e.page for e in self._entries.values()]
            self._entries.clear()
            self._children.clear()
        if pages:
            self.pool.release(pages)


def slice_cache_rows(prefill_cache, bucket: int) -> list:
    """The first ``bucket`` positions of each layer's KV buffers, copied
    (the per-layer index dropped: the entry carries the true length): a
    :class:`PrefixEntry`'s rows."""
    return [{k: v[:, :bucket].clone() for k, v in layer.items()
             if k != "index"}
            for layer in prefill_cache]
