"""Paged KV cache: a block-table page pool with refcounted sharing (port of
``llm_in_practise_tpu/serve/paged_kv.py``).

KV lives in fixed-size **pages** carved from one preallocated pool, and
each slot maps its logical positions to physical pages through a **block
table**: admission reserves the pages a request actually needs, decode
allocates a page at a time as the context grows, and a shared prompt
prefix is the same physical pages refcounted across requests
(copy-on-write: a write that would land in a shared page forks it
first). vLLM's PagedAttention, which the reference platform serves with.

As in the JAX package, no step body learns about pages: the pool is one
flat token-major tensor per layer and key (``(num_pages * page_size,
n_kv_head, head_dim)``, in the cache dtype, on the engine's device; here
all of them are slices of one tensor), the host builds **gather/scatter
index arrays** (numpy; only the finished arrays go to the device), and
each paged step

1. gathers every slot's pages into a transient contiguous view, one
   ``index_select`` for every layer's K and V, whose width is a power
   of two up to ``cache_len`` (one CUDA graph per width);
2. runs the unchanged step body (:mod:`.mixed_step`) on that view, which
   is what pins the paged tokens to the contiguous ones;
3. scatters each row's freshly written window back into the pool in
   place, one ``index_copy_``; discarded writes (idle rows, padding) are
   routed to the reserved **trash page** (physical page 0).

The engine holds the step bodies (:mod:`.engine`, :mod:`.graphs`); this
module is the host bookkeeping and the pool tensors. The pool tensor is
the HBM ledger's ``kv_pool.pages`` account (booked at build, freed at
:meth:`PagedKV.close`), and every gather view pulses
``transient_view`` (:meth:`PagedKV.pulse_view`).

Sharing/refcount protocol: a physical page's refcount equals the number
of slot block tables mapping it, plus one if the
:class:`~.prefix_cache.PagedPrefixIndex` holds it. Pages are freed when
the count returns to zero, never while any reader remains.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref

import numpy as np
import torch

from llm_in_practise_tpu_torch.obs.hbm import get_ledger

#: physical page 0 is never allocated: host-built scatter indices route
#: every discarded write (idle rows, padding beyond a row's valid window)
#: into it, and unmapped logical pages gather from it (those positions
#: sit beyond the row's cache index, so the causal mask never attends
#: them)
TRASH_PAGE = 0


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` KV rows (0 tokens -> 0 pages)."""
    return -(-int(n_tokens) // int(page_size))


def kv_row_bytes(model, dtype) -> int:
    """Device bytes one KV-cache row (one token position, every layer)
    costs ``model`` in ``dtype``: the exchange rate at which the engine
    expresses a draft model's contiguous cache in page-pool tokens, so a
    paged engine with a draft cannot over-admit against bytes the draft
    already holds."""
    probe = 16
    total = 0
    for layer in model.init_cache(1, probe, dtype=dtype):
        for key, buf in layer.items():
            if key != "index":
                total += (buf.numel() // probe) * buf.element_size()
    return total


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or for a float8 tensor its ``uint8`` view: gathers
    and scatters move the bytes, bit for bit, where an op has no float8
    kernel (``index_copy_``). Never a round trip through another float
    type."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8)
    return t


def gather_view(paged: "PagedKV", gidx: torch.Tensor, rows: int,
                index) -> tuple[torch.Tensor, list]:
    """Gather each row's pages into a contiguous cache view: ``gidx`` is
    the flat ``(rows * W,)`` pool-row index (:meth:`PagedKV.gather_idx`
    on the device). One ``index_select`` moves every layer's K and V.
    Returns the gathered tensor (for :func:`scatter_window`) and the
    model's cache list over it, each layer's ``index`` pinned to
    ``index``."""
    g = byte_view(paged.store).index_select(1, gidx)
    tail = tuple(paged.store.shape[2:])
    width = gidx.shape[0] // rows
    kv = g.view(paged.store.dtype)
    view = []
    for i in range(paged.n_layers):
        layer = {"index": index}
        for j, key in enumerate(paged.keys):
            layer[key] = kv[i * len(paged.keys) + j].view(
                (rows, width) + tail)
        view.append(layer)
    return g, view


def scatter_window(paged: "PagedKV", g: torch.Tensor, vidx: torch.Tensor,
                   sidx: torch.Tensor) -> None:
    """Write each row's fresh window back into the pool, in place: view
    positions ``vidx`` (flat over the gathered rows) land at pool rows
    ``sidx`` (:meth:`PagedKV.scatter_idx`; discarded positions go to the
    trash page). Bytes are moved, never converted."""
    byte_view(paged.store).index_copy_(1, sidx, g.index_select(1, vidx))


def window_idx(starts: np.ndarray, width: int, wwin: int) -> np.ndarray:
    """(rows, wwin) flat view positions of each row's write window
    ``[starts[r], starts[r] + wwin)`` in a ``(rows, width)`` view,
    clamped into the view (a clamped position is a discarded write: its
    scatter target is the trash page)."""
    rows = len(starts)
    j = np.arange(wwin)
    pos = np.clip(starts.astype(np.int64)[:, None] + j[None, :], 0,
                  width - 1)
    return np.arange(rows)[:, None] * width + pos


class PagePoolExhausted(RuntimeError):
    """Allocation failed with no reclaimable pages left."""


class PagePool:
    """Host-side accountant of the physical page pool: free list,
    per-page refcounts, and the alloc/share/release protocol.

    Purely bookkeeping: the KV bytes live in :class:`PagedKV`'s tensors;
    this class decides which pages a request may write. The engine
    thread mutates, scrape threads read: the mutating ops and the stats
    share ``_lock``.

    ``reclaim`` (optional callable ``(n_pages) -> int``) is asked to free
    at least ``n_pages`` when the free list runs dry: the engine wires
    the shared-prefix index's LRU eviction here, so cold shared prefixes
    are reclaimed before admission fails.
    """

    def __init__(self, num_pages: int, page_size: int, *, reclaim=None):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved trash "
                f"page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.reclaim = reclaim
        self._lock = threading.Lock()
        # refcount per physical page; page 0 pinned forever as trash
        self._refs = np.zeros((num_pages,), np.int32)  # guarded-by: _lock
        self._refs[TRASH_PAGE] = 1
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # guarded-by: _lock
        self.allocs = 0          # guarded-by: _lock
        self.frees = 0           # guarded-by: _lock
        self.alloc_failures = 0  # guarded-by: _lock

    # -- capacity / stats -----------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable pages (the pool minus the trash page)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages mapped by more than one reader (refcount > 1)."""
        with self._lock:
            return int(np.sum(self._refs[1:] > 1))

    def refcount(self, page: int) -> int:
        with self._lock:
            return int(self._refs[page])

    def snapshot(self) -> dict:
        """Every occupancy/sharing/churn figure under ONE lock hold, so a
        multi-field report (``/debug/kv``) cannot tear between fields."""
        with self._lock:
            refs = self._refs[1:]
            hist: dict[int, int] = {}
            for r in refs[refs > 0]:
                hist[int(r)] = hist.get(int(r), 0) + 1
            free = len(self._free)
            return {
                "capacity": self.num_pages - 1,
                "free_pages": free,
                "used_pages": self.num_pages - 1 - free,
                "shared_pages": int(np.sum(refs > 1)),
                "refcount_histogram": hist,
                "allocs": self.allocs,
                "frees": self.frees,
                "alloc_failures": self.alloc_failures,
            }

    # -- alloc / share / release ----------------------------------------------

    def try_alloc(self, n: int) -> list[int] | None:
        """``n`` fresh pages (refcount 1 each), or ``None`` when even the
        ``reclaim`` hook cannot free enough. Never raises: admission
        turns ``None`` into preemption or requeue."""
        if n <= 0:
            return []
        with self._lock:
            short = n - len(self._free)
        if short > 0 and self.reclaim is not None:
            # outside the lock: reclaim re-enters through release()
            self.reclaim(short)
        with self._lock:
            if len(self._free) < n:
                self.alloc_failures += 1
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            self.allocs += n
            return pages

    def alloc(self, n: int) -> list[int]:
        """Like :meth:`try_alloc` but raises :class:`PagePoolExhausted`."""
        pages = self.try_alloc(n)
        if pages is None:
            raise PagePoolExhausted(
                f"page pool exhausted: need {n} pages, "
                f"{self.free_pages} free of {self.capacity}")
        return pages

    def share(self, pages) -> None:
        """One more reader for each page (prefix sharing / index pin)."""
        with self._lock:
            for p in pages:
                if p == TRASH_PAGE:
                    continue
                if self._refs[p] <= 0:
                    raise ValueError(f"share of unallocated page {p}")
                self._refs[p] += 1

    def release(self, pages) -> None:
        """One fewer reader; pages whose refcount reaches 0 return to the
        free list."""
        with self._lock:
            for p in pages:
                if p == TRASH_PAGE:
                    continue
                r = int(self._refs[p]) - 1
                if r < 0:
                    raise ValueError(f"release of free page {p}")
                self._refs[p] = r
                if r == 0:
                    self._free.append(p)
                    self.frees += 1

    def check_leaks(self, expected_held: int = 0) -> None:
        """Raise unless the outstanding refs (trash page excluded) total
        ``expected_held`` and, with none held, every page is free."""
        with self._lock:
            held = int(np.sum(self._refs[1:]))
            free = len(self._free)
        if held != expected_held:
            raise AssertionError(
                f"page refcount leak: {held} refs outstanding, "
                f"expected {expected_held}")
        if expected_held == 0 and free != self.capacity:
            raise AssertionError(
                f"page leak: {self.capacity - free} pages neither free "
                "nor referenced")


@dataclasses.dataclass
class PagedHit:
    """A paged-admission prefix hit, one of two kinds:

    - ``pages``: physical pages already holding the prefix KV (the index
      lookup took one share ref per page for the caller, which the engine
      maps into the slot's block table);
    - ``entry``: a row entry instead (a kv-pool tier hit or a claimed
      handoff, a :class:`~.kv_pool.HostEntry` on the host), whose first
      ``length`` rows are scattered into the slot's pages at admission.

    ``last_logits`` rides along for a full-length entry (the first token
    samples from it). ``external`` marks a claimed handoff entry, which is
    consumed once: a dry-pool requeue puts it back on the request."""

    length: int
    pages: list[int] | None = None
    entry: object | None = None
    last_logits: object | None = None
    external: bool = False


class PagedKV:
    """Paged KV state of one engine: per-layer flat pools on the engine's
    device, per-slot block tables, and the host-side index builders the
    paged step bodies consume."""

    def __init__(self, model, *, max_slots: int, cache_len: int,
                 page_size: int, pool_tokens: int, dtype):
        self.page_size = int(page_size)
        self.cache_len = int(cache_len)
        self.max_slots = int(max_slots)
        # logical pages a single slot can ever map
        self.pages_per_slot = pages_for(cache_len, page_size)
        num_pages = pages_for(pool_tokens, page_size) + 1  # + trash page
        self.pool = PagePool(num_pages, page_size)
        # block tables: logical page -> physical page, 0 = unmapped
        self.block_tables = np.zeros(
            (max_slots, self.pages_per_slot), np.int32)
        # pages currently mapped per slot (bt[s, :n] are live)
        self.slot_pages_n = np.zeros((max_slots,), np.int32)
        # flat token-major pools, one per layer and key, index dropped
        # (every paged step pins its own index vector on the view). They
        # are slices of ONE tensor, ``store`` (layers x keys, rows, heads,
        # dim), so a step's gather and scatter are one launch each
        tpl = model.init_cache(1, self.page_size, dtype=dtype)
        self.n_layers = len(tpl)
        self.keys = tuple(k for k in tpl[0] if k != "index")
        buf = tpl[0][self.keys[0]]
        pool_rows = num_pages * self.page_size
        self.store = torch.zeros(
            (self.n_layers * len(self.keys), pool_rows)
            + tuple(buf.shape[2:]), dtype=buf.dtype, device=buf.device)
        self.kv = [{key: self.store[i * len(self.keys) + j]
                    for j, key in enumerate(self.keys)}
                   for i in range(self.n_layers)]
        # ledger account kv_pool.pages: the pool tensor is the one real
        # device allocation here; page and row rates derive from it, so
        # every page count converts to bytes the same way everywhere
        # (/debug/kv, /debug/hbm, session pins)
        self.pool_bytes = self.store.numel() * self.store.element_size()
        self.row_bytes = self.pool_bytes // pool_rows
        self.page_bytes = self.row_bytes * self.page_size
        led = get_ledger()
        led.book("kv_pool.pages", self.pool_bytes)
        # freed once: by close(), or when the pool is collected unclosed
        self._ledger_free = weakref.finalize(
            self, led.book, "kv_pool.pages", -self.pool_bytes)

    def close(self) -> None:
        """Return the pool's ledger claim (engine stop). Idempotent: a
        second stop must not free the account twice."""
        self._ledger_free()

    def view_bytes(self, width: int, n_slots: int | None = None) -> int:
        """Device bytes of one transient gather view: ``n_slots`` rows of
        ``width`` tokens at the pool's per-row rate (what a paged step
        holds next to the pool)."""
        s = self.max_slots if n_slots is None else int(n_slots)
        return int(width) * s * self.row_bytes

    def pulse_view(self, width: int, n_slots: int | None = None) -> None:
        """Pulse ledger account ``transient_view`` with one dispatch's
        gather view: the view lives only inside the dispatch, so only the
        account's high-water mark moves (the pool + view coexistence
        peak)."""
        get_ledger().pulse("transient_view", self.view_bytes(width, n_slots))

    # -- capacity -------------------------------------------------------------

    def fits_ever(self, n_tokens: int) -> bool:
        """Whether a request needing ``n_tokens`` KV rows can EVER be
        admitted (pool capacity, ignoring occupancy): the API's 422."""
        return pages_for(n_tokens, self.page_size) <= self.pool.capacity

    # -- block-table mutation (engine thread only) ----------------------------

    def map_shared(self, slot: int, pages: list[int]) -> None:
        """Start ``slot``'s table with already-incref'd shared pages."""
        n = len(pages)
        self.block_tables[slot, :n] = pages
        self.slot_pages_n[slot] = n

    def extend(self, slot: int, need_tokens: int) -> bool:
        """Grow ``slot``'s table to cover ``need_tokens`` positions; False
        when the pool (after reclaim) cannot supply the pages: the engine
        then preempts or requeues."""
        target = min(pages_for(need_tokens, self.page_size),
                     self.pages_per_slot)
        cur = int(self.slot_pages_n[slot])
        if target <= cur:
            return True
        pages = self.pool.try_alloc(target - cur)
        if pages is None:
            return False
        self.block_tables[slot, cur:target] = pages
        self.slot_pages_n[slot] = target
        return True

    def release_slot(self, slot: int) -> list[int]:
        """Drop every page mapping of ``slot`` (refcounts decremented;
        exclusively owned pages return to the free list). Returns the
        released physical pages."""
        n = int(self.slot_pages_n[slot])
        pages = [int(p) for p in self.block_tables[slot, :n]]
        self.pool.release(pages)
        self.block_tables[slot, :n] = TRASH_PAGE
        self.slot_pages_n[slot] = 0
        return pages

    def slot_pages(self, slot: int) -> list[int]:
        n = int(self.slot_pages_n[slot])
        return [int(p) for p in self.block_tables[slot, :n]]

    # -- host-side index builders --------------------------------------------

    def gather_idx(self, width: int) -> np.ndarray:
        """(max_slots, width) flat pool-row indices of the view gather:
        position ``t`` of slot ``s`` reads ``bt[s, t // P] * P + t % P``
        (unmapped pages read the trash page)."""
        P = self.page_size
        t = np.arange(width)
        lp = t // P
        return (self.block_tables[:, lp] * P
                + (t % P)[None, :]).astype(np.int32)

    def row_gather_idx(self, slot: int, width: int) -> np.ndarray:
        """(1, width) flat indices over one slot (the single-row suffix)."""
        P = self.page_size
        t = np.arange(width)
        lp = np.minimum(t // P, self.pages_per_slot - 1)
        return (self.block_tables[slot, lp] * P
                + (t % P)).astype(np.int32)[None, :]

    def entry_width(self, length: int) -> int:
        """Rows of a page-wise entry of ``length`` positions: its live
        pages, not a pow2 bucket nor ``cache_len``."""
        return pages_for(length, self.page_size) * self.page_size

    def gather_rows(self, slot: int, width: int) -> torch.Tensor:
        """A fresh ``(layers x keys, width, heads, dim)`` tensor of
        ``slot``'s first ``width`` positions, every layer's K and V in one
        ``index_select`` (a page-wise entry's rows): it owes nothing to
        the pool, whose pages may be rewritten as soon as the slot is
        released."""
        idx = torch.from_numpy(self.row_gather_idx(slot, width).reshape(-1)
                               .astype(np.int64)).to(self.store.device)
        return byte_view(self.store).index_select(1, idx).view(
            self.store.dtype)

    def scatter_rows(self, rows: torch.Tensor, slot: int,
                     length: int) -> None:
        """Write ``rows`` (``(layers x keys, >= length, heads, dim)`` in
        the pool's dtype, on its device) into ``slot``'s (reserved) pages
        at positions ``[0, length)``, in place: one ``index_copy_``."""
        sidx = self.rows_scatter_idx([slot], [length], length)
        flat = torch.from_numpy(sidx.reshape(-1).astype(np.int64)).to(
            self.store.device)
        byte_view(self.store).index_copy_(1, flat,
                                          byte_view(rows[:, :length]))

    def scatter_idx(self, starts: np.ndarray, valid: np.ndarray,
                    width: int) -> np.ndarray:
        """(max_slots, width) flat pool-row targets of the write-back of
        each row's window ``[starts[s], starts[s] + valid[s])``; positions
        at ``j >= valid[s]`` (and any unmapped page) go to the trash
        page."""
        P = self.page_size
        j = np.arange(width)
        pos = starts.astype(np.int64)[:, None] + j[None, :]
        lp = np.minimum(pos // P, self.pages_per_slot - 1)
        phys = np.take_along_axis(
            self.block_tables, lp.astype(np.int64), axis=1)
        keep = j[None, :] < valid[:, None]
        phys = np.where(keep, phys, TRASH_PAGE)
        return (phys * P + pos % P).astype(np.int32)

    def rows_scatter_idx(self, slots: list[int], lengths: list[int],
                         width: int) -> np.ndarray:
        """(B, width) flat targets of B width-wide row sets (the one-shot
        prefill): row b's positions ``[0, lengths[b])`` land in
        ``slots[b]``'s pages, padding goes to the trash page."""
        P = self.page_size
        j = np.arange(width)
        out = np.zeros((len(slots), width), np.int64)
        for b, (s, ln) in enumerate(zip(slots, lengths)):
            lp = np.minimum(j // P, self.pages_per_slot - 1)
            phys = self.block_tables[s, lp]
            phys = np.where(j < ln, phys, TRASH_PAGE)
            out[b] = phys * P + j % P
        return out.astype(np.int32)

    # -- device writes outside the step bodies --------------------------------

    def write_rows(self, cache, sidx: np.ndarray) -> None:
        """Scatter B width-wide row sets (a one-shot prefill's fresh
        cache: per layer ``(B, width, ...)``) into pages at the flat
        targets ``sidx`` (:meth:`rows_scatter_idx`), in place (JAX
        ``_paged_write_rows_fn``)."""
        rows = torch.stack([byte_view(layer[key]) for layer in cache
                            for key in self.keys])
        rows = rows.reshape((rows.shape[0], -1) + rows.shape[3:])
        flat = torch.from_numpy(sidx.reshape(-1).astype(np.int64)).to(
            self.store.device)
        byte_view(self.store).index_copy_(1, flat, rows)

    def copy_page(self, src: int, dst: int) -> None:
        """Copy one physical page's rows of every layer (the COW fork;
        JAX ``_paged_page_copy_fn``)."""
        P = self.page_size
        store = byte_view(self.store)
        store[:, dst * P:(dst + 1) * P] = store[:, src * P:(src + 1) * P]

    # -- snapshots ------------------------------------------------------------

    def debug_snapshot(self) -> dict:
        """The ``GET /debug/kv`` payload: pool occupancy, sharing and
        per-slot block-table sizes, from ONE :meth:`PagePool.snapshot`,
        with the ledger account the pool's bytes are booked under."""
        pool = self.pool.snapshot()
        mapped = int(np.sum(self.slot_pages_n))
        return {
            "layout": "paged",
            "page_size": self.page_size,
            "pages_total": pool["capacity"],
            "pages_free": pool["free_pages"],
            "pages_used": pool["used_pages"],
            "pages_shared": pool["shared_pages"],
            "pages_slot_mapped": mapped,
            "refcount_histogram": {
                str(k): v for k, v in
                sorted(pool["refcount_histogram"].items())},
            "alloc_failures": pool["alloc_failures"],
            "block_table_pages_per_slot": [
                int(n) for n in self.slot_pages_n],
            "ledger_account": "kv_pool.pages",
            "page_bytes": self.page_bytes,
            "pool_bytes": self.pool_bytes,
            "slot_mapped_bytes": mapped * self.page_bytes,
        }
