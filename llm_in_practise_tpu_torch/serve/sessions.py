"""Session-native serving: server-held conversation KV and the fleet-wide
warm path (port of ``llm_in_practise_tpu/serve/sessions.py``).

Multi-turn conversations are first-class here, not an accident of the
prefix cache's LRU order:

- :class:`SessionStore` (engine side): when a turn finishes, the
  conversation's full KV pages stay **refcount-pinned** under the
  session handle instead of merely registered in the paged COW index,
  so a follow-up turn page-hits however much unrelated traffic ran in
  between. Pins are page-granular and yield to active slots under pool
  pressure (newest pages first, so the surviving pin is still a valid
  chain prefix), expire by TTL, and are never taken from a live slot
  (eviction only drops the session's own references).
- :class:`ConsistentHashRing`: sessions map to replicas by consistent
  hashing, so a replica joining or leaving remaps only ~1/N of them.
- the fleet miss path: each finished turn is also published (copy to
  the host and put, on a background thread) into the kv-pool's pinned
  handoff namespace under :func:`session_hid`, carrying its token ids on
  the wire (``HostEntry.token_ids``). When a conversation moves to
  another replica, the new owner claims the entry, validates the token
  prefix against the incoming prompt and admits it through the engine's
  partial-prefix path; a lost entry degrades to a local re-prefill
  (counted, never a 5xx).

The reference platform gets the single-replica half of this from vLLM's
automatic prefix caching and the placement half from llm-d's cache-aware
router; this module joins the two.

Lifecycle of one session (paged engine, fleet mode)::

    turn 1  replica A -> cold prefill -> finish: pages pinned under
            sid, entry published to the pool
    turn 2  A -> page-index chain hit on the pinned pages (warm TTFT);
            finish re-pins the longer chain and republishes
    A dies  the ring remaps sid to B
    turn 3  B has no pages -> claims ``session_hid(sid)`` from the pool,
            validates the token prefix, scatters the rows, prefills only
            the new turn's suffix
    idle    the TTL sweep drops the pin; the pool entry expires on its own

``attach`` reads the pool's page byte rate with a default of 0 ("book
nothing"): a store attached to a stand-in engine whose ``paged``
namespace has no ``page_bytes`` still pins, evicts and reclaims.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import queue
import threading
import time
from collections import OrderedDict

import torch

from llm_in_practise_tpu_torch.obs.hbm import get_ledger, host_entry_bytes
from llm_in_practise_tpu_torch.obs.logging import get_logger


def session_hid(session_id: str) -> str:
    """Handoff-namespace key for a client-chosen session id.

    Client ids are arbitrary strings (headers, JSON fields): hashing
    keeps the pool server's key set fixed-width and free of separator
    collisions with the ``__handoff__/`` namespace convention."""
    digest = hashlib.sha256(str(session_id).encode()).hexdigest()
    return "session-" + digest[:32]


def _ring_hash(s: str) -> int:
    """64-bit stable point on the ring (sha256-derived: ``hash()`` is
    salted per process, and every router restart must map sessions to
    the SAME replicas)."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


class ConsistentHashRing:
    """Classic consistent hashing with virtual nodes.

    Each node contributes ``vnodes`` points; a key is owned by the
    first node point after its hash (wrapping). Adding or removing one
    node moves only the keys in that node's arcs, ~1/N of the keyspace.

    Immutable after construction: a topology change builds a NEW ring,
    so reads need no synchronization.
    """

    def __init__(self, nodes, *, vnodes: int = 64):
        self.vnodes = int(vnodes)
        # preserve caller order, drop duplicates (a duplicate node would
        # double its arc share silently)
        self._nodes = list(dict.fromkeys(nodes))
        points = []
        for node in self._nodes:
            for i in range(self.vnodes):
                points.append((_ring_hash(f"{node}#{i}"), node))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._owners = [n for _, n in points]

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def nodes(self) -> list:
        return list(self._nodes)

    def owners(self, key, n: int = 1) -> list:
        """The first ``n`` DISTINCT nodes clockwise from ``key``'s
        point: ``owners(key, 2)`` is the two-choice set bounded-load
        routing overflows into; walking further is the fallback order
        when owners are cooling down."""
        if not self._hashes or n <= 0:
            return []
        start = bisect.bisect_right(self._hashes, _ring_hash(str(key)))
        out: list = []
        for j in range(len(self._owners)):
            node = self._owners[(start + j) % len(self._owners)]
            if node not in out:
                out.append(node)
                if len(out) >= n:
                    break
        return out

    def owner(self, key):
        got = self.owners(key, 1)
        return got[0] if got else None


@dataclasses.dataclass
class _Session:
    """One conversation's server-held state (all fields guarded by the
    store's lock)."""

    sid: str
    token_ids: list          # full conversation history (prompt+output)
    pages: list              # pinned physical pages (chain prefix order)
    adapter: str | None = None
    turns: int = 0
    created: float = 0.0
    last_used: float = 0.0


class SessionStore:
    """Server-held conversation KV: pin-across-turns + fleet publish.

    Attach to ONE engine (:meth:`attach`); the store chains itself into
    the page pool's ``reclaim`` hook AFTER the COW index, so under
    admission pressure cold shared prefixes go first and session pins
    yield next: active slots always win, and a session degrades to a
    shorter warm prefix instead of blocking admission. On a pool that
    counts its free pages the chain counts pages actually freed (the
    index drops references, and one to a pinned page frees nothing);
    admission finds a pin through :meth:`pinned_prefix`, whether or not
    the index still lists its pages.

    Thread contract: ``note_finish``/``take_pending`` run on the engine
    thread; ``adopt``/``known`` on HTTP handler threads; the publisher
    thread drains ``_pub_q``; ``/metrics`` and ``/debug/sessions`` read
    under the same lock. Lock order is store lock -> pool lock, never
    the reverse (the pool calls :meth:`reclaim_pages` OUTSIDE its own
    lock by the ``PagePool.reclaim`` contract).
    """

    def __init__(self, *, ttl_s: float = 600.0, max_sessions: int = 1024,
                 clock=None):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        if max_sessions < 1:
            raise ValueError(
                f"max_sessions must be >= 1, got {max_sessions}")
        self.ttl_s = float(ttl_s)
        self.max_sessions = int(max_sessions)
        self._clock = clock or time.monotonic
        self._log = get_logger("serve.sessions")
        self._lock = threading.Lock()
        # LRU-ordered by last touch (OrderedDict re-insert on finish)
        self._sessions: "OrderedDict[str, _Session]" = OrderedDict()  # guarded-by: _lock
        # fleet entries claimed for a session but not yet consumed by
        # admission (consume-once, superseded by any local finish)
        self._pending: dict = {}  # guarded-by: _lock
        # per-outcome finished turns (llm_session_turns_total{cache=…})
        self.turns_by_cache = {"hit": 0, "partial": 0, "cold": 0}  # guarded-by: _lock
        # pin-eviction events (llm_session_evictions_total{reason=…})
        self.evictions = {"ttl": 0, "pressure": 0, "capacity": 0}  # guarded-by: _lock
        # fleet-path events (llm_session_pulls_total{event=…})
        self.pulls = {"published": 0, "publish_failed": 0,
                      "claimed": 0, "lost": 0}  # guarded-by: _lock
        # engine wiring (attach): None until attached / contiguous
        self.engine = None
        self.pool = None
        self.page_size = 0
        self._page_bytes = 0  # set by attach() from the paged pool's rate
        self.handoff = None
        self._pub_q: "queue.Queue" = queue.Queue()
        self._pub_thread: threading.Thread | None = None

    # --- wiring --------------------------------------------------------------

    def attach(self, engine) -> None:
        """Bind to ``engine``: take its page pool (paged layouts) and
        handoff store, and chain the pool's reclaim hook — prior hook
        (the COW index's ``evict_pages``) first, session pins for the
        remaining shortfall."""
        self.engine = engine
        self.handoff = getattr(engine, "handoff", None)
        paged = getattr(engine, "paged", None)
        if paged is None:
            # contiguous engines: turn/TTL bookkeeping only; there are no
            # pages to pin, and warm turns come from the row-based
            # PrefixCache's LRU
            return
        self.pool = paged.pool
        self.page_size = paged.page_size
        # 0 = book nothing: a stand-in pool without a byte rate still pins
        self._page_bytes = getattr(paged, "page_bytes", 0)
        prior = self.pool.reclaim

        def _reclaim(n: int, _prior=prior) -> int:
            if getattr(self.pool, "free_pages", None) is None:
                # a pool that cannot count its free pages: the chain
                # counts references, as the JAX store does
                freed = _prior(n) if _prior is not None else 0
                if freed < n:
                    freed += self.reclaim_pages(n - freed)
                return freed
            # a real pool: count FREED pages. The index drops references,
            # and a dropped reference to a pinned page frees nothing, so
            # the index drains first and pins yield only while the
            # shortfall stands (admission never waits on a pin)
            start = self.pool.free_pages
            while self.pool.free_pages - start < n:
                short = n - (self.pool.free_pages - start)
                if _prior is not None and _prior(short) > 0:
                    continue
                if self.reclaim_pages(short) == 0:
                    break
            return self.pool.free_pages - start

        self.pool.reclaim = _reclaim

    def _book_pins(self, delta_pages: int) -> None:
        """Move ledger account ``session_pins`` by ``delta_pages`` at
        the pool's page byte rate. A VIEW account: the bytes belong to
        ``kv_pool.pages`` — this re-attributes them to the sessions
        holding the refs, it never adds to the device sum."""
        if delta_pages and self._page_bytes:
            get_ledger().book("session_pins",
                              delta_pages * self._page_bytes)

    def known(self, sid: str) -> bool:
        """Whether this replica already holds state for ``sid`` (pinned
        session or an unconsumed fleet pull) — the API layer claims
        from the pool only when this is False."""
        with self._lock:
            return sid in self._sessions or sid in self._pending

    def note_finish(self, sid: str, token_ids, pages, *,
                    adapter: str | None = None,
                    cache_outcome: str | None = None) -> None:
        """A turn of ``sid`` finished: pin ``pages`` (the conversation's
        full-page chain, still mapped by the finishing slot) under the
        session, replacing any previous pin. Runs on the engine thread
        BEFORE the slot releases its own references, so the pages can
        never hit refcount zero in between."""
        now = self._clock()
        release: list = []
        with self._lock:
            if self.pool is not None and pages:
                self.pool.share(pages)
            sess = self._sessions.pop(sid, None)
            if sess is None:
                sess = _Session(sid=sid, token_ids=[], pages=[],
                                created=now)
            release.extend(sess.pages)
            sess.token_ids = list(map(int, token_ids))
            sess.pages = list(pages)
            sess.adapter = adapter
            sess.turns += 1
            sess.last_used = now
            self._sessions[sid] = sess
            # a local finish supersedes any unconsumed fleet pull — the
            # pin is strictly fresher than the claimed entry
            self._pending.pop(sid, None)
            if cache_outcome in self.turns_by_cache:
                self.turns_by_cache[cache_outcome] += 1
            release.extend(self._enforce_locked(now))
        self._book_pins(len(pages) - len(release))
        if release and self.pool is not None:
            self.pool.release(release)

    def touch(self, sid: str) -> None:
        """Refresh ``sid``'s LRU/TTL position (a new turn arrived)."""
        now = self._clock()
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is not None:
                sess.last_used = now
                self._sessions.move_to_end(sid)

    def pinned_prefix(self, sid: str, prompt_ids,
                      adapter: str | None = None) -> list:
        """The pinned pages of ``sid`` that hold a prefix of
        ``prompt_ids`` (full pages of the longest common prefix of the
        prompt and the pinned history, the prompt's last position always
        left to recompute), with one pool reference per page taken FOR
        THE CALLER: map them or release them. Empty for another adapter's
        KV. The page index may have dropped these pages' entries under
        pressure; the pin still holds them, and this is how admission
        finds them."""
        if self.pool is None:
            return []
        P = self.page_size
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None or not sess.pages or sess.adapter != adapter:
                return []
            toks = sess.token_ids
            cap = min(len(sess.pages) * P, len(toks), len(prompt_ids) - 1)
            n = 0
            while n < cap and int(prompt_ids[n]) == toks[n]:
                n += 1
            pages = sess.pages[:n // P]
            if pages:
                self.pool.share(pages)
        return pages

    def lookup(self, sid: str) -> "_Session | None":
        """The live session record (tests/introspection; the engine's
        admission path reads pages through the COW index, not here)."""
        with self._lock:
            return self._sessions.get(sid)

    def _enforce_locked(self, now: float) -> list:
        """TTL + capacity eviction; returns the pages to release (the
        caller releases them after dropping this store's lock)."""
        release: list = []
        led = get_ledger()
        dead = [sid for sid, s in self._sessions.items()
                if s.last_used + self.ttl_s <= now]
        for sid in dead:
            release.extend(self._sessions.pop(sid).pages)
            self.evictions["ttl"] += 1
            led.note_reclaim("session_pins", "ttl")
        while len(self._sessions) > self.max_sessions:
            _, sess = self._sessions.popitem(last=False)
            release.extend(sess.pages)
            self.evictions["capacity"] += 1
            led.note_reclaim("session_pins", "capacity")
        return release

    def sweep(self) -> int:
        """Drop TTL-expired sessions now; returns how many died."""
        now = self._clock()
        with self._lock:
            before = len(self._sessions)
            release = self._enforce_locked(now)
            died = before - len(self._sessions)
        self._book_pins(-len(release))
        if release and self.pool is not None:
            self.pool.release(release)
        return died

    def reclaim_pages(self, n: int) -> int:
        """``PagePool.reclaim`` chain link: drop up to ``n`` session pin
        references, least-recently-used session first and each session's
        NEWEST pages first, so the surviving pin remains a valid chain
        prefix and the session degrades to a shorter warm prefix. Live
        slots are unaffected (only the session's own refs drop)."""
        if n <= 0:
            return 0
        released: list = []
        with self._lock:
            for sid in list(self._sessions):
                if len(released) >= n:
                    break
                sess = self._sessions[sid]
                take = min(len(sess.pages), n - len(released))
                if take <= 0:
                    continue
                released.extend(sess.pages[len(sess.pages) - take:])
                del sess.pages[len(sess.pages) - take:]
                self.evictions["pressure"] += 1
                get_ledger().note_reclaim("session_pins", "pressure")
        self._book_pins(-len(released))
        if released and self.pool is not None:
            self.pool.release(released)
        return len(released)

    def drop(self, sid: str) -> bool:
        """Forget ``sid`` entirely (client DELETE / tests)."""
        with self._lock:
            sess = self._sessions.pop(sid, None)
            self._pending.pop(sid, None)
        if sess is None:
            return False
        self._book_pins(-len(sess.pages))
        if sess.pages and self.pool is not None:
            self.pool.release(sess.pages)
        return True

    # --- fleet path ----------------------------------------------------------

    def adopt(self, sid: str, host) -> bool:
        """Take ownership of a fleet-claimed :class:`~.kv_pool.HostEntry`
        for ``sid`` (HTTP thread). The entry waits in the pending map
        until the engine's admission consumes it (:meth:`take_pending`),
        once, like the handoff claim that produced it. Entries without
        token ids cannot be prefix-validated and are counted lost."""
        if host is None or getattr(host, "token_ids", None) is None \
                or host.length <= 0:
            with self._lock:
                self.pulls["lost"] += 1
            return False
        with self._lock:
            self._pending[sid] = host
            self.pulls["claimed"] += 1
        return True

    def note_lost(self) -> None:
        """A fleet claim came back empty: the request re-prefills
        locally (the counted, never-5xx degradation)."""
        with self._lock:
            self.pulls["lost"] += 1

    def take_pending(self, sid: str, prompt_ids):
        """Consume ``sid``'s pending fleet entry, validated against the
        incoming prompt: returns ``(host, n)`` where the first ``n``
        prompt tokens match the entry's token ids (the LONGEST common
        prefix, capped at the entry's KV length), or ``None`` if
        nothing usable is pending. ``n`` can be shorter than the entry
        (an edited or forked conversation still reuses the shared head),
        but a zero-length match (a different conversation reusing the
        sid) discards the entry: scattering mismatched KV would be
        silent corruption."""
        with self._lock:
            host = self._pending.pop(sid, None)
        if host is None:
            return None
        toks = [int(t) for t in (host.token_ids or [])]
        cap = min(int(host.length), len(toks), len(prompt_ids))
        n = 0
        while n < cap and int(prompt_ids[n]) == toks[n]:
            n += 1
        if n <= 0:
            self._log.warning(
                "session %s: pulled entry shares no token prefix with "
                "the prompt; dropping it (tokenizer drift?)", sid)
            with self._lock:
                self.pulls["lost"] += 1
            return None
        return host, n

    def publish(self, sid: str, token_ids, entry, ready=None) -> None:
        """Queue a finished turn's page-aligned KV entry for the fleet
        (engine thread -> publisher thread). ``entry`` is a device
        PrefixEntry gathered into a fresh tensor while the slot still
        mapped its pages; ``ready`` (a CUDA event recorded after the
        gather, or None) is what the publisher's copy to the host waits
        on, on a stream of its own. The copy and the pool put run off the
        engine thread, as the disaggregated handoff's publishers do."""
        if self.handoff is None:
            return
        self._ensure_publisher()
        self._pub_q.put((sid, [int(t) for t in token_ids], entry, ready))

    def _ensure_publisher(self) -> None:
        if self._pub_thread is None or not self._pub_thread.is_alive():
            self._pub_thread = threading.Thread(
                target=self._run_publisher, daemon=True,
                name="session-publisher")
            self._pub_thread.start()

    def _run_publisher(self) -> None:
        from llm_in_practise_tpu_torch.serve.graphs import CAPTURE_LOCK
        from llm_in_practise_tpu_torch.serve.kv_pool import entry_to_host

        stream = None
        while True:
            item = self._pub_q.get()
            staged = 0
            try:
                if item is None:
                    return
                sid, toks, entry, ready = item
                try:
                    if ready is None:
                        host = entry_to_host(entry)
                    else:
                        # never while another thread captures a graph
                        with CAPTURE_LOCK.work():
                            if stream is None:
                                stream = torch.cuda.Stream(
                                    device=entry.rows[0]["k"].device)
                            with torch.cuda.stream(stream):
                                stream.wait_event(ready)
                                for layer in entry.rows:
                                    for t in layer.values():
                                        t.record_stream(stream)
                                host = entry_to_host(entry)
                    del entry
                    host.token_ids = toks
                    # ledger account handoff_staging (host plane): the
                    # entry's RAM until the pool put returns
                    staged = host_entry_bytes(host)
                    get_ledger().book("handoff_staging", staged)
                    self.handoff.publish(session_hid(sid), host)
                except Exception as e:  # noqa: BLE001 — a dead pool
                    # degrades THIS session's future migration, nothing
                    # else; the engine loop never notices
                    with self._lock:
                        self.pulls["publish_failed"] += 1
                    self._log.warning(
                        "session %s: fleet publish failed (%s: %s)",
                        sid, type(e).__name__, e)
                else:
                    with self._lock:
                        self.pulls["published"] += 1
            finally:
                if staged:
                    get_ledger().book("handoff_staging", -staged)
                self._pub_q.task_done()

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until every queued publish drained (a migration drill
        needs the last turn's entry in the pool before the turn moves).
        Returns False on timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._pub_q.unfinished_tasks == 0:
                return True
            time.sleep(0.01)
        return self._pub_q.unfinished_tasks == 0

    def close(self) -> None:
        """Stop the publisher and drop every pin (engine shutdown)."""
        if self._pub_thread is not None and self._pub_thread.is_alive():
            self._pub_q.put(None)
            self._pub_thread.join(timeout=5.0)
        with self._lock:
            release = [p for s in self._sessions.values() for p in s.pages]
            self._sessions.clear()
            self._pending.clear()
        self._book_pins(-len(release))
        if release and self.pool is not None:
            self.pool.release(release)

    # --- introspection -------------------------------------------------------

    @property
    def active(self) -> int:
        with self._lock:
            return len(self._sessions)

    @property
    def pinned_pages(self) -> int:
        with self._lock:
            return sum(len(s.pages) for s in self._sessions.values())

    def counters(self) -> dict:
        """Atomic snapshot for /metrics (one lock hold, no torn reads
        across families)."""
        with self._lock:
            return {
                "active": len(self._sessions),
                "pinned_pages": sum(len(s.pages)
                                    for s in self._sessions.values()),
                "turns": dict(self.turns_by_cache),
                "evictions": dict(self.evictions),
                "pulls": dict(self.pulls),
            }

    def debug_snapshot(self, limit: int = 64) -> dict:
        """The ``GET /debug/sessions`` payload."""
        now = self._clock()
        with self._lock:
            sessions = [{
                "session_id": s.sid,
                "turns": s.turns,
                "pinned_pages": len(s.pages),
                "pinned_tokens": len(s.pages) * self.page_size,
                "history_tokens": len(s.token_ids),
                "adapter": s.adapter,
                "idle_s": round(now - s.last_used, 3),
                "ttl_left_s": round(s.last_used + self.ttl_s - now, 3),
            } for s in list(self._sessions.values())[-limit:]]
            return {
                "enabled": True,
                "ttl_s": self.ttl_s,
                "max_sessions": self.max_sessions,
                "page_size": self.page_size,
                "fleet": self.handoff is not None,
                "active": len(self._sessions),
                "pending_pulls": len(self._pending),
                "pinned_pages": sum(len(s.pages)
                                    for s in self._sessions.values()),
                "turns": dict(self.turns_by_cache),
                "evictions": dict(self.evictions),
                "pulls": dict(self.pulls),
                "sessions": sessions,
            }
