"""Disaggregated prefill/decode serving: role-split replicas with a KV
handoff over the tiered pool (port of ``llm_in_practise_tpu/serve/disagg.py``).

The reference platform's llm-d stage splits serving into a **prefill
pool** and a **decode pool**: prefill is compute-bound, decode is
bandwidth-bound, and a long prompt's prefill on a shared engine stalls
every decoding slot beside it.

- A **prefill replica** (``role="prefill"``, the CLI's ``--role prefill``)
  prefills only. When a request carrying a handoff id finishes its
  prefill, its prompt KV and last-position logits are published as a
  :class:`~.kv_pool.HostEntry` into a handoff store, pinned until claimed
  (TTL-reclaimed if no decode replica comes), and the request finishes
  with ``finish_reason="handoff"`` (``"handoff_failed"`` when the publish
  failed).
- A **decode replica** (``role="decode"``) claims the entry and admits the
  request as a full prefix hit: the slot starts at the prompt's length,
  so no decode block shares a dispatch with a prefill chunk. A lost or
  mismatched entry re-prefills locally, counted (``local_prefills``).

The stores: :class:`LocalHandoff` (in process) and :class:`RemoteHandoff`
(a shared :class:`~.kv_pool.KVPoolServer`), both with ``publish`` /
``claim`` and the same lost-entry semantics.
"""

from __future__ import annotations

import logging
import struct
import threading
import time
import uuid

from llm_in_practise_tpu_torch.serve.kv_pool import (
    HandoffRejected,
    HostEntry,
    RemoteKVClient,
)

_log = logging.getLogger(__name__)

ROLES = ("prefill", "decode", "both")

#: reserved namespace prefix of handoff entries on a shared pool server:
#: they never collide with the model's prefix-cache namespace (a handoff
#: entry is pinned and claimed once, a prefix entry is LRU'd and shared)
HANDOFF_NS_PREFIX = "__handoff__/"


def new_handoff_id() -> str:
    return uuid.uuid4().hex


def validate_roles(role: str) -> str:
    if role not in ROLES:
        raise ValueError(f"role must be one of {ROLES}, got {role!r}")
    return role


#: ngram proposal length of a decode replica by default: decode is
#: bandwidth-bound, a decode replica never prefills by design, and the
#: fused spec round is lossless under greedy, so speculation is on there
#: unless the operator turns it off
DECODE_DEFAULT_SPEC_K = 4


def default_speculative_k(role: str, requested: int | None) -> int | None:
    """Resolve the serving CLI's ``--speculative`` value for ``role``: an
    explicit 0 turns speculation off, ``--role decode`` defaults it on
    (:data:`DECODE_DEFAULT_SPEC_K`, the ngram proposer), any positive
    value passes through, and other roles keep it opt-in."""
    if requested == 0:
        return None
    if requested is None and role == "decode":
        return DECODE_DEFAULT_SPEC_K
    return requested


class LocalHandoff:
    """In-process handoff store: pin-until-claimed with TTL reclaim, the
    pool server's handoff semantics without a socket (tests, several
    engines in one process)."""

    def __init__(self, *, ttl_s: float = 120.0, clock=None):
        self.ttl_s = ttl_s
        self._clock = clock or time.monotonic
        self._entries: dict[str, tuple[float, HostEntry]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.published = 0
        self.claimed = 0
        self.expired = 0

    def _sweep_locked(self, now: float) -> None:
        dead = [k for k, (exp, _) in self._entries.items() if exp <= now]
        for k in dead:
            del self._entries[k]
            self.expired += 1

    def publish(self, handoff_id: str, host: HostEntry) -> None:
        now = self._clock()
        with self._lock:
            self._sweep_locked(now)
            self._entries[handoff_id] = (now + self.ttl_s, host)
            self.published += 1

    def claim(self, handoff_id: str) -> HostEntry | None:
        now = self._clock()
        with self._lock:
            self._sweep_locked(now)
            found = self._entries.pop(handoff_id, None)
            if found is None:
                return None
            self.claimed += 1
            return found[1]

    def pending(self) -> int:
        with self._lock:
            return len(self._entries)


class RemoteHandoff:
    """Handoff store over a shared :class:`~.kv_pool.KVPoolServer`.

    ``namespace`` is the served model's identity (the string its
    :class:`~.kv_pool.RemoteKVClient` uses); handoff keys get the
    reserved ``__handoff__/`` prefix on top, so one model's prefix and
    handoff traffic never collide and two models' handoffs stay apart."""

    def __init__(self, address, *, namespace: str = "",
                 timeout: float = 5.0):
        self._client = RemoteKVClient(
            tuple(address), timeout=timeout,
            namespace=HANDOFF_NS_PREFIX + namespace)
        # publishes run on the engine's publisher threads and claims on
        # concurrent HTTP handler threads
        self._lock = threading.Lock()
        self.published = 0        # guarded-by: _lock
        self.publish_errors = 0   # guarded-by: _lock
        self.claimed = 0          # guarded-by: _lock
        self.claim_errors = 0     # guarded-by: _lock

    @property
    def address(self):
        return self._client.address

    def publish(self, handoff_id: str, host: HostEntry) -> None:
        """Raises on a transport fault or a pool refusal: the caller is
        about to advertise this id to a decode replica, so a silent drop
        would be a certain lost claim later."""
        try:
            self._client.handoff_put(handoff_id, host)
        except (OSError, HandoffRejected):
            with self._lock:
                self.publish_errors += 1
            raise
        with self._lock:
            self.published += 1

    def claim(self, handoff_id: str) -> HostEntry | None:
        """None = lost (expired, never published, already claimed, pool
        unreachable or reply undecodable): the caller re-prefills. A
        transport or decode fault degrades the request, it never fails
        it."""
        try:
            host = self._client.handoff_claim(handoff_id)
        except (OSError, ValueError, KeyError, struct.error) as e:
            with self._lock:
                self.claim_errors += 1
            _log.warning("handoff claim %s failed (%s: %s); degrading to "
                         "a local prefill", handoff_id, type(e).__name__, e)
            return None
        if host is not None:
            with self._lock:
                self.claimed += 1
        return host


def _row_shapes(engine) -> dict:
    """{key: (n_kv_head, head_dim)} of one KV row of ``engine``'s cache."""
    if engine.paged is not None:
        return {k: tuple(engine.paged.kv[0][k].shape[1:])
                for k in engine.paged.keys}
    return {k: tuple(v.shape[2:]) for k, v in engine.cache[0].items()
            if k != "index"}


def usable_for_engine(host: HostEntry, prompt_ids, engine) -> str | None:
    """Why a claimed handoff entry can NOT seed ``engine``'s slot for
    ``prompt_ids``, or None when it can. A mismatched entry (replicas
    configured apart, a tokenizer drift) degrades to a local prefill
    instead of scattering garbage KV.

    The JAX checks: the full prompt's length and the slot axis. The JAX
    contiguous consumer also bounds the entry's pow2-padded width by
    ``cache_len`` (``effective_bucket``); the port's consumers copy only
    the first ``length`` rows, so the width is bounded by the rows it
    must hold instead. Where JAX crashes on rows of another shape, the
    port checks the layer count and each row's shape, so such an entry is
    rejected (ROADMAP.md §C)."""
    plen = len(prompt_ids)
    if host.length != plen:
        return (f"length mismatch: entry {host.length} vs prompt {plen} "
                "(tokenizer/crop drift between replicas?)")
    if getattr(host, "slot_axis", 0) != 0:
        return (f"cache layout mismatch: entry slot_axis "
                f"{getattr(host, 'slot_axis', 0)} vs engine 0")
    if host.last_logits is None:
        return "entry carries no last-position logits"
    return rows_mismatch(host, engine)


def rows_mismatch(host, engine) -> str | None:
    """Why ``host``'s rows cannot fill ``engine``'s cache for its first
    ``host.length`` positions (layers, keys, row shape, width), or None."""
    n_layers = (engine.paged.n_layers if engine.paged is not None
                else len(engine.cache))
    if len(host.rows) != n_layers:
        return (f"entry has {len(host.rows)} layers, engine {n_layers}")
    shapes = _row_shapes(engine)
    for i, layer in enumerate(host.rows):
        if set(layer) != set(shapes):
            return f"layer {i} keys {sorted(layer)} vs {sorted(shapes)}"
        for k, t in layer.items():
            if (t.dim() != 4 or t.shape[0] != 1
                    or tuple(t.shape[2:]) != shapes[k]
                    or t.shape[1] < host.length):
                return (f"layer {i} {k} shape {tuple(t.shape)} cannot hold "
                        f"{host.length} rows of {shapes[k]}")
    return None
