"""Tiered KV pool, the reference platform's LMCache stage (port of
``llm_in_practise_tpu/serve/kv_pool.py``).

The reference extends vLLM's in-HBM prefix cache with LMCache: KV blocks
stream to CPU memory and to a remote ``lm://`` pool server, so a prefix
computed by one replica warms every other replica. The same three tiers
over the engine's prefix entries:

- **L1**: the engine's :class:`~.prefix_cache.PrefixCache` (device rows)
  or, in the paged layout, its page index.
- **L2**: :class:`HostKVPool`, the same entries as CPU tensors; the
  budget is host RAM. Entries arrive by write-through at prefill and by
  eviction from a contiguous L1; a lookup copies them back to the card
  and promotes them into L1.
- **L3**: :class:`KVPoolServer` / :class:`RemoteKVClient`, a stdlib TCP
  pool server holding serialized entries, so several replicas share one
  warm-prefix namespace. It also holds the disaggregated handoff's pinned
  entries (``hput`` / ``hclaim``, :mod:`.disagg`).

The wire is the JAX package's, byte for byte: a length-prefixed JSON
manifest (the same keys in the same order, numpy's dtype names) and the
raw bytes of every array, so either package's client talks to either
package's server. The port reads and writes those bytes through
``tensor.view(torch.uint8)`` and ``torch.frombuffer``, with its own dtype
table (no ``ml_dtypes``).

The engine talks to one :class:`TieredKV` facade: lookups cascade L2 ->
L3 and a hit is promoted upward. The server's Prometheus plane (its
registry and ``--metrics-port``) is ROADMAP.md queue A item 6; its
counters are attributes and answer the ``stats`` op.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import socket
import socketserver
import struct
import threading
import time

import torch

from llm_in_practise_tpu_torch.models.layers import to_kv_dtype
from llm_in_practise_tpu_torch.serve.prefix_cache import (
    PrefixEntry,
    PrefixLRU,
)

_log = logging.getLogger(__name__)

#: wire dtype name <-> torch dtype (the names numpy and ml_dtypes give)
WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}
_WIRE_NAMES = {v: k for k, v in WIRE_DTYPES.items()}


def _wire_name(t: torch.Tensor) -> str:
    try:
        return _WIRE_NAMES[t.dtype]
    except KeyError:
        raise ValueError(f"no wire name for dtype {t.dtype}") from None


# --- host-side entry and (de)serialization ----------------------------------


@dataclasses.dataclass
class HostEntry:
    """A prefix entry with every buffer a CPU tensor."""

    length: int                 # true token count of the cached prefix
    bucket: int                 # width of the stored rows
    rows: list                  # per-layer {name: (1, bucket, ...) tensor}
    last_logits: object         # (1, vocab) f32 logits, or None
    slot_axis: int = 0          # cache layout of the rows (PrefixEntry)
    # page-wise entries (paged producers): rows span
    # ceil(length / page_size) * page_size positions; 0 = a row entry
    page_size: int = 0
    # the token ids the rows were computed for (session-handoff entries,
    # whose claimer holds only a session id); None = a prefix-keyed entry
    token_ids: list | None = None

    @property
    def pages(self) -> int:
        """Live pages this entry spans (0 for row entries)."""
        if self.page_size <= 0:
            return 0
        return -(-self.length // self.page_size)


def entry_to_host(entry) -> HostEntry:
    """Device :class:`~.prefix_cache.PrefixEntry` -> :class:`HostEntry`:
    one copy to the host per buffer, on the caller's current stream."""
    rows = [{k: v.to("cpu") for k, v in layer.items()}
            for layer in entry.rows]
    logits = entry.last_logits
    return HostEntry(
        length=entry.length, bucket=entry.bucket, rows=rows,
        last_logits=None if logits is None else logits.to("cpu"),
        slot_axis=getattr(entry, "slot_axis", 0),
        page_size=getattr(entry, "page_size", 0))


def rows_to_device(host: HostEntry, device, dtype=None) -> torch.Tensor:
    """The first ``host.length`` rows of every layer's buffers (names
    sorted) as one ``(layers x names, length, ...)`` tensor on ``device``:
    one stack on the host, one copy to the card, then ``dtype`` (a float8
    target saturates, :func:`~..models.layers.to_kv_dtype`)."""
    n = host.length
    flat = torch.stack([layer[k][0, :n] for layer in host.rows
                        for k in sorted(layer)]).to(device)
    if dtype is not None and flat.dtype != dtype:
        flat = to_kv_dtype(flat, dtype)
    return flat


def entry_to_device(host: HostEntry, device, dtype=None) -> PrefixEntry:
    """:class:`HostEntry` -> a :class:`~.prefix_cache.PrefixEntry` on
    ``device`` holding the first ``length`` rows (:func:`rows_to_device`).
    The JAX package pads a page-aligned width to the next power of two
    here (``effective_bucket``) to bound XLA's compile set; the port's
    insert is an eager copy of ``length`` rows, so it ships no padding."""
    flat = rows_to_device(host, device, dtype)
    names = sorted(host.rows[0]) if host.rows else []
    rows = [{k: flat[i * len(names) + j][None] for j, k in enumerate(names)}
            for i in range(len(host.rows))]
    logits = host.last_logits
    return PrefixEntry(
        length=host.length, bucket=host.length, rows=rows,
        last_logits=None if logits is None else logits.to(device),
        slot_axis=host.slot_axis)


def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def encode_entry(host: HostEntry) -> bytes:
    """Self-describing blob: ``<I`` manifest length, the JSON manifest,
    then every array's raw bytes (layers in order, names sorted, then the
    logits). The JAX package's encoding, byte for byte."""
    arrays: list[torch.Tensor] = []
    manifest_rows = []
    for layer in host.rows:
        layer_meta = {}
        for name in sorted(layer):
            t = layer[name]
            layer_meta[name] = {"shape": list(t.shape),
                                "dtype": _wire_name(t)}
            arrays.append(t)
        manifest_rows.append(layer_meta)
    # session-published entries carry no final logits: a null manifest
    # slot, not a zero-length array
    logits = host.last_logits
    manifest = {
        "length": host.length,
        "bucket": host.bucket,
        "slot_axis": host.slot_axis,
        "page_size": host.page_size,
        "rows": manifest_rows,
        "last_logits": None if logits is None else
        {"shape": list(logits.shape), "dtype": _wire_name(logits)},
    }
    if host.token_ids is not None:
        # optional key: absent from prefix-keyed entries
        manifest["token_ids"] = [int(t) for t in host.token_ids]
    if logits is not None:
        arrays.append(logits)
    head = json.dumps(manifest).encode()
    return b"".join([struct.pack("<I", len(head)), head,
                     *(_tensor_bytes(a) for a in arrays)])


def decode_entry(blob) -> HostEntry:
    """The inverse of :func:`encode_entry`. The tensors are views of the
    blob's memory (``torch.frombuffer`` at the manifest's offsets); a
    ``bytes`` blob is copied once into a writable buffer first."""
    if isinstance(blob, bytes):
        blob = bytearray(blob)
    (hlen,) = struct.unpack_from("<I", blob, 0)
    manifest = json.loads(bytes(blob[4: 4 + hlen]).decode())
    off = 4 + hlen

    def take(meta) -> torch.Tensor:
        nonlocal off
        try:
            dt = WIRE_DTYPES[meta["dtype"]]
        except KeyError:
            raise ValueError(f"unknown wire dtype {meta['dtype']!r}") from None
        shape = [int(d) for d in meta["shape"]]
        n = dt.itemsize
        for d in shape:
            n *= d
        if off + n > len(blob):
            raise ValueError("kv entry blob is shorter than its manifest")
        if n == 0:
            t = torch.empty(shape, dtype=dt)
        else:
            t = torch.frombuffer(blob, dtype=torch.uint8, count=n,
                                 offset=off).view(dt).reshape(shape)
        off += n
        return t

    rows = [{name: take(meta) for name, meta in sorted(layer.items())}
            for layer in manifest["rows"]]
    lmeta = manifest["last_logits"]
    return HostEntry(length=manifest["length"], bucket=manifest["bucket"],
                     slot_axis=int(manifest.get("slot_axis", 0)),
                     page_size=int(manifest.get("page_size", 0)),
                     rows=rows,
                     last_logits=take(lmeta) if lmeta is not None else None,
                     token_ids=manifest.get("token_ids"))


# --- L2: host-RAM pool --------------------------------------------------------


class HostKVPool(PrefixLRU):
    """LRU of host-resident prefix entries: the shared
    :class:`~.prefix_cache.PrefixLRU` store with :class:`HostEntry`
    values. The budget is host RAM, counted in cached tokens (LMCache's
    ``LMCACHE_MAX_LOCAL_CPU_SIZE``)."""

    def __init__(self, *, max_tokens: int = 1 << 20, min_prefix: int = 16):
        super().__init__(max_tokens=max_tokens, min_prefix=min_prefix)


# --- L3: remote pool server (the ``lm://`` analog) ---------------------------


# Framing caps: the wire header declares 32-bit lengths, so an untrusted
# peer could demand ~4 GiB per message. Both fields are capped before
# allocating; a violation desyncs the stream, so the connection closes.
MAX_HEADER_BYTES = 1 << 20          # JSON manifest: token keys only
MAX_PAYLOAD_BYTES = 1 << 30         # one serialized prefix entry


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            raise ConnectionError("kv pool peer closed mid-message")
        got += k
    return buf


def _recv_prelude(sock: socket.socket) -> bytes | None:
    """The 8-byte length prelude, or None on a clean close (EOF at a
    message boundary: a client hanging up between requests)."""
    first = sock.recv(1)
    if not first:
        return None
    return first + bytes(_recv_exact(sock, 7))


def _send_msg(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    head = json.dumps(header).encode()
    sock.sendall(struct.pack("<II", len(head), len(payload)) + head)
    if payload:
        sock.sendall(payload)


def _recv_msg(sock: socket.socket, *, max_header: int = MAX_HEADER_BYTES,
              max_payload: int = MAX_PAYLOAD_BYTES,
              prelude: bytes | None = None) -> tuple[dict, bytearray]:
    hlen, plen = struct.unpack(
        "<II", prelude if prelude is not None else bytes(_recv_exact(sock, 8)))
    if hlen > max_header or plen > max_payload:
        raise ConnectionError(
            f"kv pool message exceeds caps (header {hlen} > {max_header} or "
            f"payload {plen} > {max_payload}) — closing connection")
    header = json.loads(bytes(_recv_exact(sock, hlen)).decode())
    payload = _recv_exact(sock, plen) if plen else bytearray()
    return header, payload


class KVPoolServer:
    """Shared prefix-KV pool over TCP (the LMCache server).

    Keys are token tuples **namespaced by model identity** (the ``ns``
    header): KV rows are valid only under the weights that produced them,
    so two served models never cross-hit. ``get`` matches the longest
    strict prefix server-side, in one round trip.

    Budgets are global: one LRU spans every namespace (the namespace is
    the first key element), bounded by ``max_tokens`` and ``max_bytes``.
    The namespace set is bounded (``max_namespaces``): a peer inventing
    namespaces is refused, and a lookup in an unknown one only counts a
    miss.

    Handoff entries (``hput`` / ``hclaim``) live outside the LRU, pinned
    until claimed: put pressure can never evict one before its decode
    replica claims it. They expire after ``handoff_ttl_s``, and pins past
    ``max_handoff_bytes`` are refused.

    Trust boundary: the protocol is unauthenticated; bind to loopback
    (the default) or a network only the serving pods reach. The framing
    caps bound what one message can make the server allocate."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 max_tokens: int = 1 << 22, min_prefix: int = 16,
                 max_bytes: int = 4 << 30, max_namespaces: int = 64,
                 max_payload: int = MAX_PAYLOAD_BYTES,
                 handoff_ttl_s: float = 120.0,
                 max_handoff_bytes: int = 1 << 30, clock=None):
        self.min_prefix = min_prefix
        self.max_tokens = max_tokens
        self.max_bytes = max_bytes
        self.max_namespaces = max_namespaces
        self.max_payload = min(max_payload, max_bytes)
        self.rejected = 0             # puts refused (namespace / size caps)
        self.evictions = 0            # LRU entries dropped (token/byte caps)
        self._unknown_ns_misses = 0   # gets for namespaces never put to
        # per-connection fault containment: a protocol or transport fault
        # is logged, counted and closes that connection only
        self.conn_errors = 0
        self.handoff_ttl_s = handoff_ttl_s
        self.max_handoff_bytes = max_handoff_bytes
        self._clock = clock or time.monotonic
        # (ns, id) -> (expires_at, length, bucket, blob, pages)
        self._handoff: dict[tuple[str, str], tuple] = {}  # guarded-by: _acct_lock
        self._handoff_bytes = 0  # guarded-by: _acct_lock
        self._handoff_pages = 0  # guarded-by: _acct_lock
        self.handoff_puts = 0
        self.handoff_claims = 0
        self.handoff_expired = 0
        self.handoff_rejected = 0
        # per-op count and seconds of the handoff data plane, prelude seen
        # to reply sent (JAX: the kvpool_handoff_wire_seconds histogram)
        self.handoff_wire = {"hput": [0, 0.0], "hclaim": [0, 0.0]}  # guarded-by: _acct_lock
        self._namespaces: set[str] = set()  # guarded-by: _acct_lock
        # live entries per namespace: a namespace whose last entry is
        # evicted releases its slot
        self._ns_counts: dict[str, int] = {}  # guarded-by: _acct_lock
        self._total_bytes = 0  # guarded-by: _acct_lock
        # RLock: _put holds it across peek/account/store.put, and the
        # store's on_evict re-enters it on the same thread
        self._acct_lock = threading.RLock()
        # one global store: keys (ns, tok0, tok1, ...), values
        # (key_len, bucket, blob) where key_len counts the ns element
        self._store = PrefixLRU(
            max_tokens=max_tokens, min_prefix=min_prefix + 1,
            length_of=lambda v: v[0], on_evict=self._on_evict)
        pool = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        prelude = _recv_prelude(self.request)
                    except (ConnectionError, OSError) as e:
                        pool._conn_fault(self.client_address, e)
                        return
                    if prelude is None:
                        return            # clean close between messages
                    try:
                        t0 = time.perf_counter()
                        header, payload = _recv_msg(
                            self.request, max_payload=pool.max_payload,
                            prelude=prelude)
                        pool._dispatch(self.request, header, payload)
                        wire = pool.handoff_wire.get(header.get("op"))
                        if wire is not None:
                            with pool._acct_lock:
                                wire[0] += 1
                                wire[1] += time.perf_counter() - t0
                    except Exception as e:  # noqa: BLE001 — malformed
                        # header, over-cap frame, mid-read EOF, bad op
                        # arguments: contain the fault to this connection
                        pool._conn_fault(self.client_address, e)
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self) -> "KVPoolServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- ops ----------------------------------------------------------------

    def _conn_fault(self, peer, exc) -> None:
        self.conn_errors += 1
        _log.warning("kv pool connection from %s closed on fault #%d: %s: %s",
                     peer, self.conn_errors, type(exc).__name__, exc)

    def _on_evict(self, key, value) -> None:
        with self._acct_lock:
            self.evictions += 1
            self._total_bytes -= len(value[2])
            ns = key[0]
            n = self._ns_counts.get(ns, 0) - 1
            if n <= 0:
                self._ns_counts.pop(ns, None)
                self._namespaces.discard(ns)   # slot freed for reuse
            else:
                self._ns_counts[ns] = n

    def _dispatch(self, sock, header: dict, payload) -> None:
        op = header.get("op")
        ns = str(header.get("ns", ""))
        if op == "put":
            ok, why = self._put(ns, tuple(header["key"]),
                                int(header["length"]),
                                int(header["bucket"]), payload)
            _send_msg(sock, {"ok": ok} if ok else {"ok": False, "error": why})
        elif op == "get":
            found = self._get(ns, tuple(header["prompt"]))
            if found is None:
                _send_msg(sock, {"found": False})
            else:
                length, bucket, blob = found
                _send_msg(sock, {"found": True, "length": length,
                                 "bucket": bucket}, blob)
        elif op == "hput":
            ok, why = self._handoff_put(ns, str(header["id"]),
                                        int(header["length"]),
                                        int(header["bucket"]), payload,
                                        pages=int(header.get("pages", 0)))
            _send_msg(sock, {"ok": ok} if ok else {"ok": False, "error": why})
        elif op == "hclaim":
            found = self._handoff_claim(ns, str(header["id"]))
            if found is None:
                _send_msg(sock, {"found": False})
            else:
                length, bucket, blob = found
                _send_msg(sock, {"found": True, "length": length,
                                 "bucket": bucket}, blob)
        elif op == "stats":
            _send_msg(sock, self.stats())
        else:
            _send_msg(sock, {"ok": False, "error": f"unknown op {op!r}"})

    def stats(self) -> dict:
        """The ``stats`` op's answer (the JAX server's keys)."""
        with self._acct_lock:
            total_bytes = self._total_bytes
            n_ns = len(self._namespaces)
            handoff_pending = len(self._handoff)
            handoff_bytes = self._handoff_bytes
            handoff_pages = self._handoff_pages
        return {
            "entries": self._store.n_entries,
            # the ns key element is bookkeeping, not a cached token
            "cached_tokens":
                self._store.cached_tokens - self._store.n_entries,
            "cached_bytes": total_bytes,
            "hits": self.hits, "misses": self.misses,
            "namespaces": n_ns, "rejected": self.rejected,
            "conn_errors": self.conn_errors,
            "handoff_pending": handoff_pending,
            "handoff_bytes": handoff_bytes,
            "handoff_pages": handoff_pages,
            "handoff_puts": self.handoff_puts,
            "handoff_claims": self.handoff_claims,
            "handoff_expired": self.handoff_expired,
            "handoff_rejected": self.handoff_rejected,
        }

    @property
    def hits(self) -> int:
        return self._store.hits

    @property
    def misses(self) -> int:
        return self._unknown_ns_misses + self._store.misses

    @property
    def cached_bytes(self) -> int:
        with self._acct_lock:
            return self._total_bytes

    @property
    def handoff_bytes(self) -> int:
        with self._acct_lock:
            return self._handoff_bytes

    @property
    def handoff_pages(self) -> int:
        with self._acct_lock:
            return self._handoff_pages

    @property
    def handoff_pending(self) -> int:
        with self._acct_lock:
            return len(self._handoff)

    @property
    def n_namespaces(self) -> int:
        with self._acct_lock:
            return len(self._namespaces)

    @property
    def _entries(self):
        """Aggregated view (tests and introspection): {(ns, key): value}."""
        with self._store._lock:
            return {(k[0], k[1:]): v for k, v in self._store._entries.items()}

    def _put(self, ns: str, key: tuple, length: int, bucket: int,
             blob: bytes) -> tuple[bool, str]:
        # validate before consuming any budget: a refused put must neither
        # burn a namespace slot nor leak bytes into the accounting
        if length < self.min_prefix:
            self.rejected += 1
            return False, f"prefix shorter than min_prefix={self.min_prefix}"
        if len(blob) > self.max_payload:
            self.rejected += 1
            return False, "entry larger than max_payload"
        full_key = (ns,) + tuple(key[:length])
        with self._acct_lock:
            if ns not in self._namespaces:
                if len(self._namespaces) >= self.max_namespaces:
                    self.rejected += 1
                    return False, "namespace budget exhausted"
                self._namespaces.add(ns)
            old = self._store.peek(full_key)
            if old is not None:
                self._total_bytes -= len(old[2])
            else:
                self._ns_counts[ns] = self._ns_counts.get(ns, 0) + 1
            self._total_bytes += len(blob)
            self._store.put(full_key, (length + 1, bucket, blob))
            # byte budget: evict globally-LRU entries of any namespace
            # (pop_lru -> on_evict re-enters the RLock for the decrement)
            while self._total_bytes > self.max_bytes:
                if self._store.pop_lru() is None:
                    break
        return True, ""

    def _get(self, ns: str, prompt: tuple):
        with self._acct_lock:
            known = ns in self._namespaces
        if not known:
            self._unknown_ns_misses += 1
            return None
        found = self._store.lookup((ns,) + prompt)
        if found is None:
            return None
        key_len, bucket, blob = found
        return key_len - 1, bucket, blob

    # -- handoff (disaggregated serving) --------------------------------------

    def _sweep_handoff_locked(self, now: float) -> None:
        """Reclaim expired handoff entries (the TTL is the only eviction
        pinned entries feel), per blob and per page. Caller holds
        ``_acct_lock``."""
        dead = [k for k, v in self._handoff.items() if v[0] <= now]
        for k in dead:
            entry = self._handoff.pop(k)
            self._handoff_bytes -= len(entry[3])
            self._handoff_pages -= entry[4]
            self.handoff_expired += 1

    def _handoff_put(self, ns: str, hid: str, length: int, bucket: int,
                     blob: bytes, pages: int = 0) -> tuple[bool, str]:
        now = self._clock()
        with self._acct_lock:
            self._sweep_handoff_locked(now)
            old = self._handoff.get((ns, hid))
            freed = len(old[3]) if old is not None else 0
            if (self._handoff_bytes - freed + len(blob)
                    > self.max_handoff_bytes):
                # refuse, never evict: every pinned entry has a decode
                # replica about to claim it
                self.handoff_rejected += 1
                return False, "handoff byte budget exhausted"
            self._handoff_bytes += len(blob) - freed
            self._handoff_pages += pages - (old[4] if old else 0)
            self._handoff[(ns, hid)] = (
                now + self.handoff_ttl_s, length, bucket, blob, pages)
            self.handoff_puts += 1
        return True, ""

    def _handoff_claim(self, ns: str, hid: str):
        now = self._clock()
        with self._acct_lock:
            self._sweep_handoff_locked(now)
            found = self._handoff.pop((ns, hid), None)
            if found is None:
                return None
            _, length, bucket, blob, pages = found
            self._handoff_bytes -= len(blob)
            self._handoff_pages -= pages
            self.handoff_claims += 1
        return length, bucket, blob


class HandoffRejected(RuntimeError):
    """The pool refused to pin a handoff entry (size or budget caps)."""


class RemoteKVClient:
    """One engine's handle on a :class:`KVPoolServer`, a connection per
    call (the pool is hit only on L1 + L2 misses and on offload).

    ``namespace`` names the weights the KV was computed under: every
    served model must use its own, or their rows would cross-hit."""

    def __init__(self, address: tuple[str, int], *, timeout: float = 5.0,
                 namespace: str = ""):
        self.address = tuple(address)
        self.timeout = timeout
        self.namespace = namespace

    def _call(self, header: dict, payload: bytes = b"",
              timeout: float | None = None) -> tuple[dict, bytearray]:
        with socket.create_connection(
                self.address,
                timeout=timeout if timeout is not None else self.timeout) as s:
            _send_msg(s, header, payload)
            return _recv_msg(s)

    def put(self, prompt_ids, host: HostEntry) -> None:
        key = [int(t) for t in prompt_ids[: host.length]]
        self._call({"op": "put", "ns": self.namespace, "key": key,
                    "length": host.length, "bucket": host.bucket},
                   encode_entry(host))

    def get(self, prompt_ids,
            timeout: float | None = None) -> HostEntry | None:
        header, payload = self._call(
            {"op": "get", "ns": self.namespace,
             "prompt": [int(t) for t in prompt_ids]}, timeout=timeout)
        if not header.get("found"):
            return None
        return decode_entry(payload)

    def stats(self) -> dict:
        header, _ = self._call({"op": "stats"})
        return header

    # -- handoff (disaggregated serving) --------------------------------------

    def handoff_put(self, handoff_id: str, host: HostEntry) -> None:
        """Pin ``host`` under ``handoff_id`` until a decode replica claims
        it (or the TTL reclaims it). Raises :class:`HandoffRejected` when
        the pool refuses: the caller is about to point a decode replica
        at this entry and must know."""
        header, _ = self._call(
            {"op": "hput", "ns": self.namespace, "id": handoff_id,
             "length": host.length, "bucket": host.bucket,
             "pages": host.pages},
            encode_entry(host))
        if not header.get("ok"):
            raise HandoffRejected(header.get("error", "handoff put refused"))

    def handoff_claim(self, handoff_id: str,
                      timeout: float | None = None) -> HostEntry | None:
        """Claim and remove a pinned handoff entry; None = lost (expired,
        never published, or already claimed): the caller re-prefills."""
        header, payload = self._call(
            {"op": "hclaim", "ns": self.namespace, "id": handoff_id},
            timeout=timeout)
        if not header.get("found"):
            return None
        return decode_entry(payload)


# --- the facade the engine holds --------------------------------------------


class TieredKV:
    """L2 (and optionally L3) behind one lookup/offload surface.

    One per served model: rows are valid only under the weights that
    produced them, so the host pool is never shared across models and the
    remote client carries that model's namespace.

    ``offload_on_put=True`` (LMCache's write-through) copies every
    finished prefill's entry down the tiers; ``False`` offloads only on
    L1 eviction. The copy to the host and the host-pool insert run in
    :meth:`offload`, on the caller's thread; only the remote put runs on
    a background worker by default (``async_offload``), so a dead pool
    server never stalls the engine for a connect timeout. The queue is
    bounded; overflow drops the remote copy (``dropped``). :meth:`flush`
    drains it.

    Lookups run on the engine thread: after one failure the remote sits
    out ``remote_cooldown_s`` (the circuit breaker), and a lookup gets
    its own deadline, ``lookup_timeout_s``; a slower answer is kept but
    trips the cooldown too (``slow_trips``)."""

    def __init__(self, host_pool: HostKVPool | None = None,
                 remote: RemoteKVClient | None = None, *,
                 offload_on_put: bool = True, async_offload: bool = True,
                 queue_size: int = 64, remote_cooldown_s: float = 30.0,
                 lookup_timeout_s: float = 0.75, clock=None):
        self.host_pool = host_pool if host_pool is not None else HostKVPool()
        self.remote = remote
        self.offload_on_put = offload_on_put
        self.remote_errors = 0
        self.dropped = 0
        self.remote_cooldown_s = remote_cooldown_s
        self.lookup_timeout_s = lookup_timeout_s
        self.slow_trips = 0
        self._remote_down_until = 0.0
        self._clock = clock or time.monotonic
        self._queue: "queue.Queue | None" = (
            queue.Queue(maxsize=queue_size) if async_offload else None)
        self._worker: threading.Thread | None = None

    def _remote_ok(self) -> bool:
        return (self.remote is not None
                and self._clock() >= self._remote_down_until)

    def _remote_failed(self) -> None:
        self.remote_errors += 1
        self._remote_down_until = self._clock() + self.remote_cooldown_s

    # -- offload path ---------------------------------------------------------

    def _remote_put(self, prompt_ids, host: HostEntry) -> None:
        if self._remote_ok():
            try:
                self.remote.put(prompt_ids, host)
            except OSError:
                self._remote_failed()

    def _run_worker(self) -> None:
        while True:
            prompt_ids, host = self._queue.get()
            try:
                self._remote_put(prompt_ids, host)
            except Exception:  # noqa: BLE001 — the worker must survive a
                # malformed reply; the loss is counted
                self.remote_errors += 1
                _log.exception("kv pool offload failed")
            finally:
                self._queue.task_done()

    def offload(self, prompt_ids, entry) -> None:
        """Device prefix entry -> host pool (and the remote, best effort).
        The copy to the host runs here, on the caller's thread: queueing
        the device rows instead would pin the evicted memory until the
        worker drained."""
        host = entry_to_host(entry)
        self.host_pool.put(prompt_ids, host)
        if self.remote is None:
            return
        if self._queue is None:
            self._remote_put(prompt_ids, host)
            return
        if self._worker is None:
            self._worker = threading.Thread(target=self._run_worker,
                                            daemon=True,
                                            name="kv-pool-offload")
            self._worker.start()
        try:
            self._queue.put_nowait((list(prompt_ids), host))
        except queue.Full:
            self.dropped += 1

    def flush(self) -> None:
        """Block until every queued offload has landed in the tiers."""
        if self._queue is not None and self._worker is not None:
            self._queue.join()

    # -- lookup path ----------------------------------------------------------

    def lookup(self, prompt_ids, usable=None):
        """The longest host or remote prefix entry of ``prompt_ids`` as a
        :class:`HostEntry`, or None. ``usable(entry)`` filters candidates
        on their metadata before a remote hit is promoted into the host
        pool. The engine copies a hit to the card itself (the JAX
        ``device=`` switch): a contiguous engine uploads it, a paged one
        scatters its rows into the slot's pages."""
        host = self.host_pool.lookup(prompt_ids, usable=usable)
        if host is None and self._remote_ok():
            t0 = self._clock()
            try:
                host = self.remote.get(prompt_ids,
                                       timeout=self.lookup_timeout_s)
            except OSError:
                self._remote_failed()
                host = None
            else:
                if self._clock() - t0 > self.lookup_timeout_s:
                    # slow but alive: keep the answer, trip the cooldown
                    self.slow_trips += 1
                    self._remote_down_until = (
                        self._clock() + self.remote_cooldown_s)
            if host is not None and usable is not None and not usable(host):
                host = None
            if host is not None:
                self.host_pool.put(prompt_ids, host)
        return host


def main(argv=None) -> None:
    """Run a standalone pool server (the reference's LMCache server
    Deployment): ``python -m llm_in_practise_tpu_torch.serve.kv_pool``."""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; the protocol is unauthenticated, so "
                        "bind 0.0.0.0 only on a network that only the "
                        "serving pods reach")
    p.add_argument("--port", type=int, default=8100,
                   help="TCP port (0 picks a free one; the bound address "
                        "is printed)")
    p.add_argument("--max-tokens", type=int, default=1 << 22,
                   help="global pool budget in cached prefix tokens")
    p.add_argument("--max-bytes", type=int, default=4 << 30,
                   help="global pool budget in blob bytes")
    p.add_argument("--max-namespaces", type=int, default=64)
    p.add_argument("--metrics-port", type=int, default=0,
                   help="Prometheus /metrics port; not ported yet (0 = off)")
    args = p.parse_args(argv)
    if args.metrics_port:
        raise NotImplementedError(
            "--metrics-port is not ported to the PyTorch pool server yet "
            "(ROADMAP.md queue A item 6); the counters answer the stats op")
    server = KVPoolServer(args.host, args.port, max_tokens=args.max_tokens,
                          max_bytes=args.max_bytes,
                          max_namespaces=args.max_namespaces)
    server.start()
    print(f"kv pool server on {server.address[0]}:{server.address[1]} "
          f"(budget {args.max_tokens} tokens / {args.max_bytes} bytes)",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
