"""HBM ledger: every device byte has a named owner (port of
``llm_in_practise_tpu/obs/hbm.py``).

``torch.cuda.memory_allocated`` says HOW MUCH the allocator holds;
nothing says WHO. Each owner books alloc/free deltas into a named
**account** at the call site that already creates or releases the
buffer:

====================  =====================================================
account               booked by
====================  =====================================================
``weights/<c>``       engine ``__init__`` / ``stop`` (``<c>`` = model,
                      draft_model)
``kv_pool.pages``     ``paged_kv.PagedKV``'s pool tensor (alloc at build,
                      free at ``close()``)
``kv.contiguous``     the contiguous-layout engine cache (K and V)
``kv.draft``          the draft model's contiguous cache (K and V), the
                      byte equivalent of ``/debug/kv``'s
                      ``draft_kv_reserved_tokens``
``adapters/r<b>``     ``multi_lora.AdapterRegistry`` payload bytes per
                      rank bucket (register / evict deltas)
``session_pins``      ``sessions.SessionStore`` pinned pages: a VIEW into
                      ``kv_pool.pages`` (attributes, never adds)
``transient_view``    the gather view each paged dispatch materializes:
                      pulse-booked, its peak is the pool + view
                      coexistence bytes
``handoff_staging``   host-side ``HostEntry`` bytes between the copy to
                      the host and the pool put (HOST plane, excluded
                      from the device sum)
====================  =====================================================

Two account kinds keep the reconciliation honest: ``view`` accounts
(``session_pins``) re-attribute bytes another account already owns, and
``host`` accounts (``handoff_staging``) live in process RAM; both are
excluded from the device sum, so the ledger never counts a byte twice
against ``torch.cuda.memory_allocated``. The residual between the two is
``llm_hbm_unattributed_bytes``. On the card it holds what no account
owns: CUDA graph pools, cuBLAS workspaces, activations and the
allocator's rounding; it is reported, never forced to zero. A CPU engine
has no device stats: the residual is then 0 (fail open).

Thread contract: the ledger is written from the engine thread (dispatch
pulses, lifecycle books), HTTP handler threads (adapter register/evict,
claim pulses) and publisher threads (handoff staging); every mutation
takes ``_lock``, a LEAF lock (the ledger never calls out while holding
it), so any caller-side lock order composes with it.
"""

from __future__ import annotations

import threading

import torch

from llm_in_practise_tpu_torch.obs.cost import device_memory_stats

# Accounts that re-attribute bytes another account already owns (views)
# or that live in host RAM — excluded from the device-byte sum the
# reconciliation compares against the runtime.
VIEW_ACCOUNTS = frozenset({"session_pins"})
HOST_ACCOUNTS = frozenset({"handoff_staging"})


class _Account:
    """One owner's books (all fields guarded by the ledger's lock)."""

    __slots__ = ("bytes", "peak", "allocs", "frees", "pulses",
                 "last_pulse_bytes")

    def __init__(self):
        self.bytes = 0            # guarded-by: _lock
        self.peak = 0             # guarded-by: _lock
        self.allocs = 0           # guarded-by: _lock
        self.frees = 0            # guarded-by: _lock
        self.pulses = 0           # guarded-by: _lock
        self.last_pulse_bytes = 0  # guarded-by: _lock


class HbmLedger:
    """Process-wide byte-attribution ledger.

    ``book`` moves an account by a signed delta; ``pulse`` books a
    transient allocation (alloc+free in one lock hold — current bytes
    are untouched, the per-account high-water mark records the
    coexistence peak); ``transfer`` moves bytes between owners without
    changing the total; ``note_reclaim`` counts eviction/preemption
    events chained through the stack's existing pressure hooks.
    """

    def __init__(self, *, device_stats=None):
        self._lock = threading.Lock()
        self._accounts: "dict[str, _Account]" = {}  # guarded-by: _lock
        # (owner, reason) -> event count
        self._reclaims: "dict[tuple[str, str], int]" = {}  # guarded-by: _lock
        self._device_stats = device_stats or device_memory_stats

    # -- booking --------------------------------------------------------------

    def _acct_locked(self, owner: str) -> _Account:
        acct = self._accounts.get(owner)
        if acct is None:
            acct = self._accounts[owner] = _Account()
        return acct

    def book(self, owner: str, delta: int) -> None:
        """Move ``owner`` by ``delta`` bytes (alloc > 0, free < 0).

        A free below zero clamps with the shortfall left visible as a
        negative balance — a double-free is a bug the churn-to-zero
        gate must SEE, not one the ledger should paper over."""
        d = int(delta)
        if d == 0:
            return
        with self._lock:
            acct = self._acct_locked(owner)
            acct.bytes += d
            if d > 0:
                acct.allocs += 1
                if acct.bytes > acct.peak:
                    acct.peak = acct.bytes
            else:
                acct.frees += 1

    def pulse(self, owner: str, n_bytes: int) -> None:
        """Book a transient allocation that lives shorter than any
        scrape: current bytes stay put, the peak records the high-water
        mark. The paged dispatch's gather view books here: its peak is
        the pool + view coexistence bytes."""
        n = int(n_bytes)
        if n <= 0:
            return
        with self._lock:
            acct = self._acct_locked(owner)
            acct.pulses += 1
            acct.last_pulse_bytes = n
            if acct.bytes + n > acct.peak:
                acct.peak = acct.bytes + n

    def transfer(self, src: str, dst: str, n_bytes: int) -> None:
        """Move ``n_bytes`` from ``src`` to ``dst`` in one lock hold —
        the total never flickers between the two books."""
        n = int(n_bytes)
        if n <= 0:
            return
        with self._lock:
            a, b = self._acct_locked(src), self._acct_locked(dst)
            a.bytes -= n
            a.frees += 1
            b.bytes += n
            b.allocs += 1
            if b.bytes > b.peak:
                b.peak = b.bytes

    def note_reclaim(self, owner: str, reason: str, events: int = 1) -> None:
        """Count a pressure-driven release (``llm_hbm_reclaims_total``),
        from the hooks that already exist: page-pool preemption,
        prefix-index eviction, session TTL / capacity / pressure, adapter
        budget evictions."""
        if events <= 0:
            return
        with self._lock:
            key = (owner, reason)
            self._reclaims[key] = self._reclaims.get(key, 0) + int(events)

    # -- reading --------------------------------------------------------------

    def account_bytes(self, owner: str) -> int:
        with self._lock:
            acct = self._accounts.get(owner)
            return acct.bytes if acct is not None else 0

    def device_bytes(self) -> int:
        """The ledger's claim on the device: sum over real device
        accounts (views and host-plane accounts excluded)."""
        with self._lock:
            return self._device_sum_locked()

    def _device_sum_locked(self) -> int:
        return sum(a.bytes for name, a in self._accounts.items()
                   if name not in VIEW_ACCOUNTS
                   and name not in HOST_ACCOUNTS)

    def unattributed_bytes(self) -> int:
        """``bytes_in_use - sum(device accounts)``: the reconciliation
        residual. Fail-open: a device with no memory stats (the CPU)
        reports 0, because an unverifiable residual must not page
        anyone."""
        in_use = self._device_stats().get("bytes_in_use")
        if in_use is None:
            return 0
        return int(in_use) - self.device_bytes()

    def snapshot(self) -> dict:
        """One-lock copy of every account and reclaim counter (the
        ``/metrics`` callbacks and ``/debug/hbm`` both read through this,
        so they can never disagree)."""
        with self._lock:
            accounts = {
                name: {
                    "bytes": a.bytes,
                    "peak_bytes": a.peak,
                    "allocs": a.allocs,
                    "frees": a.frees,
                    "pulses": a.pulses,
                    "last_pulse_bytes": a.last_pulse_bytes,
                }
                for name, a in self._accounts.items()
            }
            reclaims = [
                {"owner": o, "reason": r, "events": n}
                for (o, r), n in self._reclaims.items()
            ]
            device_sum = self._device_sum_locked()
        return {"accounts": accounts, "reclaims": reclaims,
                "device_bytes": device_sum}

    def debug_tree(self) -> dict:
        """The ``GET /debug/hbm`` payload: the ownership tree (accounts
        grouped by their ``/``-rooted component), per-account high-water
        marks, and the reconciliation block."""
        snap = self.snapshot()
        stats = self._device_stats()
        in_use = stats.get("bytes_in_use")
        tree: dict = {}
        for name, a in sorted(snap["accounts"].items()):
            root = name.split("/", 1)[0]
            group = tree.setdefault(root, {"bytes": 0, "accounts": {}})
            group["accounts"][name] = dict(
                a,
                plane=("view" if name in VIEW_ACCOUNTS
                       else "host" if name in HOST_ACCOUNTS
                       else "device"),
            )
            group["bytes"] += a["bytes"]
        return {
            "tree": tree,
            "reclaims": snap["reclaims"],
            "reconciliation": {
                "ledger_device_bytes": snap["device_bytes"],
                "runtime_bytes_in_use": in_use,
                "unattributed_bytes": (None if in_use is None
                                       else int(in_use)
                                       - snap["device_bytes"]),
                "fail_open": in_use is None,
            },
        }

    # -- test/bench support ---------------------------------------------------

    def baseline(self) -> dict:
        """Per-account byte balances right now: churn-to-zero checks diff
        against this instead of absolute zero, so a shared process
        ledger stays assertable."""
        with self._lock:
            return {name: a.bytes for name, a in self._accounts.items()}

    def leaked_since(self, baseline: dict) -> dict:
        """Accounts whose balance moved from ``baseline`` (new accounts
        count from 0); an empty dict means the churn drained clean."""
        with self._lock:
            now = {name: a.bytes for name, a in self._accounts.items()}
        leaks = {}
        for name in set(now) | set(baseline):
            delta = now.get(name, 0) - baseline.get(name, 0)
            if delta != 0:
                leaks[name] = delta
        return leaks


# The process-wide ledger every stack call site books into. Engines,
# pools, registries and stores all alloc on build and free on close, so
# the global books are the sum over LIVE owners — a test that builds and
# stops an engine leaves them exactly where it found them.
_GLOBAL = HbmLedger()


def get_ledger() -> HbmLedger:
    return _GLOBAL


def host_entry_bytes(host) -> int:
    """Staging bytes of a :class:`~..serve.kv_pool.HostEntry`: the
    per-layer host rows plus the carried logits, what sits in process RAM
    between the copy to the host and the pool put (tensors or arrays:
    anything with ``nbytes``)."""
    n = 0
    for layer in getattr(host, "rows", None) or []:
        for arr in layer.values():
            n += _nbytes(arr)
    logits = getattr(host, "last_logits", None)
    if logits is not None:
        n += _nbytes(logits)
    return n


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(getattr(arr, "nbytes", 0) or 0)


def register_hbm_ledger(reg, ledger: "HbmLedger | None" = None) -> None:
    """Attach the four ledger families to a metrics registry
    (callback-backed: nothing is counted twice)."""
    led = ledger or get_ledger()

    def _bytes():
        snap = led.snapshot()
        return [({"owner": name}, a["bytes"])
                for name, a in sorted(snap["accounts"].items())]

    def _peaks():
        snap = led.snapshot()
        return [({"owner": name}, a["peak_bytes"])
                for name, a in sorted(snap["accounts"].items())]

    def _reclaims():
        snap = led.snapshot()
        return [({"owner": r["owner"], "reason": r["reason"]}, r["events"])
                for r in sorted(snap["reclaims"],
                                key=lambda r: (r["owner"], r["reason"]))]

    reg.gauge_func(
        "llm_hbm_ledger_bytes", _bytes,
        help="Ledger-attributed bytes per owner account")
    reg.gauge_func(
        "llm_hbm_ledger_peak_bytes", _peaks,
        help="Per-account high-water mark (transient_view's is the "
             "pool+view coexistence peak)")
    reg.counter_func(
        "llm_hbm_reclaims_total", _reclaims,
        help="Pressure-driven releases by owner and reason")
    reg.gauge_func(
        "llm_hbm_unattributed_bytes", led.unattributed_bytes,
        help="Runtime bytes_in_use minus ledger device accounts "
             "(0 when the backend reports no stats)")
