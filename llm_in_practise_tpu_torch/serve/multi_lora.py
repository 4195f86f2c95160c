"""Batched multi-LoRA serving: one base model, many adapters in one step.

Port of ``llm_in_practise_tpu/serve/multi_lora.py``. The low-rank factors
of every loaded adapter live in shared, rank-bucketed device banks; each
dispatch carries one bank row per batch row, and the adapter twins of
the engine's step paths gather each row's A/B factors and add the delta
after every targeted projection (the batched ``y += x @ A[idx] @ B[idx]``
of punica, arxiv 2310.18547). Rows running different adapters, and base
rows, whose index selects the all-zeros row 0, share one dispatch.

- :func:`lora_context` / :func:`current_lora`: a thread-local stack of
  dispatch contexts ``{"idx": {rank bucket: (B,) int64 tensor}, "banks":
  {rank bucket: banks}}``. The engine enters one around an adapter
  dispatch (on the card: around the capture of an adapter twin graph, so
  the graph reads the context's static index buffers and banks).
- :class:`LoRAServingModel`: the model facade. It swaps every projection
  module (``Dense`` or ``QuantizedLinear``) for a :class:`LoRAProjection`
  that calls the original and, only when a context is set, adds the
  gathered delta: computed in f32 from the f32 banks, cast to the
  output's dtype and added after the unchanged base projection (the NF4
  kernel runs under every adapter). With no context the base paths run
  the ops they ran before.
- :class:`AdapterRegistry`: hot-load and evict over the banks: rank
  buckets with power-of-two capacity, refcounted rows evicted LRU under a
  byte budget, a prefix-cache namespace per registration, and the swap,
  eviction and tenant-token counters (``stats()``).

The banks are tensors the engine's CUDA graphs read at their addresses.
A bucket that grows, or gains a target, replaces its tensors: the
registry's ``generation`` counts such replacements, and the engine
recaptures its adapter twins when it changes (JAX retraces them). Row
writes and zeroing touch only rows no slot indexes, and run under the
engine's step lock (:meth:`AdapterRegistry.attach`), so no replay or
capture is in flight while a row changes.

Each registration books its payload bytes into the HBM ledger's
``adapters/r<b>`` account (evictions free them; a budget eviction counts
a ``budget`` reclaim); the banks' power-of-two padding beyond the payload
shows in the ledger's residual. Left out: tensor-parallel placement of
the banks (``mesh=``, JAX ``_place``; ROADMAP.md queue A item 14).

:class:`AdapterHandle` keeps the engine-per-adapter surface
(``serve/api.py``'s ``adapters=``) over one shared engine.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import math
import os
import re
import threading
import time
from contextlib import contextmanager

import numpy as np
import torch
from torch import nn

from llm_in_practise_tpu_torch.obs.hbm import get_ledger
from llm_in_practise_tpu_torch.peft.lora import LoRAConfig, stack_lora_tree

_BLOCK_RE = re.compile(r"blocks\.(\d+)\.(.*)")
_log = logging.getLogger(__name__)

# --- the thread-local context -----------------------------------------------

_TLS = threading.local()


@contextmanager
def lora_context(lora):
    """Push a dispatch context for the current thread (None pushes
    nothing: the base paths run)."""
    if lora is None:
        yield
        return
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(lora)
    try:
        yield
    finally:
        stack.pop()


def current_lora():
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


# --- the gathered delta and the model facade --------------------------------


def gathered_delta(lora, key: str, x: torch.Tensor):
    """The summed low-rank delta of projection ``key`` (a port name,
    ``blocks.3.attn.q_proj.kernel``) over the batch: per rank bucket
    ``((x @ A[idx]) @ B[idx]) * scale[idx]`` in f32, as (B, L, d_out) for
    an input of (B, ..., d_in). None when no loaded bucket carries the
    target."""
    m = _BLOCK_RE.match(key)
    delta = None
    for rb, bank in lora["banks"].items():
        idx = lora["idx"][rb]
        fac = layer = None
        if m is not None:
            fac = bank["stacked"].get("blocks.block." + m.group(2))
            layer = int(m.group(1))
        if fac is None:
            fac = bank["flat"].get(key)
            layer = None
        if fac is None:
            continue
        if layer is not None:
            ga = fac["a"][idx, layer]      # (B, d_in, rb)
            gb = fac["b"][idx, layer]      # (B, rb, d_out)
        else:
            ga = fac["a"][idx]
            gb = fac["b"][idx]
        xf = x.to(torch.float32).reshape(x.shape[0], -1, x.shape[-1])
        d = torch.bmm(torch.bmm(xf, ga), gb)
        d = d * bank["scale"][idx].reshape(-1, 1, 1)
        delta = d if delta is None else delta + d
    return delta


class LoRAProjection(nn.Module):
    """A projection module and, under a context, its adapters' delta:
    ``y = inner(x)``, then ``y + delta.to(y.dtype)``. With no context it
    calls ``inner`` and nothing else."""

    def __init__(self, inner: nn.Module, key: str):
        super().__init__()
        self.inner = inner
        self.key = key

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.inner(x)
        lora = current_lora()
        if lora is None:
            return y
        delta = gathered_delta(lora, self.key, x)
        if delta is None:
            return y
        return y + delta.reshape(y.shape).to(y.dtype)


class LoRAServingModel(nn.Module):
    """Model facade over a :class:`~..models.qwen3.Qwen3` or a
    :class:`~.quantized.QuantizedModel`: ``model(...)``, ``head``,
    ``init_cache``, ``config`` and ``device`` delegate to it, and every
    projection of the wrapped model becomes a :class:`LoRAProjection` (in
    place: a draft that is the same model shares the wrappers, and runs
    base while no context is set). ``inner`` is the wrapped model."""

    def __init__(self, model: nn.Module):
        from llm_in_practise_tpu_torch.models.qwen3 import Dense
        from llm_in_practise_tpu_torch.serve.quantized import QuantizedLinear

        super().__init__()
        root = getattr(model, "model", model)   # a QuantizedModel's Qwen3
        # a model served before keeps its wrappers (and their inner
        # modules, which are not wrapped again)
        projections = [(path, mod) for path, mod in root.named_modules()
                       if isinstance(mod, (Dense, QuantizedLinear))
                       and not path.endswith(".inner")]
        for path, mod in projections:
            parent, _, child = path.rpartition(".")
            setattr(root.get_submodule(parent) if parent else root, child,
                    LoRAProjection(mod, f"{path}.kernel"))
        self.inner = model

    @property
    def config(self):
        return self.inner.config

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def init_cache(self, *args, **kwargs):
        return self.inner.init_cache(*args, **kwargs)

    def head(self, x):
        return self.inner.head(x)

    def forward(self, *args, **kwargs):
        return self.inner(*args, **kwargs)


# --- the registry ------------------------------------------------------------


@dataclasses.dataclass
class _AdapterRec:
    name: str
    rb: int                     # rank bucket
    row: int                    # bank row
    ns: int                     # prefix-namespace generation (monotone)
    n_bytes: int                # f32 payload bytes at padded rank
    refcount: int = 0
    last_used: float = 0.0
    source: str | None = None


class _RankBucket:
    """One rank bucket's banks. Row 0 is reserved and all zeros: the row
    every base or idle row selects, so base rows of an adapter dispatch
    get a delta of exactly 0."""

    def __init__(self, rb: int, device):
        self.rb = rb
        self.device = device
        self.cap = 2                        # row 0 (zeros) + 1
        self.free: list[int] = [1]
        self.stacked: dict[str, dict] = {}  # key -> {"a", "b"} banks
        self.flat: dict[str, dict] = {}
        self.scale = torch.zeros((self.cap,), dtype=torch.float32,
                                 device=device)

    def banks(self) -> dict:
        """A snapshot of the bank tensors (new dicts, the same tensors)."""
        return {"stacked": dict(self.stacked), "flat": dict(self.flat),
                "scale": self.scale}

    def grow(self) -> None:
        """Double the capacity: new tensors (power-of-two ladder, so the
        twins are recaptured a bounded number of times)."""
        new_cap = self.cap * 2
        pad = new_cap - self.cap

        def wide(bank):
            return {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                    for k, v in bank.items()}

        self.stacked = {k: wide(v) for k, v in self.stacked.items()}
        self.flat = {k: wide(v) for k, v in self.flat.items()}
        self.scale = torch.cat([self.scale, self.scale.new_zeros((pad,))])
        self.free.extend(range(self.cap, new_cap))
        self.cap = new_cap

    def ensure_target(self, key: str, a_shape, b_shape,
                      stacked: bool) -> bool:
        """Banks hold the union of the targets: a new target gets zero rows
        for every adapter already loaded (their delta through it stays 0).
        Returns whether the key was new."""
        table = self.stacked if stacked else self.flat
        if key in table:
            return False
        table[key] = {
            "a": torch.zeros((self.cap,) + tuple(a_shape),
                             dtype=torch.float32, device=self.device),
            "b": torch.zeros((self.cap,) + tuple(b_shape),
                             dtype=torch.float32, device=self.device)}
        return True

    def zero_row(self, row: int) -> None:
        for table in (self.stacked, self.flat):
            for fac in table.values():
                fac["a"][row].zero_()
                fac["b"][row].zero_()
        self.scale[row] = 0.0


def load_adapter_tree(adapter_path: str, cfg):
    """Restore one ``adapter.msgpack`` and its sidecar (``save_named``'s
    layout, written by either package) without merging: returns the
    port's LoRA tree for the model of ``cfg`` and its
    :class:`~..peft.lora.LoRAConfig`."""
    from llm_in_practise_tpu_torch.ckpt.checkpoint import restore_checkpoint
    from llm_in_practise_tpu_torch.models.convert import lora_from_jax

    if os.path.isdir(adapter_path):
        adapter_path = os.path.join(adapter_path, "adapter.msgpack")
    tree, meta = restore_checkpoint(adapter_path)
    if "lora_config" not in meta:
        raise ValueError(
            f"{adapter_path} has no lora_config metadata sidecar")
    return lora_from_jax(tree, cfg), LoRAConfig.from_dict(meta["lora_config"])


class AdapterRegistry:
    """Rank-bucketed f32 factor banks and the adapters' lifecycle.

    ``model`` is the served model: its ``config`` gives the layer count
    and maps checkpoint names, its ``device`` holds the banks (JAX takes
    the base params). Loading stacks an adapter's layers
    (:func:`~..peft.lora.stack_lora_tree`) into one bank row of its rank
    bucket, the next power of two, the rank padded with zero columns (the
    delta is unchanged). Requests ``acquire`` / ``release`` refcounts;
    under ``max_bytes`` eviction takes only refcount-0 rows, LRU first.
    Every registration mints a fresh ``ns`` from a monotone counter: the
    engine keys its prefix caches by ``token + (ns << 32)``, so tenants
    never hit each other's KV and a re-registered name never hits its own
    stale KV. ``ns`` 0 is the base model's.

    Thread-safe: HTTP threads acquire while the engine thread reads
    dispatch arguments. Device writes take the lock :meth:`attach` gives
    (the engine's step lock) before the registry's own.
    """

    def __init__(self, model, *, max_bytes: int | None = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh is not ported to the PyTorch adapter registry yet: "
                "tensor-parallel bank placement (ROADMAP.md queue A item "
                "14)")
        self.cfg = model.config
        self.n_layer = self.cfg.n_layer
        self.device = model.device
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._device_lock: threading.Lock = threading.Lock()
        self._adapters: dict[str, _AdapterRec] = {}  # guarded-by: _lock
        self._buckets: dict[int, _RankBucket] = {}   # guarded-by: _lock
        self.bytes_loaded = 0                        # guarded-by: _lock
        # bank tensors replaced (a bucket made, grown, or given a target)
        self.generation = 0                          # guarded-by: _lock
        self.loads_total = 0                         # guarded-by: _lock
        self.evictions_total = 0                     # guarded-by: _lock
        self.swap_seconds_total = 0.0                # guarded-by: _lock
        self.swap_seconds: list[float] = []          # guarded-by: _lock
        self.tenant_tokens: dict[str, int] = {}      # guarded-by: _lock
        self._ns = itertools.count(1)

    def attach(self, device_lock: threading.Lock) -> None:
        """Make bank writes take ``device_lock`` (the engine's step lock)
        first: a registration then waits for the step in flight, and no
        capture or replay runs while a bank changes."""
        self._device_lock = device_lock

    # -- loading / eviction ---------------------------------------------------

    def register(self, name: str, adapter_path: str) -> None:
        """Hot-load one adapter checkpoint under ``name``."""
        lora, cfg = load_adapter_tree(adapter_path, self.cfg)
        self.register_tree(name, lora, cfg, source=adapter_path)

    def register_tree(self, name: str, lora: dict, cfg: LoRAConfig,
                      source: str | None = None) -> None:
        """Stack a LoRA tree (``{port name: {"a", "b"}}``) into the
        banks."""
        t0 = time.monotonic()
        tree = stack_lora_tree(lora, self.n_layer)
        rb = 1 << max(int(cfg.r) - 1, 0).bit_length()
        # f32 payload at the padded rank: what the bank row really costs
        n_bytes = 4 * sum(
            math.prod(ab["a"].shape) // ab["a"].shape[-1] * rb
            + math.prod(ab["b"].shape) // ab["b"].shape[-2] * rb
            for ab in tree.values())
        padded = {}
        for key, ab in tree.items():
            a = torch.as_tensor(ab["a"]).detach().to(torch.float32)
            b = torch.as_tensor(ab["b"]).detach().to(torch.float32)
            r = a.shape[-1]
            if r > rb:                   # cannot happen (rb = ceil pow2)
                raise ValueError(f"rank {r} exceeds bucket {rb}")
            padded[key] = (nn.functional.pad(a, (0, rb - r)),
                           nn.functional.pad(b, (0, 0, 0, rb - r)))
        with (self._device_lock, self._lock, torch.inference_mode(False),
              torch.no_grad()):
            old = self._adapters.get(name)
            if old is not None:
                if old.refcount > 0:
                    raise RuntimeError(
                        f"adapter {name!r} is busy ({old.refcount} "
                        "in-flight requests); drain before hot-swapping")
                self._evict_locked(old)
            self._reserve_bytes_locked(name, n_bytes)
            bucket = self._buckets.get(rb)
            if bucket is None:
                bucket = self._buckets[rb] = _RankBucket(rb, self.device)
                self.generation += 1
            row = self._take_row_locked(bucket)
            for key, (a, b) in padded.items():
                stacked = key.startswith("blocks.block.")
                if bucket.ensure_target(key, a.shape, b.shape, stacked):
                    self.generation += 1
                fac = (bucket.stacked if stacked else bucket.flat)[key]
                fac["a"][row].copy_(a)
                fac["b"][row].copy_(b)
            bucket.scale[row] = float(cfg.scaling)
            self._adapters[name] = _AdapterRec(
                name=name, rb=rb, row=row, ns=next(self._ns),
                n_bytes=n_bytes, last_used=time.monotonic(), source=source)
            self.bytes_loaded += n_bytes
            self.loads_total += 1
            get_ledger().book(f"adapters/r{rb}", n_bytes)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)   # the swap's cost
            dt = time.monotonic() - t0
            self.swap_seconds_total += dt
            self.swap_seconds.append(dt)

    def _take_row_locked(self, bucket: _RankBucket) -> int:
        if not bucket.free:
            bucket.grow()
            self.generation += 1
        row = bucket.free.pop()
        # a recycled row holds the previous tenant's factors until the new
        # writes land: zero every target, so an adapter that lacks one
        # cannot inherit a stale delta through it
        bucket.zero_row(row)
        return row

    def _reserve_bytes_locked(self, name: str, n_bytes: int) -> None:
        if self.max_bytes is None:
            return
        while self.bytes_loaded + n_bytes > self.max_bytes:
            victim = min(
                (r for r in self._adapters.values() if r.refcount == 0),
                key=lambda r: r.last_used, default=None)
            if victim is None:
                raise RuntimeError(
                    f"adapter byte budget exhausted loading {name!r}: "
                    f"{self.bytes_loaded + n_bytes} > {self.max_bytes} "
                    "and every loaded adapter has in-flight requests")
            _log.info("evicting adapter %s under byte pressure (%d bytes)",
                      victim.name, victim.n_bytes)
            self._evict_locked(victim)
            self.evictions_total += 1
            get_ledger().note_reclaim(f"adapters/r{victim.rb}", "budget")

    def _evict_locked(self, rec: _AdapterRec) -> None:
        """Free ``rec``'s row (zeroed when it is taken again) and its
        bytes, in the registry and in the ledger."""
        self._adapters.pop(rec.name, None)
        self._buckets[rec.rb].free.append(rec.row)
        self.bytes_loaded -= rec.n_bytes
        get_ledger().book(f"adapters/r{rec.rb}", -rec.n_bytes)

    def evict(self, name: str) -> bool:
        """Explicit unload; refuses while requests are in flight."""
        with self._lock:
            rec = self._adapters.get(name)
            if rec is None:
                return False
            if rec.refcount > 0:
                raise RuntimeError(
                    f"adapter {name!r} has {rec.refcount} in-flight "
                    "requests")
            self._evict_locked(rec)
            self.evictions_total += 1
            return True

    # -- request lifecycle ----------------------------------------------------

    def acquire(self, name: str) -> None:
        with self._lock:
            rec = self._adapters.get(name)
            if rec is None:
                raise KeyError(name)
            rec.refcount += 1
            rec.last_used = time.monotonic()

    def release(self, name: str) -> None:
        with self._lock:
            rec = self._adapters.get(name)
            if rec is not None and rec.refcount > 0:
                rec.refcount -= 1

    def note_tokens(self, name: str, n: int) -> None:
        """Book ``n`` generated tokens to tenant ``name``."""
        if n <= 0:
            return
        with self._lock:
            self.tenant_tokens[name] = self.tenant_tokens.get(name, 0) + n

    def ns_of(self, name: str | None) -> int:
        """Prefix-namespace generation of ``name`` (0 = base)."""
        if name is None:
            return 0
        with self._lock:
            rec = self._adapters.get(name)
            return rec.ns if rec is not None else 0

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._adapters)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._adapters

    # -- dispatch -------------------------------------------------------------

    def dispatch_args(self, adapters: list[str | None]):
        """The dispatch arguments of a batch whose rows run ``adapters``
        (None = base, row 0): ``{"idx": {rank bucket: (B,) int64 numpy
        rows}, "banks": {rank bucket: bank snapshot}, "generation": g}``,
        or None when every row is base (the base paths run). Each adapter
        selects its row in its own bucket and row 0 in the others."""
        with self._lock:
            recs = [self._adapters.get(a) if a is not None else None
                    for a in adapters]
            if all(r is None for r in recs):
                return None
            idx, banks = {}, {}
            for rb, bucket in sorted(self._buckets.items()):
                rows = np.zeros((len(adapters),), np.int64)
                for i, rec in enumerate(recs):
                    if rec is not None and rec.rb == rb:
                        rows[i] = rec.row
                idx[rb] = rows
                banks[rb] = bucket.banks()
            return {"idx": idx, "banks": banks,
                    "generation": self.generation}

    # -- introspection --------------------------------------------------------

    def bank_bytes(self) -> dict[int, int]:
        """Device bytes of each bucket's banks (capacity, not payload)."""
        with self._lock:
            out = {}
            for rb, b in self._buckets.items():
                t = [b.scale] + [fac[p] for table in (b.stacked, b.flat)
                                 for fac in table.values() for p in "ab"]
                out[rb] = sum(x.numel() * x.element_size() for x in t)
            return out

    def stats(self) -> dict:
        """A point-in-time snapshot (the JAX registry's /metrics view)."""
        with self._lock:
            return {
                "loaded": len(self._adapters),
                "bytes_loaded": self.bytes_loaded,
                "max_bytes": self.max_bytes,
                "loads_total": self.loads_total,
                "evictions_total": self.evictions_total,
                "swap_seconds_total": self.swap_seconds_total,
                "tenant_tokens": dict(self.tenant_tokens),
                "refcounts": {n: r.refcount
                              for n, r in self._adapters.items()},
                "buckets": {rb: {"cap": b.cap, "free": len(b.free)}
                            for rb, b in self._buckets.items()},
                "generation": self.generation,
            }


def lora_scope(args, device):
    """``with lora_scope(args, device):`` runs an eager dispatch under the
    adapters of ``args`` (:meth:`AdapterRegistry.dispatch_args`, its rows
    moved to ``device``), or as the base model when it is None."""
    if args is None:
        return contextlib.nullcontext()
    return lora_context({"idx": {rb: torch.from_numpy(rows).to(device)
                                 for rb, rows in args["idx"].items()},
                         "banks": args["banks"]})


# --- the engine-per-adapter surface ------------------------------------------


class AdapterHandle:
    """Engine-shaped view of one adapter on a shared engine: what
    ``serve/api.py``'s ``adapters=`` holds. ``submit`` and ``generate``
    pin the adapter's name; everything else proxies to the engine."""

    def __init__(self, engine, name: str):
        self._engine = engine
        self.adapter_name = name

    def submit(self, prompt_ids, params=None, **kw):
        kw.setdefault("adapter", self.adapter_name)
        return self._engine.submit(prompt_ids, params, **kw)

    def generate(self, prompt_ids, params=None, **kw):
        kw.setdefault("adapter", self.adapter_name)
        return self._engine.generate(prompt_ids, params, **kw)

    def start(self):
        # the shared engine's loop may already run (a second loop would
        # race the slot tables)
        eng = self._engine
        if eng._thread is None or not eng._thread.is_alive():
            eng.start()

    def __getattr__(self, item):
        return getattr(self._engine, item)
