"""Continuous-batching inference engine.

Port of ``llm_in_practise_tpu/serve/engine.py``:

- **Slot-based KV cache**, in one of two layouts: ``"contiguous"``, one
  ``(max_slots, cache_len, n_kv_head, head_dim)`` buffer pair per layer,
  or ``"paged"``, a page pool behind per-slot block tables
  (:mod:`.paged_kv`). Requests are admitted into free slots mid-flight;
  every step decodes all slots in one batched forward.
- **Per-slot positions**: the host keeps each slot's depth and hands the
  forward a ``(max_slots,)`` index vector; writes land per slot and the
  causal mask uses per-slot offsets.
- **Per-slot sampling params** through
  :func:`~llm_in_practise_tpu_torch.infer.sampling.sample_token_batched`,
  drawing from the engine's own ``torch.Generator``.
- **Batched prefill**: admitted prompts prefill together, right-padded to
  the longest one (PyTorch runs eagerly, so the JAX package's compile
  buckets have no purpose here), and their KV rows are copied into their
  slots.
- **Scheduling** (JAX ``engine.py`` ``_advance_prefills``,
  ``_plan_block``, ``_mixed_dispatch``, ``_step_locked``): chunked
  prefill straight into the slot, multi-step decode blocks, the fused
  mixed step and admission control, over the shared bodies of
  :mod:`.mixed_step`; on the card each decode block and fused step is one
  CUDA graph replay (:mod:`.graphs`).
- **Paged KV** (JAX ``engine.py:1436-1877`` and the paged host paths):
  admission reserves the pages a prompt needs, decode grows a slot a
  page at a time, a dry pool preempts the youngest slot by recompute,
  and each paged step gathers the slots' pages into a transient view,
  runs the unchanged step body on it and scatters the fresh rows back.
- **Prefix caching**: the paged layout shares physical pages through
  :class:`~.prefix_cache.PagedPrefixIndex` (copy-on-write); the
  contiguous layout copies rows through :class:`~.prefix_cache.PrefixCache`.
- **Speculative decoding** (JAX ``engine.py`` ``_try_speculative`` and
  the draft-model paths): ``k`` tokens per slot drafted by prompt lookup
  (ngram) or by a draft model with its own contiguous cache, verified
  with the block's remaining greedy steps in one fused round
  (:func:`~.mixed_step.spec_verify_block`), in either KV layout.
- **Structured output** (JAX ``engine.py`` "grammar" sections): a request
  whose ``SamplingParams.constraint`` holds a compiled
  :class:`~.constrain.TokenAutomaton` gets a grammar cursor at
  activation; every step stages each constrained slot's mask row on the
  host and runs the masked twin of its path (decode block, fused mixed
  step or spec round), so a constrained step is still one dispatch.
  While a ready slot is constrained a block is one token long, and a
  spec round has no extension.
- **Batched multi-LoRA** (JAX ``engine.py`` "multi-LoRA" sections): with
  an :class:`~.multi_lora.AdapterRegistry` the model is wrapped in
  :class:`~.multi_lora.LoRAServingModel`; a request may name an adapter
  at ``submit``, which holds a refcount on it until the request finishes
  (a preemption's requeue keeps it). Every dispatch whose rows include an
  adapter runs its path's adapter twin: the one-shot prefill batch takes
  one bank row per request, the single-slot chunk and the paged suffix
  their slot's row (a one-row index), and the batched chunk, the mixed
  step, the decode block and the spec verify the slot plane. The draft
  model's catch-up and roll run base. Prefix-cache keys are shifted by
  the adapter's namespace (``token + (ns << 32)``) in both layouts.
- **KV tiers** (JAX ``engine.py`` ``kv_pool`` sections): with a
  :class:`~.kv_pool.TieredKV` every finished prefill's entry is written
  through to the host pool (and the pool server), a contiguous L1's
  evictions offload there, and admission cascades to the tiers on an L1
  miss, promoting the hit.
- **Disaggregated prefill/decode** (JAX ``engine.py`` ``role`` /
  ``handoff`` sections, :mod:`.disagg`): a ``role="prefill"`` engine
  finishes a request carrying a ``handoff_id`` at the end of its prefill,
  and publisher threads copy its KV to the host and publish it; a
  ``role="decode"`` engine admits a claimed entry (``submit(kv_entry=)``)
  as a full prefix hit.
- **Sessions** (JAX ``engine.py`` "session" sections, :mod:`.sessions`):
  with a :class:`~.sessions.SessionStore`, a request carrying a
  ``session_id`` pins its conversation's full pages under that id when
  it finishes (and, with a handoff store, publishes a page-aligned entry
  for the fleet); admission takes a fleet-pulled entry ahead of a
  shorter page-index hit. Every request carries its admission's cache
  outcome (``hit`` / ``partial`` / ``cold``).
- **HBM ledger** (:mod:`..obs.hbm`): the engine books its weights, its
  contiguous or draft caches at build and returns every byte at
  :meth:`InferenceEngine.stop`; the page pool, the adapter registry and
  the store book their own.
- **The tracer and the device plane** (JAX ``engine.py`` ``_trace_phase``,
  ``_note_device_phase``, ``steptrace`` and the critical path): a request
  submitted with a ``trace`` context gets its phase spans
  (``engine.queue_wait``, ``engine.admit``, ``engine.prefill_chunk``,
  ``engine.decode``, ``handoff.publish``) in the engine's
  :class:`~..obs.trace.Tracer`; every ``step()`` is one record of the
  :class:`~..obs.steptrace.StepTrace`, its wall time split between named
  host activities and the card's time; each dispatch books its phase's
  tokens, MFU and HBM-bandwidth use (:class:`~..obs.cost.CostModel`) in
  the :class:`~..obs.meter.DispatchMeter`; every finished request's wall
  time splits into critical-path segments (``GET /debug/requests``), and
  its TTFT and TPOT go into histograms and the SLO goodput meter. The
  device time of a dispatch is the card's: a pair of CUDA events around
  it, read after the fetch the engine already makes (the eager chunk
  paths, which fetch nothing, wait on their end event), clamped to the
  dispatch window's wall time; on the CPU it is that wall time.

Threading: HTTP handler threads call :meth:`InferenceEngine.submit`,
which touches no tensor; one background thread runs :meth:`step` and
does all device work. Tokens stream to per-request queues.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import queue
import threading
import time
import weakref
from collections import deque
from typing import Any

import numpy as np
import torch

from llm_in_practise_tpu_torch.infer.generate import max_positions
from llm_in_practise_tpu_torch.infer.sampling import sample_token_batched
from llm_in_practise_tpu_torch.obs import debug
from llm_in_practise_tpu_torch.obs.cost import CostModel, tree_bytes
from llm_in_practise_tpu_torch.obs.hbm import get_ledger, host_entry_bytes
from llm_in_practise_tpu_torch.obs.meter import DispatchMeter, GoodputMeter
from llm_in_practise_tpu_torch.obs.prof import (
    CompileMeter,
    unwatch_builds,
    watch_builds,
)
from llm_in_practise_tpu_torch.obs.registry import HistogramAccumulator
from llm_in_practise_tpu_torch.obs.steptrace import StepTrace
from llm_in_practise_tpu_torch.obs.trace import get_tracer
from llm_in_practise_tpu_torch.models.layers import to_kv_dtype
from llm_in_practise_tpu_torch.serve import kv_pool as kvp
from llm_in_practise_tpu_torch.serve.disagg import (
    rows_mismatch,
    usable_for_engine,
    validate_roles,
)
from llm_in_practise_tpu_torch.serve.graphs import CAPTURE_LOCK, StepGraphs
from llm_in_practise_tpu_torch.serve.mixed_step import (
    batched_chunk,
    plan_decode_block,
    plan_spec_extension,
)
from llm_in_practise_tpu_torch.serve.multi_lora import (
    LoRAServingModel,
    lora_scope,
)
from llm_in_practise_tpu_torch.serve.paged_kv import (
    PagedHit,
    PagedKV,
    gather_view,
    kv_row_bytes,
    pages_for,
    scatter_window,
    window_idx,
)
from llm_in_practise_tpu_torch.serve.prefix_cache import (
    PagedPrefixIndex,
    PrefixCache,
    PrefixEntry,
    slice_cache_rows,
)

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (OpenAI request fields)."""

    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # >= 1.0 = disabled
    greedy: bool = False
    max_tokens: int = 128
    # structured output: a compiled constrain.TokenAutomaton (shared
    # across requests with the same schema); None = unconstrained, and
    # the unmasked step paths run untouched
    constraint: Any = None


_FINISH = object()  # sentinel closing a request's token queue
_UNSET = object()   # "not looked up yet" (a prefix hit may be None)

# Per-request critical-path segments (JAX engine.py:87-101): a finished
# request's wall time splits into these (GET /debug/requests, and
# llm_request_critical_path_seconds_total{segment}). ``host_gap`` is the
# residual no attributed segment claims; ``stream_flush`` is the API's
# SSE write tail, measured on the handler thread concurrently with
# decode, so it is reported beside the engine segments but outside the
# wall-clock partition.
CP_SEGMENTS = ("queue_wait", "admission", "prefill_dispatch",
               "decode_dispatch", "host_gap", "handoff_wire",
               "preempt_recompute", "stream_flush")
# a re-admission after a preemption pays these again: they are charged
# to preempt_recompute
_CP_RECOMPUTE_SEGS = frozenset(
    ("queue_wait", "admission", "prefill_dispatch"))


class EngineDeadError(RuntimeError):
    """The engine loop died while a request waited on its token queue."""


@dataclasses.dataclass
class Request:
    """A submitted generation request and its streaming output channel."""

    uid: int
    prompt_ids: list[int]
    params: SamplingParams
    tokens: "queue.Queue[Any]" = dataclasses.field(default_factory=queue.Queue)
    submit_time: float = dataclasses.field(default_factory=time.monotonic)
    first_token_time: float | None = None
    finish_time: float | None = None
    finish_reason: str | None = None
    n_generated: int = 0
    # every emitted token id, in order (the queue above is consumed by the
    # reader; this list stays for accounting and checks)
    output_ids: list[int] = dataclasses.field(default_factory=list)
    engine: "InferenceEngine | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    # paged preemption by recompute: the request re-enters the queue with
    # ``prompt_ids`` extended to everything already emitted but the last
    # token, ``resume_last`` holding that token (its KV is the next
    # decode's to write) and ``resume_budget`` the tokens still owed;
    # re-admission resumes decoding without emitting or sampling
    resume_last: int | None = dataclasses.field(
        default=None, repr=False, compare=False)
    resume_budget: int = dataclasses.field(
        default=0, repr=False, compare=False)
    # the live grammar cursor (constrain.ConstraintState), minted from
    # params.constraint at first activation; it rides the request through
    # a preemption's requeue, so the resumed stream continues from its
    # grammar position
    constraint_state: Any = dataclasses.field(
        default=None, repr=False, compare=False)
    # the adapter this request decodes under (None = the base model); the
    # registry holds a refcount on it from submit until the request
    # finishes, through a preemption's requeue
    adapter: str | None = None
    # True while this request holds that refcount (set by submit, cleared
    # by _record_finished)
    adapter_ref: bool = dataclasses.field(
        default=False, repr=False, compare=False)
    # disaggregated serving: a claimed, validated handoff entry (a
    # kv_pool.HostEntry) that admission inserts as a full prefix hit;
    # ``handoff_id`` marks a prefill-role request, which publishes its
    # prompt KV under that id and finishes ("handoff") instead of decoding
    kv_entry: Any = dataclasses.field(default=None, repr=False,
                                      compare=False)
    handoff_id: str | None = None
    # the conversation handle (serve/sessions.py): on finish the slot's
    # full pages are pinned under it in the engine's SessionStore, and
    # admission consults the store's pending fleet pulls under it
    session_id: str | None = None
    # the prefix / handoff / session hit outcome at FIRST admission
    # ("hit" | "partial" | "cold"): the label of llm_session_turns_total
    # and of llm_ttft_seconds{cache}
    cache_outcome: str | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # the TraceContext the API minted for this request: the engine parents
    # its phase spans to it (None: nothing is recorded)
    trace: Any = dataclasses.field(default=None, repr=False, compare=False)
    # critical-path seconds by segment (CP_SEGMENTS). Writers are
    # phase-exclusive (the HTTP thread at submit, the engine thread while
    # slotted, the publisher at publish, the API thread after the stream
    # closes), so no lock is needed
    cp: dict = dataclasses.field(default_factory=dict, repr=False,
                                 compare=False)
    # stamped by a preemption: the re-admission's segments are charged to
    # preempt_recompute from here on
    requeue_time: float | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # origin of the next queue_wait interval: re-armed at every queue pop
    # and by a preemption, so N requeues book N disjoint waits
    cp_queue_origin: float | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def cp_add(self, seg: str, dt: float) -> None:
        """Add ``dt`` seconds to critical-path segment ``seg``; after a
        preemption the re-paid admission segments go to
        ``preempt_recompute``."""
        if self.requeue_time is not None and seg in _CP_RECOMPUTE_SEGS:
            seg = "preempt_recompute"
        self.cp[seg] = self.cp.get(seg, 0.0) + float(dt)

    def next_item(self, poll_s: float = 1.0):
        """Next queue item: a token id or the finish sentinel. The wait is
        bounded: between polls the engine's liveness is checked, so a dead
        engine raises :class:`EngineDeadError` instead of blocking."""
        while True:
            try:
                return self.tokens.get(timeout=poll_s)
            except queue.Empty:
                if self.engine is not None and not self.engine.is_alive():
                    raise EngineDeadError(
                        "engine loop is not running; request "
                        f"{self.uid} will never finish") from None

    def __iter__(self):
        """Yield generated token ids until the request finishes."""
        while True:
            item = self.next_item()
            if item is _FINISH:
                return
            yield item

    def result(self) -> list[int]:
        return list(self)

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def tpot_s(self) -> float | None:
        """Mean time per output token after the first."""
        if self.finish_time is None or self.n_generated < 2:
            return None
        return ((self.finish_time - self.first_token_time)
                / (self.n_generated - 1))


class EngineStats:
    """The counters and histograms ``/metrics`` reads (JAX
    ``EngineStats``). Counters are written from HTTP threads (submit,
    sheds, stream tails), the engine thread (admission, finishes) and the
    publishers, under ``lock``; the histograms carry their own locks.
    TTFT and TPOT are fixed-bucket histograms (O(1) memory), TTFT also
    split by the admission's cache outcome."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests_total = 0          # guarded-by: lock
        self.tokens_generated_total = 0  # guarded-by: lock
        self.queue_depth = 0             # guarded-by: lock
        self.active_slots = 0            # guarded-by: lock
        self.requests_shed = 0           # guarded-by: lock
        self.ttft = HistogramAccumulator()
        self.tpot = HistogramAccumulator()
        self.ttft_by_cache = {k: HistogramAccumulator()
                              for k in ("hit", "partial", "cold")}
        # llm_request_critical_path_seconds_total{segment}
        self.critical_path = {seg: 0.0 for seg in CP_SEGMENTS}  # guarded-by: lock
        # SLO goodput: inert until thresholds are configured
        self.goodput = GoodputMeter()

    def note_stream_flush(self, dt: float) -> None:
        """Book a stream's SSE write tail (API handler thread) into the
        critical-path aggregate: it arrives after the engine finished the
        request."""
        with self.lock:
            self.critical_path["stream_flush"] += float(dt)

    def critical_path_snapshot(self) -> dict:
        with self.lock:
            return dict(self.critical_path)

    def observe_finished(self, req: Request) -> None:
        with self.lock:
            self.tokens_generated_total += req.n_generated
        if req.ttft_s is not None:
            self.ttft.observe(req.ttft_s)
            acc = self.ttft_by_cache.get(req.cache_outcome or "cold")
            (acc or self.ttft_by_cache["cold"]).observe(req.ttft_s)
        if req.tpot_s is not None:
            self.tpot.observe(req.tpot_s)
        if self.goodput.enabled and req.finish_reason != "queue_full":
            # sheds are counted apart (requests_shed, the 429s)
            self.goodput.observe(
                tokens=req.n_generated, ttft_s=req.ttft_s,
                tpot_s=req.tpot_s,
                trace_id=getattr(req.trace, "trace_id", None))


class _DeviceWindow:
    """One dispatch's window: its wall time on the engine thread, and on
    the card a pair of CUDA events on the engine's stream, recorded
    outside any capture. :meth:`launched` records the end event after the
    last launch; :meth:`close`, called after the fetch the engine makes
    anyway, reads the card's time (clamped to the window's wall time, so
    a step record stays a partition); on the CPU the device time is the
    wall time."""

    __slots__ = ("t0", "start", "end")

    def __init__(self, timed: bool):
        self.t0 = time.perf_counter()
        self.start = self.end = None
        if timed:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

    def launched(self) -> None:
        if self.start is not None and self.end is None:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record()

    def close(self) -> tuple[float, float]:
        """``(device seconds, wall seconds)`` of the window."""
        wall = time.perf_counter() - self.t0
        if self.start is None:
            return wall, wall
        self.launched()
        # complete already after a fetch; an eager chunk that fetched
        # nothing waits here for its last kernel
        self.end.synchronize()
        return min(self.start.elapsed_time(self.end) / 1e3, wall), wall


def _kv_bytes(cache) -> int:
    """Device bytes of a contiguous cache's K and V buffers (its per-layer
    index vectors are not KV)."""
    return sum(buf.numel() * buf.element_size() for layer in cache
               for key, buf in layer.items() if key != "index")


def _release_books(ledger, booked: dict) -> None:
    """Return every byte an engine booked (the dict empties: a second call
    frees nothing)."""
    for owner, n in booked.items():
        ledger.book(owner, -n)
    booked.clear()


def _shares_weights(a, b) -> bool:
    """Whether modules ``a`` and ``b`` hold any parameter storage in
    common (a target serving as its own draft)."""
    return bool({p.data_ptr() for p in a.parameters()}
                & {p.data_ptr() for p in b.parameters()})


def _not_ported(knob: str, item: int, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob} is not ported to the PyTorch engine yet: {what} "
        f"(ROADMAP.md queue A item {item})")


class InferenceEngine:
    """Continuous-batching decode loop over a slot-structured KV cache.

    ``model`` exposes ``config``, ``device``, ``init_cache(batch, max_len,
    dtype)``, ``head(hidden)`` and ``model(idx, cache=, return_hidden=)``,
    as :class:`~..models.qwen3.Qwen3` and
    :class:`~.quantized.QuantizedModel` do. Knobs of the JAX engine that
    this port does not have yet raise ``NotImplementedError``.

    Scheduling, as in the JAX engine (contiguous layout):

    - ``chunked_prefill``: a prompt longer than this many tokens (or one
      whose one-shot prefill would not fit) prefills one chunk per step,
      written straight into its slot, while the other slots decode;
      several mid-prefill prompts advance together in one batched chunk.
      ``prefill_budget`` chunks run per step before any decode.
    - ``decode_steps``: up to this many tokens per decode block, one
      dispatch (:func:`~.mixed_step.plan_decode_block` picks ``n``).
    - ``mixed_step``: while prompts are mid-prefill and slots decode, one
      fused dispatch runs the chunk and the decode block.
    - ``max_queue`` / ``queue_timeout_s``: admission control; a shed
      request finishes at once with ``finish_reason="queue_full"`` and no
      tokens.

    - ``kv_layout``: ``"contiguous"`` or ``"paged"`` (``kv_page_size``
      tokens per page, a pool of ``kv_pool_tokens``, by default
      ``max_slots * cache_len``). A paged prompt that can never fit the
      pool finishes at submit with ``finish_reason="too_large"``.
    - ``prefix_cache``: ``True`` or a :class:`~.prefix_cache.PrefixCache`
      (its budget knobs carry over to the paged index).
    - ``speculative_k``: draft this many tokens per greedy slot, by
      prompt lookup over the trailing ``speculative_ngram``-gram, or with
      ``draft_model`` (a model as ``model``, with its own contiguous
      cache of ``max_slots x cache_len``; an explicit ``kv_pool_tokens``
      gives up the draft cache's bytes in target tokens), and verify them
      with the planned block's remaining steps in one fused round.
      Sampled slots and slots near the cache's end take the plain path.
      While a prompt is mid-prefill, ``decode_steps`` 1 keeps
      speculating; a longer block runs the fused mixed step instead.

    - ``adapter_registry``: an :class:`~.multi_lora.AdapterRegistry`
      whose adapters requests name at :meth:`submit`; slots under
      different adapters, and base slots, share each dispatch.
    - ``kv_pool``: a :class:`~.kv_pool.TieredKV` (or any object with its
      ``lookup`` / ``offload`` / ``offload_on_put``) behind the prefix
      cache, which it turns on.
    - ``role`` (``"prefill"``, ``"decode"`` or ``"both"``) and ``handoff``
      (a :class:`~.disagg.LocalHandoff` or :class:`~.disagg.RemoteHandoff`,
      which a prefill engine needs): the disaggregated split. A decode
      replica that has to prefill anyway (a lost or mismatched entry)
      counts it in ``local_prefills`` and logs it once.
    - ``session_store``: a :class:`~.sessions.SessionStore` that requests
      name at :meth:`submit` (``session_id``); attached after the page
      pool, the prefix index and the handoff store, which it reads.
    - ``tracer`` (default: the process tracer, :func:`~..obs.trace.get_tracer`)
      records the phase spans of requests submitted with a ``trace``;
      ``steptrace`` (default: a new :class:`~..obs.steptrace.StepTrace`,
      off under ``LLM_TPU_STEPTRACE=off``) records each step;
      ``ttft_slo_s`` / ``tpot_slo_s`` turn on the SLO goodput meter
      (``stats.goodput``).

    On the card each decode block, each fused mixed step, each spec round
    and each draft roll is one CUDA graph replay (:mod:`.graphs`), and
    each of them but the roll has an adapter twin.
    """

    def __init__(self, model, *, max_slots: int = 8, cache_len: int = 512,
                 eos_id: int | None = None, cache_dtype=torch.bfloat16,
                 seed: int = 0, prefix_cache=None,
                 chunked_prefill: int | None = None, mesh=None,
                 speculative_k: int | None = None,
                 speculative_ngram: int = 3, draft_model=None,
                 decode_steps: int = 1, prefill_budget: int = 1,
                 mixed_step: bool = True, kv_layout: str = "contiguous",
                 kv_page_size: int = 16, kv_pool_tokens: int | None = None,
                 adapter_registry=None, kv_pool=None, role: str = "both",
                 handoff=None, session_store=None,
                 max_queue: int | None = None,
                 queue_timeout_s: float | None = None, tracer=None,
                 steptrace: StepTrace | None = None,
                 ttft_slo_s: float | None = None,
                 tpot_slo_s: float | None = None):
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"kv_layout must be 'contiguous' or 'paged', "
                             f"got {kv_layout!r}")
        if mesh is not None:
            raise _not_ported("mesh", 14, "sharded serving")
        validate_roles(role)
        if role == "prefill" and handoff is None:
            raise ValueError(
                "role='prefill' needs a handoff store to publish KV into "
                "(serve.disagg.LocalHandoff or RemoteHandoff)")
        if chunked_prefill is not None and chunked_prefill < 1:
            raise ValueError(
                f"chunked_prefill must be >= 1, got {chunked_prefill}")
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got {decode_steps}")
        if prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {prefill_budget}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if queue_timeout_s is not None and queue_timeout_s <= 0:
            raise ValueError(
                f"queue_timeout_s must be > 0, got {queue_timeout_s}")
        # batched multi-LoRA: wrap the model before anything below takes
        # it (the graphs' bodies, the page pool); with no adapter context
        # set the wrapped projections run exactly the base ops
        self.adapter_registry = adapter_registry
        if adapter_registry is not None:
            model = LoRAServingModel(model)
        self.model = model
        self.device = model.device
        self.max_slots = max_slots
        # the model's position table (RoPE's max_seq_len, a GPT's
        # seq_len): no slot may index past it
        limit = max_positions(model.config)
        self.cache_len = min(cache_len, limit) if limit else cache_len
        self.eos_id = eos_id
        self.cache_dtype = cache_dtype
        self.chunked_prefill = chunked_prefill
        self.decode_steps = decode_steps
        self.prefill_budget = prefill_budget
        self.mixed_step = bool(mixed_step)
        self.max_queue = max_queue
        self.queue_timeout_s = queue_timeout_s
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # KV layout: the contiguous cache, or the page pool (no contiguous
        # cache exists then: every paged step gathers a transient view)
        self.paged: PagedKV | None = None
        self.cache = None
        self.draft_kv_reserved_tokens = 0
        if kv_layout == "paged":
            pool_request = (kv_pool_tokens if kv_pool_tokens is not None
                            else max_slots * self.cache_len)
            if draft_model is not None and kv_pool_tokens is not None:
                # an explicit pool is the operator's KV byte budget: the
                # draft's contiguous cache beside the pool comes out of
                # it, in tokens at the target's bytes per row (the
                # default pool reserves the worst case and cannot
                # over-admit, so nothing is deducted there)
                drow = kv_row_bytes(draft_model, cache_dtype)
                trow = kv_row_bytes(model, cache_dtype)
                self.draft_kv_reserved_tokens = -(
                    -max_slots * self.cache_len * drow // trow)
                pool_request -= self.draft_kv_reserved_tokens
                if pool_request < 2 * kv_page_size:
                    raise ValueError(
                        f"kv_pool_tokens={kv_pool_tokens} leaves only "
                        f"{pool_request} tokens after the draft cache's "
                        f"{self.draft_kv_reserved_tokens}-token "
                        "equivalent reservation — raise the pool budget "
                        "or drop the draft model")
            self.paged = PagedKV(
                model, max_slots=max_slots, cache_len=self.cache_len,
                page_size=kv_page_size, pool_tokens=pool_request,
                dtype=cache_dtype)
        else:
            self.cache = model.init_cache(max_slots, self.cache_len,
                                          dtype=cache_dtype)
        self.preemptions = 0            # paged pool-pressure preemptions
        self.rejected_too_large = 0     # prompts that can NEVER fit the pool
        self._paged_admit_blocked = False
        # prefix caching (vLLM APC): the paged layout shares physical
        # pages through the page index, whose LRU the pool reclaims from
        # before admission fails; the contiguous layout copies rows. KV
        # tiers sit behind an L1, so a kv_pool turns it on
        if self.paged is not None:
            idx = None
            if prefix_cache or kv_pool is not None:
                kw = {}
                if isinstance(prefix_cache, PrefixCache):
                    kw = dict(max_tokens=prefix_cache.max_tokens,
                              min_prefix=prefix_cache.min_prefix)
                idx = PagedPrefixIndex(self.paged.pool, **kw)
                self.paged.pool.reclaim = idx.evict_pages
            self.prefix_cache = idx
        elif prefix_cache is True or (not prefix_cache
                                      and kv_pool is not None):
            self.prefix_cache = PrefixCache()
        else:
            self.prefix_cache = prefix_cache or None
        # tiered offload (LMCache): a contiguous L1's evictions flow into
        # the tiers, after the caller's own hook; with write-through on
        # the entry went down at prefill already. Paged engines feed the
        # tiers by write-through only (an evicted shared page has no
        # token key of its own)
        self.kv_pool = kv_pool
        if (kv_pool is not None and self.prefix_cache is not None
                and self.paged is None):
            prior = self.prefix_cache.on_evict

            def _evict(key, entry, _prior=prior):
                if _prior is not None:
                    _prior(key, entry)
                if not kv_pool.offload_on_put:
                    kv_pool.offload(list(key), entry)

            self.prefix_cache.on_evict = _evict
        # disaggregated serving (serve/disagg.py): a prefill replica's
        # publishes run on a pool of publisher threads (the copy to the
        # host and the store's put stall only the waiting handoff
        # request, never the step loop); a decode replica's local
        # prefills are counted
        self.role = role
        self.handoff = handoff
        self.handoff_published = 0      # guarded-by: _publish_lock
        self.handoff_publish_failed = 0  # guarded-by: _publish_lock
        self._publish_lock = threading.Lock()
        self._publish_queue: "queue.Queue" = queue.Queue()
        self._publishers: list[threading.Thread] = []
        self._n_publishers = min(4, max_slots)
        self.kv_admitted = 0            # requests seeded by a claimed entry
        self.kv_rejected = 0            # claimed entries that failed checks
        self.local_prefills = 0         # prefills a decode replica ran
        self._decode_prefill_logged = False
        # session-native serving (serve/sessions.py): attached after the
        # paged, prefix and handoff wiring above, which attach() reads;
        # the store chains into the page pool's reclaim hook after the
        # page index, so pins yield to active slots
        self.session_store = session_store
        if session_store is not None:
            session_store.attach(self)
        # speculative decoding (JAX engine.py:619-703): the counters count
        # real drafted positions only (padding and undrafted slots in
        # neither); rounds are spec dispatches and round tokens what they
        # committed
        if speculative_k is not None and speculative_k < 1:
            raise ValueError(
                f"speculative_k must be >= 1, got {speculative_k}")
        self.speculative_k = speculative_k
        self.speculative_ngram = speculative_ngram
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rounds = 0
        self.spec_round_tokens = 0
        self._spec_suspended_logged = False
        # the draft model keeps its own contiguous cache; _draft_sync is
        # how much of each slot's history it holds, re-synced lazily (a
        # catch-up of at most _draft_window tokens inside the roll,
        # chunks of that width before it for a wider gap)
        self.draft_model = draft_model
        self.draft_cache = None
        self._draft_window = None
        if draft_model is not None:
            if speculative_k is None:
                raise ValueError(
                    "draft_model needs speculative_k (the proposal len)")
            # every use pins its own index (the roll, the catch-up view)
            self.draft_cache = draft_model.init_cache(
                max_slots, self.cache_len, dtype=cache_dtype)
            self._draft_sync = np.zeros((max_slots,), np.int64)
            self._draft_uid = np.full((max_slots,), -1, np.int64)
            # the largest normal re-sync: a fully accepted round (k + 1
            # verify tokens and the decode_steps - 1 extension) or a
            # plain block
            self._draft_window = max(
                16, 1 << (speculative_k + decode_steps - 1).bit_length())
        # the planes (JAX engine.py:737-872): the request spans go to
        # the tracer, each step's timeline to the recorder (engine thread
        # writes, scrapes read its swapped snapshot), the dispatches and
        # their MFU / bandwidth to the dispatch meter, the graph captures
        # and kernel builds to the compile meter
        self.tracer = tracer if tracer is not None else get_tracer()
        self.steptrace = steptrace if steptrace is not None else StepTrace()
        # recent finished requests with their critical paths, for GET
        # /debug/requests (deque appends and list() are GIL-atomic)
        self.finished: deque = deque(maxlen=128)
        self.dispatch_meter = DispatchMeter()
        self.compile_meter = CompileMeter()
        watch_builds(self.compile_meter)
        # None for a model the analytic geometry does not cover; its
        # peaks are None on a device with no data-sheet entry (the CPU)
        self.cost_model = CostModel.from_model(model, cache_dtype=cache_dtype)
        self._timed = self.device.type == "cuda"
        # enable_debug(disable_jit=True): eager step bodies, which the NaN
        # trap can see into
        self.graphs = StepGraphs(model, self.cache, max_slots=max_slots,
                                 chunk=chunked_prefill,
                                 decode_steps=decode_steps,
                                 capture=(self.device.type == "cuda"
                                          and not debug.graphs_disabled()),
                                 compile_meter=self.compile_meter,
                                 paged=self.paged, spec_k=speculative_k,
                                 draft=draft_model,
                                 draft_cache=self.draft_cache,
                                 draft_window=self._draft_window)

        # host-side slot table: slot_len mirrors each slot's cache depth,
        # so no finish check ever waits on the device
        self.slot_req: list[Request | None] = [None] * max_slots
        self.slot_ready = np.zeros((max_slots,), bool)
        # mid-prefill slots: {"req", "plen", "done", "last_logits"}
        self.slot_prefill: dict[int, dict] = {}
        self.slot_last_token = np.zeros((max_slots,), np.int64)
        self.slot_len = np.zeros((max_slots,), np.int64)
        self.slot_budget = np.zeros((max_slots,), np.int64)
        self._temperature = np.ones((max_slots,), np.float32)
        self._top_k = np.zeros((max_slots,), np.int64)
        self._top_p = np.ones((max_slots,), np.float32)
        self._greedy = np.zeros((max_slots,), bool)
        # a ready slot's whole sequence: the prompt, then every emitted
        # token (the last one's KV is the next decode's to write); the
        # paged layout registers its pages from it and preemption
        # requeues it as the resumed prompt
        self.slot_hist: list[list[int] | None] = [None] * max_slots
        # each slot's grammar cursor (None = unconstrained): installed at
        # activation, cleared at finish and preemption
        self.slot_constraint: list = [None] * max_slots
        # grammar telemetry: host seconds staging masks (lazy state
        # compiles included), drafted tokens the grammar rejected
        self.grammar_mask_seconds_total = 0.0
        self.spec_grammar_rejects = 0
        # the rows of each mask stage that the last fill wrote
        self._stage_rows: dict[str, set] = {}

        self.pending: "queue.Queue[Request]" = queue.Queue()
        self._uid = itertools.count()
        self._lock = threading.Lock()
        # taken by paused(); the loop passes through it before each step
        self._pause = threading.Lock()
        if adapter_registry is not None:
            # bank writes wait for the step in flight (no capture or
            # replay runs while a bank row changes)
            adapter_registry.attach(self._lock)
        # serializes the max_queue check-then-put (two HTTP threads must
        # not both see depth N-1) and the shed and too-large counts
        self._submit_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None
        self._mixed_fallbacks_logged: set[str] = set()
        # counters: forward passes by kind (decode tokens stepped over
        # every slot, a spec round's extension included; one-shot prefill
        # batches; batched chunks over every slot, the fused step's
        # included; single-slot chunks and suffixes; spec verifies over
        # every slot, k + 1 rows each; the draft's single-slot catch-up
        # chunks and its rolls), blocks, sheds; the step-path dispatches
        # are the dispatch meter's count
        self.decode_steps_run = 0
        self.prefill_batches_run = 0
        self.chunk_batches_run = 0
        self.chunk_slots_run = 0
        self.spec_verifies_run = 0
        self.draft_chunks_run = 0
        self.draft_rolls_run = 0
        self.mixed_blocks = 0
        self.multi_blocks = 0
        self.multi_steps_total = 0
        self.stats = EngineStats()
        self.last_step_dispatches = 0
        # goodput blames a violated request's longest span in this ring
        self.stats.goodput.tracer = self.tracer
        if ttft_slo_s is not None or tpot_slo_s is not None:
            self.stats.goodput.configure(ttft_slo_s, tpot_slo_s)
        # HBM ledger (obs/hbm.py): this engine's durable device buffers
        # under their owner accounts; stop() returns every byte. The page
        # pool booked itself inside PagedKV; each paged dispatch pulses
        # its gather view
        self._hbm = get_ledger()
        self._hbm_booked: dict[str, int] = {}   # engine thread and stop()
        # freed once: by stop(), or when the engine is collected unstopped
        self._hbm_release = weakref.finalize(self, _release_books,
                                             self._hbm, self._hbm_booked)
        self._hbm_book("weights/model", tree_bytes(self.model))
        if self.cache is not None:
            self._hbm_book("kv.contiguous", _kv_bytes(self.cache))
        if draft_model is not None:
            # a target that drafts for itself owns those bytes once
            if not _shares_weights(draft_model, self.model):
                self._hbm_book("weights/draft_model",
                               tree_bytes(draft_model))
            self._hbm_book("kv.draft", _kv_bytes(self.draft_cache))

    # --- submission ----------------------------------------------------------

    def submit(self, prompt_ids, params: SamplingParams | None = None, *,
               kv_entry=None, handoff_id: str | None = None,
               session_id: str | None = None,
               adapter: str | None = None, trace=None) -> Request:
        """Queue a request; safe from any thread (touches no tensor). Past
        ``max_queue`` waiting requests it is shed at once; a paged prompt
        that can never fit the pool finishes at once as ``too_large``.
        ``adapter`` names a registered LoRA adapter to decode under: an
        unknown name, or any name on an engine without a registry, raises
        ``ValueError`` here, before anything is queued.

        ``kv_entry``: a :class:`~.kv_pool.HostEntry` claimed from a
        handoff store, validated here (a mismatch is counted in
        ``kv_rejected`` and the request prefills); admission inserts it
        as a full prefix hit. ``handoff_id``: a prefill-only request,
        whose prompt KV is published under that id; it finishes with
        ``"handoff"`` (or ``"handoff_failed"``) and emits no token.
        ``session_id``: the conversation handle; on finish the turn's full
        KV pages stay pinned under it (:mod:`.sessions`) and admission
        consults the store's pending fleet pull. Ignored on an engine
        without a ``session_store``. ``trace``: a
        :class:`~..obs.trace.TraceContext` the engine parents this
        request's phase spans to."""
        params = params or SamplingParams()
        prompt_ids = list(map(int, prompt_ids))
        if not prompt_ids:
            raise ValueError("empty prompt")
        max_prompt = self.cache_len - 2
        if len(prompt_ids) > max_prompt:  # sliding-window crop
            prompt_ids = prompt_ids[-max_prompt:]
        req = Request(next(self._uid), prompt_ids, params, engine=self,
                      adapter=adapter, handoff_id=handoff_id,
                      session_id=session_id, trace=trace)
        if session_id is not None and self.session_store is not None:
            self.session_store.touch(session_id)
        if (self.paged is not None
                and not self.paged.fits_ever(len(prompt_ids) + 1)):
            # its pages and the first decode's exceed the pool even when
            # empty: fail now with a reason the API answers with 422,
            # not after aging in the queue
            with self._submit_lock:
                self.rejected_too_large += 1
            with self.stats.lock:
                self.stats.requests_total += 1
            req.finish_time = time.monotonic()
            req.finish_reason = "too_large"
            self._record_finished(req)
            req.tokens.put(_FINISH)
            return req
        if adapter is not None:
            # pin the adapter for the request's whole life: a refcounted
            # row is never evicted or hot-swapped under a decoding slot
            if self.adapter_registry is None:
                raise ValueError(
                    f"adapter {adapter!r} requested but the engine has no "
                    "adapter_registry")
            try:
                self.adapter_registry.acquire(adapter)
            except KeyError:
                raise ValueError(f"unknown adapter {adapter!r}") from None
            req.adapter_ref = True
        if kv_entry is not None:
            # validated before the request is queued: the engine thread
            # may admit it the moment it is. The decode side's half of the
            # handoff's wire cost
            t0 = time.monotonic()
            req.kv_entry = self._accept_external_kv(kv_entry, prompt_ids)
            req.cp_add("handoff_wire", time.monotonic() - t0)
        with self.stats.lock:
            self.stats.requests_total += 1
        with self._submit_lock:
            shed = (self.max_queue is not None
                    and self.pending.qsize() >= self.max_queue)
            if not shed:
                self.pending.put(req)
        if shed:
            return self._shed(req)
        with self.stats.lock:
            self.stats.queue_depth = self.pending.qsize()
        self._wake.set()
        return req

    def _shed(self, req: Request) -> Request:
        """Finish ``req`` at once with ``finish_reason="queue_full"`` and no
        tokens; the API layer answers 429."""
        req.finish_time = time.monotonic()
        req.finish_reason = "queue_full"
        self._record_finished(req)
        req.tokens.put(_FINISH)
        with self.stats.lock:
            self.stats.requests_shed += 1
        return req

    @property
    def requests_shed(self) -> int:
        """Requests shed by admission control (``llm_requests_shed_total``)."""
        return self.stats.requests_shed

    @property
    def dispatches_total(self) -> int:
        """Step-path dispatches since construction (``llm_dispatches_total``)."""
        return self.dispatch_meter.total

    def _record_finished(self, req: Request) -> None:
        """The one finish funnel of a request (sheds, too-large rejects,
        handoffs and finishes; not a preemption's requeue): close its
        critical path (``host_gap`` is the wall time no segment claims),
        add it to the ``/debug/requests`` ring, and for an adapter's
        request drop its refcount and book its tokens to the tenant. Runs
        on whichever thread finishes the request."""
        wall = (req.finish_time or time.monotonic()) - req.submit_time
        if req.finish_reason == "queue_full" and not req.cp:
            req.cp["queue_wait"] = wall   # a shed spent its life waiting
        attributed = sum(v for k, v in req.cp.items() if k != "stream_flush")
        req.cp["host_gap"] = max(0.0, wall - attributed)
        with self.stats.lock:
            cp = self.stats.critical_path
            for seg, dt in req.cp.items():
                # stream_flush is booked by note_stream_flush only
                if seg in cp and seg != "stream_flush":
                    cp[seg] += dt
        # the ring must not pin a claimed entry a shed never used
        req.kv_entry = None
        self.finished.append(req)
        if req.adapter_ref:
            req.adapter_ref = False
            reg = self.adapter_registry
            reg.release(req.adapter)
            reg.note_tokens(req.adapter, req.n_generated)

    # --- the planes (JAX engine.py:2027-2135) --------------------------------

    def _trace_phase(self, req: Request, name: str, duration_s: float,
                     **attrs) -> None:
        """One engine phase span for a traced request (an untraced one
        costs an ``is None``)."""
        if req.trace is None:
            return
        self.tracer.record(name, req.trace, duration_s=duration_s,
                           uid=req.uid, **attrs)

    @staticmethod
    def _cp_pf_spent(req: Request) -> float:
        """Prefill-attributed critical-path seconds booked so far: the
        admission segment is the admit wall minus what the prefill
        dispatches inside it claimed."""
        return (req.cp.get("prefill_dispatch", 0.0)
                + req.cp.get("preempt_recompute", 0.0))

    def _cp_admission(self, req: Request, dt: float, pre: float) -> None:
        req.cp_add("admission",
                   max(0.0, dt - (self._cp_pf_spent(req) - pre)))

    def _window(self) -> _DeviceWindow:
        return _DeviceWindow(self._timed)

    def _note_device_phase(self, phase: str, *, tokens: int,
                           attended_keys: float, weight_passes: float,
                           kv_read_tokens: float, dt: float) -> None:
        """Book one dispatch's device time ``dt`` (the card's, from its
        window): into the step record (deducted from the enclosing host
        activity) and, with its phase's FLOPs and bytes from the cost
        model, into the dispatch meter's MFU and bandwidth gauges. Draft
        dispatches are not booked (the cost model covers the target)."""
        self.steptrace.note_device(dt, phase)
        cm = self.cost_model
        mfu = bw = None
        if cm is not None and dt > 0:
            mfu = cm.mfu(cm.step_flops(tokens, attended_keys), dt)
            bw = cm.hbm_util(
                cm.step_bytes(weight_passes, kv_read_tokens, tokens), dt)
        self.dispatch_meter.note_phase(phase, tokens=tokens, duration_s=dt,
                                       mfu=mfu, hbm_bw_util=bw)

    # --- multi-LoRA (JAX engine.py:1983-2025) --------------------------------

    @property
    def slot_adapter(self) -> list[str | None]:
        """Each slot's adapter (None = base or free): the adapter of the
        request the slot holds, from admission (a reserved slot included)
        until its finish or preemption frees it."""
        return [r.adapter if r is not None else None for r in self.slot_req]

    def _ns_ids(self, adapter: str | None, token_ids) -> list[int]:
        """Prefix-cache key tokens: shifted by the adapter's namespace
        (``t + (ns << 32)``), which keeps the length and is injective
        (Python ints do not narrow), so both layouts' tuple keys keep
        tenants apart, and a re-registered name misses its stale entries.
        Base requests (ns 0) keep their tokens."""
        ns = (self.adapter_registry.ns_of(adapter)
              if self.adapter_registry is not None and adapter is not None
              else 0)
        if ns == 0:
            return list(token_ids)
        shift = ns << 32
        return [int(t) + shift for t in token_ids]

    def _lora_args(self):
        """The adapter arguments of a slot-plane dispatch (the batched
        chunk, the mixed step, the decode block, the spec verify), or None
        when every slot is base: the base path runs."""
        return self._lora_args_for(self.slot_adapter)

    def _lora_args_for(self, adapters: list[str | None]):
        """The adapter arguments of a dispatch whose rows are
        ``adapters`` (a prefill batch's requests, or one slot), or
        None."""
        reg = self.adapter_registry
        if reg is None or all(a is None for a in adapters):
            return None
        with self.steptrace.scope("adapter_gather"):
            return reg.dispatch_args(list(adapters))

    # --- admission and prefill -----------------------------------------------

    def _admit(self) -> bool:
        """Shed the stale head of the queue, then move pending requests into
        free slots: prefix hits and long prompts take their own paths
        (:meth:`_begin_prefill`), the rest prefill together in one batched
        forward. A dry page pool stops admission for this step."""
        timeout_s = self.queue_timeout_s
        if timeout_s is not None:
            # FIFO: staleness is monotone from the head; a preempted
            # request resumes a live stream and is never shed
            now = time.monotonic()
            with self.steptrace.scope("queue_drain"):
                while True:
                    with self.pending.mutex:
                        head = (self.pending.queue[0] if self.pending.queue
                                else None)
                        if (head is None or head.resume_last is not None
                                or now - head.submit_time <= timeout_s):
                            break
                        self.pending.queue.popleft()
                    self._shed(head)
        self._paged_admit_blocked = False
        admitted = False
        batch: list[tuple[int, Request, int]] = []
        deferred: list[tuple[int, Request, int]] = []
        seen: set[tuple[int, ...]] = set()
        for slot in range(self.max_slots):
            if self.slot_req[slot] is not None:
                continue
            if self._paged_admit_blocked:
                break   # the pool could not cover the last admission
            req = None
            with self.steptrace.scope("queue_drain"):
                while req is None:
                    try:
                        req = self.pending.get_nowait()
                    except queue.Empty:
                        break
                    if (timeout_s is not None and req.resume_last is None
                            and time.monotonic() - req.submit_time
                            > timeout_s):
                        self._shed(req)
                        req = None
            if req is None:
                break
            # submit -> a slot free for it: under load, where a request's
            # time goes
            self._trace_phase(req, "engine.queue_wait",
                              time.monotonic() - req.submit_time, slot=slot)
            cp_base = req.cp_queue_origin
            if cp_base is None:
                # first pop: a claimed entry's upload at submit is already
                # handoff_wire; queue_wait starts after it
                cp_base = req.submit_time + req.cp.get("handoff_wire", 0.0)
            req.cp_add("queue_wait", max(0.0, time.monotonic() - cp_base))
            # re-armed: a requeue (a dry pool) books only its own wait
            req.cp_queue_origin = time.monotonic()
            plen = len(req.prompt_ids)
            hit = self._lookup_prefix(req, plen)
            if self.role == "decode" and (hit is None or hit.length < plen):
                # the degradation is served but counted, where the prefill
                # is about to run: prefill work on a decode replica is the
                # interference disaggregation exists to remove
                self.local_prefills += 1
                if not self._decode_prefill_logged:
                    self._decode_prefill_logged = True
                    _log.warning(
                        "decode-role engine is prefilling locally (handoff "
                        "entry lost or request arrived without one); "
                        "serving continues, but this replica is no longer "
                        "free of prefill interference (local_prefills)")
            if hit is None and not self._should_chunk(0, plen):
                self.slot_req[slot] = req   # reserved; activated after prefill
                self.slot_ready[slot] = False
                key = (req.adapter, tuple(req.prompt_ids))
                if (self.prefix_cache is not None
                        and plen >= self.prefix_cache.min_prefix):
                    if key in seen:
                        # a duplicate of a prompt prefilling in this
                        # burst: a prefix hit once the batch stored it
                        deferred.append((slot, req, plen))
                        admitted = True
                        continue
                    seen.add(key)
                self._note_cache_outcome(req, None, plen)
                batch.append((slot, req, plen))
            else:
                t0 = time.monotonic()
                path = ("kv_direct_insert"
                        if hit is not None and hit.length == plen
                        else "prefill")
                pre = self._cp_pf_spent(req)
                self._begin_prefill(req, slot, plen, hit)
                dt = time.monotonic() - t0
                self._trace_phase(req, "engine.admit", dt, slot=slot,
                                  path=path, prompt_tokens=plen)
                self._cp_admission(req, dt, pre)
            admitted = True
        if batch:
            t0 = time.monotonic()
            pre = {req.uid: self._cp_pf_spent(req) for _, req, _ in batch}
            self._prefill_batch(batch)
            dt = time.monotonic() - t0
            for slot, req, plen in batch:
                self._trace_phase(req, "engine.admit", dt, slot=slot,
                                  path="oneshot_batch", prompt_tokens=plen,
                                  batched=len(batch))
                self._cp_admission(req, dt, pre[req.uid])
        for slot, req, plen in deferred:
            t0 = time.monotonic()
            pre = self._cp_pf_spent(req)
            self._begin_prefill(req, slot, plen)   # a fresh lookup
            dt = time.monotonic() - t0
            self._trace_phase(req, "engine.admit", dt, slot=slot,
                              path="deferred_prefix_hit", prompt_tokens=plen)
            self._cp_admission(req, dt, pre)
        return admitted

    def _update_stats(self) -> None:
        """The queue and slot gauges, after every step."""
        with self.stats.lock:
            self.stats.queue_depth = self.pending.qsize()
            self.stats.active_slots = sum(r is not None
                                          for r in self.slot_req)

    @staticmethod
    def _note_cache_outcome(req: Request, hit, plen: int) -> None:
        """Label the request's admission outcome from the prefix / handoff
        / session hit it resolved (JAX ``_note_cache_outcome``). The first
        admission wins: a preemption's re-admission hits its OWN
        registered pages and must not relabel a cold request as warm."""
        if req.cache_outcome is not None or req.resume_last is not None:
            return
        if hit is None:
            req.cache_outcome = "cold"
        elif hit.length >= plen:
            req.cache_outcome = "hit"
        else:
            req.cache_outcome = "partial"

    def _chunk_span(self, rem: int) -> int:
        """Padded length the chunked path writes for ``rem`` tokens."""
        c = self.chunked_prefill
        return -(-rem // c) * c

    def _oneshot_fits(self, done: int, rem: int) -> bool:
        # the one-shot prefill writes exactly the prompt's rows (the port
        # pads a batch to its longest prompt, no compile buckets)
        return done + rem <= self.cache_len

    def _chunked_fits(self, done: int, rem: int) -> bool:
        return (self.chunked_prefill is not None
                and done + self._chunk_span(rem) <= self.cache_len)

    def _should_chunk(self, done: int, rem: int) -> bool:
        """Chunk when the remainder is long, or when only the chunk span
        fits the cache."""
        return self._chunked_fits(done, rem) and (
            rem > self.chunked_prefill or not self._oneshot_fits(done, rem))

    def _lookup_prefix(self, req: Request, plen: int):
        """This request's prefix hit, best first: a claimed handoff entry
        (validated at submit; a full-length direct insert), the L1 (the
        page index in the paged layout, the row cache in the contiguous
        one), then the kv-pool tiers, whose hit is promoted into L1. A
        :class:`~.paged_kv.PagedHit` in the paged layout, a
        :class:`~.prefix_cache.PrefixEntry` on the card in the contiguous
        one, or None. Every hit's suffix fits: the port's one-shot writes
        exactly the suffix's rows."""
        if self.paged is not None:
            return self._paged_lookup(req, plen)
        ext = req.kv_entry
        if ext is not None:
            req.kv_entry = None
            self.kv_admitted += 1
            return kvp.entry_to_device(ext, self.device, self.cache_dtype)
        if self.prefix_cache is None:
            return None
        key_ids = self._ns_ids(req.adapter, req.prompt_ids)
        hit = self.prefix_cache.lookup(key_ids)
        if hit is not None or self.kv_pool is None:
            return hit
        host = self.kv_pool.lookup(key_ids, usable=self._tier_usable(plen))
        if host is None:
            return None
        hit = kvp.entry_to_device(host, self.device, self.cache_dtype)
        self.prefix_cache.put(key_ids[:hit.length], hit)
        return hit

    def _tier_usable(self, plen: int):
        """The tiers' candidate filter (it reads an entry's metadata and
        row shapes only, before any copy): the port's cache layout, rows
        that fit this engine's cache, and last logits on a full hit. The
        JAX filter's width and suffix-fit rules have nothing to reject
        here: the port copies ``length`` rows and its one-shot suffix
        writes exactly its rows (ROADMAP.md §C)."""
        def usable(entry) -> bool:
            if getattr(entry, "slot_axis", 0) != 0:
                return False
            if entry.length >= plen and entry.last_logits is None:
                return False
            return rows_mismatch(entry, self) is None
        return usable

    def _accept_external_kv(self, host, prompt_ids):
        """A claimed handoff entry validated for this engine (kept on the
        host until admission copies it to the card), or None, counted in
        ``kv_rejected``: a mismatched entry degrades to a local prefill."""
        why = usable_for_engine(host, prompt_ids, self)
        if why is not None:
            with self._submit_lock:
                self.kv_rejected += 1
            _log.warning("rejecting handed-off KV entry: %s", why)
            return None
        return host

    def _begin_prefill(self, req: Request, slot: int, plen: int,
                       hit=_UNSET) -> None:
        """Route one admitted request: full prefix hit -> the stored rows
        and logits; a long remainder (chunked prefill on) -> one chunk per
        step; otherwise the suffix (or, cold, the prompt) at once."""
        if hit is _UNSET:
            hit = self._lookup_prefix(req, plen)
        if self.paged is not None:
            return self._paged_begin_prefill(req, slot, plen, hit)
        self._note_cache_outcome(req, hit, plen)
        if hit is not None:
            self._insert_rows(slot, hit.rows, hit.length)
            if hit.length == plen:
                self._activate(slot, req, plen, hit.last_logits)
                return
        done = hit.length if hit is not None else 0
        if self._should_chunk(done, plen - done):
            self.slot_req[slot] = req   # reserved; activated after prefill
            self.slot_ready[slot] = False
            self.slot_prefill[slot] = {"req": req, "plen": plen,
                                       "done": done, "last_logits": None}
            return
        if hit is None:
            self._prefill_batch([(slot, req, plen)])
            return
        suffix = req.prompt_ids[done:]
        with self.steptrace.scope("dispatch_wait"):
            win = self._window()
            last = self._chunk_slot(slot, suffix, done, width=len(suffix),
                                    adapter=req.adapter)
            dev, wall = win.close()
            keys = CostModel.chunk_keys(len(suffix), done)
            self._note_device_phase(
                "prefill", tokens=len(suffix), attended_keys=keys,
                weight_passes=1, kv_read_tokens=keys, dt=dev)
        req.cp_add("prefill_dispatch", wall)
        rows = (self._slot_rows(slot, plen)
                if self.prefix_cache is not None or req.handoff_id is not None
                else None)
        self._store_prefix(req, plen, rows, last)
        self._activate(slot, req, plen, last, rows)

    def _prefill_batch(self, batch: list[tuple[int, Request, int]]) -> None:
        """One-shot prefill of several prompts in one forward, right-padded
        to the longest. In the paged layout each member first reserves
        its prompt's pages (+1 decode token); a dry pool requeues it and
        stops admission for this step."""
        if self.paged is not None:
            kept, blocked = [], []
            for slot, req, plen in batch:
                if (not self._paged_admit_blocked
                        and self.paged.extend(slot, plen + 1)):
                    kept.append((slot, req, plen))
                else:
                    self.slot_req[slot] = None
                    self.slot_ready[slot] = False
                    self._paged_admit_blocked = True
                    blocked.append(req)
            # in reverse, so the oldest blocked member ends at the head
            with self.pending.mutex:
                for req in reversed(blocked):
                    self.pending.queue.appendleft(req)
            batch = kept
            if not batch:
                return
        dev = self.device
        n = len(batch)
        lens = [plen for _, _, plen in batch]
        width = max(lens)
        with self.steptrace.scope("index_build"):
            ids = np.zeros((n, width), np.int64)
            for j, (_, req, plen) in enumerate(batch):
                ids[j, :plen] = req.prompt_ids
        # one bank row per request (its adapter, or row 0)
        lora = self._lora_args_for([r.adapter for _, r, _ in batch])
        with self.steptrace.scope("dispatch_wait"):
            win = self._window()
            pre = self.model.init_cache(n, width, dtype=self.cache_dtype)
            with lora_scope(lora, dev):
                hidden, pre = self.model(torch.from_numpy(ids).to(dev),
                                         cache=pre, return_hidden=True)
                last_pos = torch.tensor(lens, device=dev) - 1
                last = hidden[torch.arange(n, device=dev), last_pos]  # (n, D)
                logits = self.model.head(last).to(torch.float32)      # (n, V)
            slots = [s for s, _, _ in batch]
            if self.paged is not None:
                self.paged.write_rows(
                    pre, self.paged.rows_scatter_idx(slots, lens, width))
            else:
                idx = torch.tensor(slots, device=dev)
                for eng, layer in zip(self.cache, pre):
                    eng["k"][idx, :width] = layer["k"]
                    eng["v"][idx, :width] = layer["v"]
            masked = logits
            if any(r.params.constraint is not None for _, r, _ in batch):
                # constrained members' first tokens obey their grammars'
                # start states; zero rows leave the rest of the batch as
                # it was. The prefix cache keeps the unmasked logits: a
                # later hit samples under its own request's grammar, or
                # none.
                masked = logits + torch.from_numpy(self._grammar_mask_rows(
                    [self._ensure_constraint(r) for _, r, _ in batch])
                ).to(dev)
            first = sample_token_batched(
                self.generator, masked,
                temperature=torch.tensor(
                    [r.params.temperature for _, r, _ in batch], device=dev),
                top_k=torch.tensor([r.params.top_k for _, r, _ in batch],
                                   device=dev),
                top_p=torch.tensor([r.params.top_p for _, r, _ in batch],
                                   device=dev),
                greedy=torch.tensor([r.params.greedy for _, r, _ in batch],
                                    device=dev),
            )
            win.launched()
            first = first.cpu().numpy()
            dev_s, wall = win.close()
            # useful (unpadded) tokens only: the padding is lost MFU
            keys = sum(CostModel.chunk_keys(p, 0) for p in lens)
            self._note_device_phase(
                "prefill", tokens=sum(lens), attended_keys=keys,
                weight_passes=1, kv_read_tokens=keys, dt=dev_s)
        self.prefill_batches_run += 1
        self.dispatch_meter.count()
        for _, req, _ in batch:
            # every member waited the whole batched dispatch
            req.cp_add("prefill_dispatch", wall)
        with self.steptrace.scope("sample_commit"):
            for j, (slot, req, plen) in enumerate(batch):
                rows = None
                if self.paged is not None:
                    self._paged_store_prefix(req, plen, slot,
                                             logits[j:j + 1])
                elif (self.prefix_cache is not None
                      or req.handoff_id is not None):
                    rows = slice_cache_rows(
                        [{k: layer[k][j:j + 1] for k in ("k", "v")}
                         for layer in pre], plen)
                    self._store_prefix(req, plen, rows, logits[j:j + 1])
                if req.handoff_id is not None:
                    self._complete_handoff(slot, req, plen,
                                           logits[j:j + 1], rows)
                else:
                    self._activate_with_token(slot, req, plen,
                                              int(first[j]))

    def _insert_rows(self, slot: int, rows, length: int) -> None:
        """Copy the first ``length`` stored prefix rows into ``slot``."""
        for layer, r in zip(self.cache, rows):
            for key in ("k", "v"):
                layer[key][slot, :length] = r[key][0, :length]

    def _slot_rows(self, slot: int, width: int) -> list:
        """A copy of ``slot``'s first ``width`` KV rows (a prefix entry)."""
        return slice_cache_rows([{k: layer[k][slot:slot + 1]
                                  for k in ("k", "v")}
                                 for layer in self.cache], width)

    def _store_prefix(self, req: Request, plen: int, rows,
                      last_logits) -> None:
        """Keep a finished prompt's rows and last logits in the
        contiguous layout's prefix cache."""
        if self.prefix_cache is None:
            return
        key_ids = self._ns_ids(req.adapter, req.prompt_ids)
        entry = PrefixEntry(length=plen, bucket=rows[0]["k"].shape[1],
                            rows=rows, last_logits=last_logits)
        self.prefix_cache.put(key_ids, entry)
        if getattr(self.kv_pool, "offload_on_put", False):
            # LMCache write-through: a sibling or restarted engine starts
            # with this prefix warm
            self.kv_pool.offload(key_ids[:plen], entry)

    def _prefill_entries(self) -> list[tuple[int, dict, list[int]]]:
        """(slot, state, next chunk's token ids) of every mid-prefill slot."""
        c = self.chunked_prefill
        return [(slot, st, st["req"].prompt_ids[st["done"]: st["done"] + c])
                for slot, st in sorted(self.slot_prefill.items())]

    def _chunk_batch_rows(self, entries):
        """Host arrays (tok, starts, lens) of a batched chunk over every
        slot: mid-prefill rows at their watermark with their chunk, every
        other row at its own length with zeros (garbage KV above it,
        overwritten in order before any query attends it). min() keeps a
        free row's dead window inside the cache; occupied rows fit by the
        caller's check."""
        c = self.chunked_prefill
        tok = np.zeros((self.max_slots, c), np.int64)
        starts = np.minimum(self.slot_len, self.cache_len - c)
        lens = np.zeros((self.max_slots,), np.int64)
        for slot, st, chunk in entries:
            tok[slot, :len(chunk)] = chunk
            starts[slot] = st["done"]
            lens[slot] = len(chunk)
        return tok, starts, lens

    def _advance_prefills(self, budget: int = 1) -> bool:
        """Advance every mid-prefill slot one chunk per budget unit: several
        together in one batched chunk over every slot, a lone one (or any,
        when an occupied row lacks the chunk's dead-write window) through
        the single-slot chunk; in the paged layout always the batched
        chunk (discarded writes go to the trash page). Then activate
        finished prompts. Admission reserved every prompt page, so no
        chunk allocates."""
        c = self.chunked_prefill
        progressed = False
        while budget > 0 and self.slot_prefill:
            with self.steptrace.scope("index_build"):
                entries = self._prefill_entries()
            batchable = self.paged is not None or (len(entries) > 1 and all(
                int(self.slot_len[s]) + c <= self.cache_len
                for s in range(self.max_slots)
                if s not in self.slot_prefill
                and self.slot_req[s] is not None))   # free rows are dead
            # the device plane reads each chunk's context before it moves
            pf_tokens = sum(len(chunk) for _, _, chunk in entries)
            pf_keys = sum(CostModel.chunk_keys(len(chunk), st["done"])
                          for _, st, chunk in entries)
            # the slot plane's adapters (its mid-prefill rows' among them)
            lora = self._lora_args() if batchable else None
            with self.steptrace.scope("dispatch_wait"):
                win = self._window()
                if batchable:
                    tok, starts, lens = self._chunk_batch_rows(entries)
                    dev = self.device
                    with lora_scope(lora, dev):
                        if self.paged is not None:
                            last = self._paged_chunk_dispatch(entries, tok,
                                                              starts, lens)
                        else:
                            last, _ = batched_chunk(
                                self.model, self.cache,
                                torch.from_numpy(tok).to(dev),
                                torch.from_numpy(starts).to(dev),
                                torch.from_numpy(lens).to(dev))
                    self.chunk_batches_run += 1
                    self.dispatch_meter.count()
                    for slot, st, chunk in entries:
                        st["last_logits"] = last[slot:slot + 1]
                        st["done"] += len(chunk)
                else:
                    for slot, st, chunk in entries:
                        st["last_logits"] = self._chunk_slot(
                            slot, chunk, st["done"],
                            adapter=st["req"].adapter)
                        st["done"] += len(chunk)
                # nothing fetches a chunk's logits before its prompt ends:
                # the window waits on its end event
                dev_s, wall = win.close()
                self._trace_chunks(entries, wall, batched=batchable)
                self._note_device_phase(
                    "prefill", tokens=pf_tokens, attended_keys=pf_keys,
                    weight_passes=1 if batchable else len(entries),
                    kv_read_tokens=pf_keys, dt=dev_s)
            budget -= 1
            progressed = True
            with self.steptrace.scope("sample_commit"):
                self._finalize_prefills()
        return progressed

    def _trace_chunks(self, entries, dt: float, *, batched: bool,
                      fused: bool = False) -> None:
        """One ``engine.prefill_chunk`` span per traced mid-prefill row;
        each row waited the whole chunk dispatch (``prefill_dispatch``)."""
        for slot, st, chunk in entries:
            self._trace_phase(st["req"], "engine.prefill_chunk", dt,
                              slot=slot, done=st["done"],
                              chunk_tokens=len(chunk), batched=batched,
                              fused=fused)
            st["req"].cp_add("prefill_dispatch", dt)

    def _chunk_slot(self, slot: int, chunk: list[int], done: int,
                    width: int | None = None,
                    adapter: str | None = None) -> torch.Tensor:
        """One chunk of ``slot`` at ``done``, padded to ``width`` (default
        ``chunked_prefill``), against a one-slot view of the cache (its
        writes land in the slot's own rows), under the slot's ``adapter``
        (a one-row index). Returns the (1, vocab) f32 logits at the
        chunk's last real position."""
        with lora_scope(self._lora_args_for([adapter]), self.device):
            hidden = self._chunk_slot_impl(
                self.model, self.cache, slot, chunk, done,
                width or self.chunked_prefill)
            last = self.model.head(hidden[:, len(chunk) - 1])
        self.chunk_slots_run += 1
        self.dispatch_meter.count()
        return last.to(torch.float32)

    def _chunk_slot_impl(self, model, cache, slot: int, chunk: list[int],
                         done: int, width: int) -> torch.Tensor:
        """The single-slot chunk of ``model`` over ``cache`` (the engine's,
        or the draft model's): returns the chunk's (1, width, D) final
        hidden states."""
        dev = self.device
        ids = np.zeros((1, width), np.int64)
        ids[0, :len(chunk)] = chunk
        view = [{"k": layer["k"][slot:slot + 1],
                 "v": layer["v"][slot:slot + 1],
                 "index": torch.tensor([done], device=dev)}
                for layer in cache]
        hidden, _ = model(torch.from_numpy(ids).to(dev), cache=view,
                          return_hidden=True)
        return hidden

    def _finalize_prefills(self) -> None:
        """Activate every chunked prefill whose prompt is fully fed, and
        store its prefix."""
        for slot in list(self.slot_prefill):
            st = self.slot_prefill[slot]
            if st["done"] < st["plen"]:
                continue
            req, plen = st["req"], st["plen"]
            del self.slot_prefill[slot]
            rows = None
            if self.paged is not None:
                self._paged_store_prefix(req, plen, slot, st["last_logits"])
            elif self.prefix_cache is not None:
                rows = self._slot_rows(slot, plen)
                self._store_prefix(req, plen, rows, st["last_logits"])
            # the rows ride to the handoff path, gathered once
            self._activate(slot, req, plen, st["last_logits"], rows)

    def _activate(self, slot: int, req: Request, plen: int,
                  last_logits: torch.Tensor, rows=None) -> None:
        """Sample the first token from the prompt's last logits and make the
        slot decodable. A preempted request resumes without sampling: its
        next token was emitted before the preemption. A prefill-role
        request is handed off instead (``rows``: its prompt rows, when
        the caller already copied them)."""
        if req.handoff_id is not None:
            return self._complete_handoff(slot, req, plen, last_logits, rows)
        if req.resume_last is not None:
            return self._activate_with_token(slot, req, plen, 0)
        dev, p = self.device, req.params
        cs = self._ensure_constraint(req)
        if cs is not None:
            # the first token samples from the prompt's logits: it obeys
            # the grammar's start state too
            last_logits = last_logits + torch.from_numpy(
                self._grammar_mask_rows([cs])).to(dev)
        first = sample_token_batched(
            self.generator, last_logits,
            temperature=torch.tensor([p.temperature], device=dev),
            top_k=torch.tensor([p.top_k], device=dev),
            top_p=torch.tensor([p.top_p], device=dev),
            greedy=torch.tensor([p.greedy], device=dev))
        self._activate_with_token(slot, req, plen, int(first[0]))

    def _activate_with_token(self, slot: int, req: Request, plen: int,
                             first_id: int) -> None:
        resumed = req.resume_last is not None
        if resumed:
            # the prompt is the emitted history but its last token, whose
            # KV the next decode writes; nothing is emitted and the TTFT
            # stamp stays the original one
            first_id = req.resume_last
            req.resume_last = None
        else:
            req.first_token_time = time.monotonic()
        self.slot_req[slot] = req
        self.slot_ready[slot] = True
        self.slot_last_token[slot] = first_id
        self.slot_len[slot] = plen
        self.slot_budget[slot] = (req.resume_budget if resumed
                                  else req.params.max_tokens - 1)
        self._temperature[slot] = req.params.temperature
        self._top_k[slot] = req.params.top_k
        self._top_p[slot] = req.params.top_p
        self._greedy[slot] = req.params.greedy
        self.slot_hist[slot] = list(req.prompt_ids) + [first_id]
        # the grammar cursor: a resumed stream's is already past every
        # token the client saw, the resume token included
        cs = self.slot_constraint[slot] = self._ensure_constraint(req)
        if not resumed:
            self._emit(slot, first_id)
            self._constraint_commit(slot, cs, first_id)

    # --- emission and finish -------------------------------------------------

    def _emit(self, slot: int, token_id: int) -> None:
        req = self.slot_req[slot]
        budget_left = self.slot_budget[slot] > 0
        hit_eos = self.eos_id is not None and token_id == self.eos_id
        # cache_len guard: the emitted token's write (next decode) must fit
        room = self.slot_len[slot] + 1 < self.cache_len
        if not hit_eos:
            req.output_ids.append(token_id)
            req.tokens.put(token_id)
            req.n_generated += 1
        if hit_eos or not budget_left or not room:
            self._finish_slot(slot, "stop" if hit_eos else
                              ("length" if not budget_left else "cache"))

    def _finish_slot(self, slot: int, reason: str) -> None:
        """Finish ``slot``'s request and free the slot. In the paged layout
        its full pages are indexed for sharing on the way out (a follow-up
        turn reuses the conversation's KV), a session's are pinned under
        its id, and its block table releases its references."""
        req = self.slot_req[slot]
        req.finish_time = time.monotonic()
        req.finish_reason = reason
        if req.first_token_time is not None:
            # the decode phase, first token to finish; recorded before the
            # stream closes, so a consumer that saw it end finds the span
            self._trace_phase(
                req, "engine.decode", req.finish_time - req.first_token_time,
                slot=slot, tokens=req.n_generated,
                finish_reason=req.finish_reason)
        hist = self.slot_hist[slot]
        in_session = (self.session_store is not None
                      and req.session_id is not None)
        if self.paged is not None:
            if hist:
                self._paged_register_pages(hist[:-1], slot, req.adapter)
                if in_session:
                    # pin and publish BEFORE release_slot: the block table
                    # still maps the pages, so the pin's share() can never
                    # race a refcount-zero free
                    self._session_note_finish(slot, req, hist[:-1])
            self.paged.release_slot(slot)
        elif in_session:
            # contiguous layout: no pages to pin; the store keeps the
            # conversation's history and turn accounting (warm turns ride
            # the row cache's LRU)
            self.session_store.note_finish(
                req.session_id, hist[:-1] if hist else req.prompt_ids, [],
                adapter=req.adapter, cache_outcome=req.cache_outcome)
        self._record_finished(req)
        req.tokens.put(_FINISH)
        self.stats.observe_finished(req)
        self.slot_req[slot] = None
        self.slot_ready[slot] = False
        self.slot_budget[slot] = 0
        self.slot_hist[slot] = None
        self.slot_constraint[slot] = None

    def _commit_token(self, slot: int, tok: int) -> None:
        self.slot_budget[slot] -= 1
        self.slot_len[slot] += 1
        self.slot_last_token[slot] = tok
        self.slot_hist[slot].append(tok)
        # taken before _emit: a finish clears the slot's reference, but
        # the cursor, which lives on the request, still advances
        cs = self.slot_constraint[slot]
        self._emit(slot, tok)
        self._constraint_commit(slot, cs, tok)

    def _commit_block(self, active: list[int], toks, n: int) -> None:
        """Book an ``n``-step block's tokens ((slots, n) host array) into
        every active slot, stopping each at its finish."""
        if n > 1:
            self.multi_blocks += 1
            self.multi_steps_total += n
        for slot in active:
            for j in range(n):
                if self.slot_req[slot] is None:
                    break                 # finished mid-block (eos/len)
                self._commit_token(slot, int(toks[slot, j]))

    def _ready_slots(self) -> list[int]:
        return [s for s, r in enumerate(self.slot_req)
                if r is not None and self.slot_ready[s]]

    # --- paged KV (JAX engine.py:1436-1877, 2688-2858, 3111-3185) -----------

    def _pg(self, a: np.ndarray) -> torch.Tensor:
        """A host index array, flattened, as an int64 device tensor."""
        return torch.from_numpy(
            np.ascontiguousarray(a, np.int64).reshape(-1)).to(self.device)

    def _paged_width(self, need: int) -> int:
        """The view width covering ``need`` rows: ``page_size`` doubled up
        to ``cache_len`` (one CUDA graph per width, as JAX compiles one
        program per bucket)."""
        w = self.paged.page_size
        while w < need:
            w *= 2
        w = min(w, self.cache_len)
        if w < need:
            raise AssertionError(f"paged view width {w} < needed {need} "
                                 f"(cache_len {self.cache_len})")
        return w

    def _paged_index_vec(self, width: int, wwin: int) -> np.ndarray:
        """Each row's pinned index for a decode-family step
        (:meth:`_decode_index`), clamped so even a dead row's in-view
        writes stay inside the view (their scatter targets are trash)."""
        return np.minimum(self._decode_index(), max(width - wwin, 0))

    def _paged_lookup(self, req: Request, plen: int) -> PagedHit | None:
        """Paged admission's prefix hit, best first (JAX
        ``_paged_lookup``): a claimed handoff entry (host rows, validated
        at submit), a fleet-pulled session entry longer than the page
        hit, the longer of the page index's full-page match and the
        session's own pinned chain (its pages refcounted into the hit),
        then the kv-pool tiers (a host entry, scattered into the slot's
        pages at admission). JAX reaches a pin through the index only,
        whose LRU drops a pinned chain's entries first under pressure;
        the port also asks the store, so a pin is found while it lives
        (ROADMAP.md §C)."""
        ext = req.kv_entry
        if ext is not None:
            req.kv_entry = None
            self.kv_admitted += 1
            return PagedHit(length=ext.length, entry=ext,
                            last_logits=ext.last_logits, external=True)
        pages = []
        if self.prefix_cache is not None:
            key_ids = self._ns_ids(req.adapter, req.prompt_ids)
            pages = self.prefix_cache.lookup(key_ids)
        if self.session_store is not None and req.session_id is not None:
            pinned = self.session_store.pinned_prefix(
                req.session_id, req.prompt_ids, req.adapter)
            if len(pinned) > len(pages):
                # the longer chain wins; the other's references go back
                pages, pinned = pinned, pages
            if pinned:
                self.paged.pool.release(pinned)
            # a fleet-pulled session entry outranks a SHORTER page hit;
            # when it wins, the page references go straight back
            hit = self._session_pull_hit(
                req, plen, len(pages) * self.paged.page_size)
            if hit is not None:
                if pages:
                    self.paged.pool.release(pages)
                return hit
        if pages:
            return PagedHit(length=len(pages) * self.paged.page_size,
                            pages=pages)
        if self.kv_pool is None or self.prefix_cache is None:
            return None
        host = self.kv_pool.lookup(key_ids, usable=self._tier_usable(plen))
        if host is None:
            return None
        return PagedHit(
            length=host.length, entry=host,
            last_logits=host.last_logits if host.length == plen else None)

    def _session_pull_hit(self, req: Request, plen: int, page_len: int):
        """A :class:`~.paged_kv.PagedHit` from the session store's pending
        fleet pull for this request, or None (JAX ``_session_pull_hit``).
        The entry rides the tier entries' scatter, and it is consumed
        once: an entry that loses to a longer page hit or cannot be used
        is dropped (the local re-prefill)."""
        pulled = self.session_store.take_pending(req.session_id,
                                                 req.prompt_ids)
        if pulled is None:
            return None
        host, n = pulled
        if host.last_logits is None and n >= plen:
            # no stored logits for the last position: keep one token to
            # recompute (the page-index hit keeps the same)
            n = plen - 1
        if getattr(host, "slot_axis", 0) != 0 or n <= page_len or n <= 0:
            return None
        if rows_mismatch(host, self) is not None:
            # another model's rows: never scattered
            self.session_store.note_lost()
            return None
        return PagedHit(
            length=n, entry=host,
            last_logits=host.last_logits if n == plen else None)

    def _paged_begin_prefill(self, req: Request, slot: int, plen: int,
                             hit: PagedHit | None) -> None:
        """Reserve the prompt's actual pages (+1 decode token, not a
        cache_len worst case), map the hit's shared pages or scatter its
        entry's rows, then chunk or prefill the suffix at once. A dry pool
        hands the shared refs back (and a claimed entry back to the
        request: a claim is consumed once), requeues the request at the
        head and stops admission for this step (decode-side growth may
        preempt; admission never does). The JAX page-by-page shrink of a
        hit whose suffix cannot fit has nothing to do here: the port's
        one-shot writes exactly the suffix's rows, which always fit."""
        self._note_cache_outcome(req, hit, plen)
        if hit is not None and hit.pages:
            self.paged.map_shared(slot, hit.pages)
        if not self.paged.extend(slot, plen + 1):
            self.paged.release_slot(slot)
            self.slot_req[slot] = None
            self.slot_ready[slot] = False
            if hit is not None and hit.external:
                req.kv_entry = hit.entry
                self.kv_admitted -= 1
            self._paged_admit_blocked = True
            with self.pending.mutex:
                self.pending.queue.appendleft(req)
            return
        done = hit.length if hit is not None else 0
        if hit is not None and hit.entry is not None:
            self._paged_insert_entry(slot, hit.entry, hit.length)
            # promote a tier hit into the page index: the next request
            # with this prefix shares the pages instead of fetching rows
            self._paged_register_pages(req.prompt_ids[:hit.length], slot,
                                       req.adapter)
            if hit.length == plen:
                self._activate(slot, req, plen,
                               hit.last_logits.to(self.device))
                return
        if self._should_chunk(done, plen - done):
            self.slot_req[slot] = req
            self.slot_ready[slot] = False
            self.slot_prefill[slot] = {"req": req, "plen": plen,
                                       "done": done, "last_logits": None}
            return
        last = self._paged_suffix(slot, req.prompt_ids[done:], done, req)
        self._paged_store_prefix(req, plen, slot, last)
        self._activate(slot, req, plen, last)

    def _paged_gather_entry(self, slot: int, plen: int,
                            last_logits) -> PrefixEntry:
        """A page-wise prefix entry of ``slot``'s first ``plen`` positions:
        its live pages' rows (``ceil(plen / P) * P``), gathered into one
        fresh tensor that owes nothing to the pool (JAX
        ``_paged_gather_entry``)."""
        width = self.paged.entry_width(plen)
        flat = self.paged.gather_rows(slot, width)
        keys = self.paged.keys
        rows = [{k: flat[i * len(keys) + j][None] for j, k in enumerate(keys)}
                for i in range(self.paged.n_layers)]
        return PrefixEntry(length=plen, bucket=width, rows=rows,
                           last_logits=last_logits,
                           page_size=self.paged.page_size)

    def _paged_insert_entry(self, slot: int, entry, length: int) -> None:
        """Scatter a host entry's first ``length`` rows into ``slot``'s
        reserved pages: one copy to the card (cast to the pool's dtype),
        one ``index_copy_`` (JAX ``_paged_insert_entry``)."""
        self._paged_cow_fork(slot, 0, length)
        rows = kvp.rows_to_device(entry, self.device, self.paged.store.dtype)
        self.paged.scatter_rows(rows, slot, length)

    def _paged_suffix(self, slot: int, suffix: list[int], done: int,
                      req: Request) -> torch.Tensor:
        """The one-shot prefill of ``suffix`` into ``slot`` at ``done``: a
        single-row chunk over a view of the slot's own pages only (JAX
        ``_paged_suffix``), under ``req``'s adapter through a one-row
        index (where JAX sends an adapter's suffix through its all-slots
        chunk, whose compiled program indexes the slot plane: the same
        math). Returns the (1, vocab) f32 logits at the last position."""
        c = len(suffix)
        with self.steptrace.scope("index_build"):
            width = self._paged_width(done + c)
            self._paged_cow_fork(slot, done, c)
            starts = np.zeros((self.max_slots,), np.int64)
            valid = np.zeros((self.max_slots,), np.int64)
            starts[slot], valid[slot] = done, c
            sidx = self.paged.scatter_idx(starts, valid, c)[slot:slot + 1]
            self.paged.pulse_view(width, 1)
        dev = self.device
        lora = self._lora_args_for([req.adapter])
        with self.steptrace.scope("dispatch_wait"):
            win = self._window()
            g, view = gather_view(
                self.paged, self._pg(self.paged.row_gather_idx(slot, width)),
                1, torch.tensor([done], device=dev))
            with lora_scope(lora, dev):
                hidden, _ = self.model(torch.tensor([suffix], device=dev),
                                       cache=view, return_hidden=True)
                last = self.model.head(hidden[:, c - 1])
            scatter_window(self.paged, g,
                           self._pg(window_idx(np.array([done]), width, c)),
                           self._pg(sidx))
            dev_s, wall = win.close()
            keys = CostModel.chunk_keys(c, done)
            self._note_device_phase(
                "prefill", tokens=c, attended_keys=keys, weight_passes=1,
                kv_read_tokens=keys, dt=dev_s)
        req.cp_add("prefill_dispatch", wall)
        self.chunk_slots_run += 1
        self.dispatch_meter.count()
        return last.to(torch.float32)

    def _paged_chunk_dispatch(self, entries, tok, starts, lens
                              ) -> torch.Tensor:
        """Every mid-prefill row one chunk against the page pool: gather a
        view, run the shared :func:`~.mixed_step.batched_chunk` body,
        scatter each prefill row's real window back (everything else goes
        to the trash page). Returns the (slots, vocab) last logits."""
        c = self.chunked_prefill
        width = self._paged_width(max(st["done"] for _, st, _ in entries)
                                  + c)
        # non-prefill rows' dead in-view windows stay inside the view
        starts = np.minimum(starts, width - c)
        valid = np.zeros((self.max_slots,), np.int64)
        for slot, st, chunk in entries:
            starts[slot] = st["done"]
            valid[slot] = len(chunk)
            self._paged_cow_fork(slot, st["done"], len(chunk))
        dev = self.device
        starts_t = torch.from_numpy(starts).to(dev)
        self.paged.pulse_view(width)
        g, view = gather_view(self.paged, self._pg(self.paged.gather_idx(
            width)), self.max_slots, starts_t)
        last, _ = batched_chunk(self.model, view,
                                torch.from_numpy(tok).to(dev), starts_t,
                                torch.from_numpy(lens).to(dev))
        scatter_window(self.paged, g, self._pg(window_idx(starts, width, c)),
                       self._pg(self.paged.scatter_idx(starts, valid, c)))
        return last

    def _paged_cow_fork(self, slot: int, start: int, width: int) -> None:
        """Fork any shared page the write window ``[start, start + width)``
        would touch. With full-page-only sharing no path writes inside a
        shared page; this is the defensive half of the COW contract, so a
        scheduler change degrades to a page copy instead of corrupting a
        neighbour's prefix."""
        if width <= 0:
            return
        P = self.paged.page_size
        pool = self.paged.pool
        bt = self.paged.block_tables
        for lp in range(start // P, min((start + width - 1) // P + 1,
                                        self.paged.pages_per_slot)):
            page = int(bt[slot, lp])
            if page == 0 or pool.refcount(page) <= 1:
                continue
            fresh = pool.try_alloc(1)
            while fresh is None:
                # preemption pressure until a page frees: one victim whose
                # pages are all still shared frees nothing
                victim = self._paged_pick_victim(exclude=slot)
                if victim is None:
                    raise RuntimeError("page pool exhausted during COW fork")
                self._paged_preempt(victim)
                fresh = pool.try_alloc(1)
            self.paged.copy_page(page, fresh[0])
            bt[slot, lp] = fresh[0]
            pool.release([page])

    def _paged_pick_victim(self, exclude: int | None = None) -> int | None:
        """Preemption policy: the youngest occupied slot (highest uid)
        other than ``exclude``: least work lost, and its re-prefill is
        mostly a page-index hit (vLLM preempts LIFO for the same reason)."""
        best, best_uid = None, -1
        for s in range(self.max_slots):
            if s == exclude or self.slot_req[s] is None:
                continue
            if self.slot_req[s].uid > best_uid:
                best, best_uid = s, self.slot_req[s].uid
        return best

    def _paged_preempt(self, slot: int) -> None:
        """Preempt ``slot`` by recompute: index its pages (re-admission is
        then mostly a page hit), release them, and put the request back at
        the HEAD of the queue with the resume fields, so the client's
        stream continues where it left off."""
        req = self.slot_req[slot]
        st = self.slot_prefill.pop(slot, None)
        if st is None and self.slot_ready[slot]:
            hist = self.slot_hist[slot]
            req.resume_last = hist[-1]
            req.resume_budget = int(self.slot_budget[slot])
            req.prompt_ids = list(hist[:-1])
            self._paged_register_pages(hist[:-1], slot, req.adapter)
        elif st is not None and st["done"] > 0:
            # mid-prefill: nothing emitted; keep the computed full pages
            self._paged_register_pages(req.prompt_ids[:st["done"]], slot,
                                       req.adapter)
        self.paged.release_slot(slot)
        self.slot_req[slot] = None
        self.slot_ready[slot] = False
        self.slot_budget[slot] = 0
        self.slot_hist[slot] = None
        # the cursor stays on req.constraint_state: re-admission resumes
        # from its grammar position; the adapter's refcount stays on the
        # request, whose slot re-stamps it at re-admission
        self.slot_constraint[slot] = None
        if self.draft_model is not None:
            # the target KV is recomputed on re-admission: so is the
            # draft's
            self._draft_uid[slot] = -1
        self.preemptions += 1
        self._hbm.note_reclaim("kv_pool.pages", "preempt")
        # the re-admission's wait and recompute are preempt_recompute from
        # here on, and its queue wait starts here
        req.requeue_time = time.monotonic()
        req.cp_queue_origin = req.requeue_time
        with self.pending.mutex:
            self.pending.queue.appendleft(req)
        _log.info("preempted slot %d (uid %d) under page-pool pressure; "
                  "requeued for recompute (resume at %d tokens)",
                  slot, req.uid, len(req.prompt_ids))

    def _paged_reserve_active(self, active: list[int],
                              width: int) -> list[int]:
        """Reserve ``width`` more positions for every ready slot before a
        decode-family step; preempted victims drop out, and a slot that
        cannot grow even as the last occupant finishes with the
        contiguous layout's ``cache`` reason. Returns the survivors."""
        out = list(active)
        for s in list(out):
            if s not in out or self.slot_req[s] is None:
                continue
            while not self.paged.extend(s, int(self.slot_len[s]) + width):
                victim = self._paged_pick_victim(exclude=s)
                if victim is None:
                    self._finish_slot(s, "cache")
                    out.remove(s)
                    break
                self._paged_preempt(victim)
                if victim in out:
                    out.remove(victim)
        return [s for s in out if self.slot_req[s] is not None
                and self.slot_ready[s]]

    def _paged_decode_dispatch(self, active: list[int], n: int,
                               gmask=None, lora=None) -> dict:
        """One paged decode block (pages reserved by the caller): on the
        card one graph replay of ``("pdecode", n, all_greedy, width)``,
        or with ``gmask`` of its masked twin ``"pmdecode"`` at n 1; with
        ``lora`` of the adapter twin of either."""
        width = self._paged_width(
            max(int(self.slot_len[s]) for s in active) + n)
        idxv = self._paged_index_vec(width, n)
        valid = np.zeros((self.max_slots,), np.int64)
        for s in active:
            valid[s] = n
            self._paged_cow_fork(s, int(self.slot_len[s]), n)
        return self.graphs.run(
            "pdecode" if gmask is None else "pmdecode", n, width=width,
            index=idxv, gidx=self.paged.gather_idx(width),
            vidx=window_idx(idxv, width, n),
            sidx=self.paged.scatter_idx(idxv, valid, n), lora=lora,
            **self._sampling_arrays(active, gmask))

    def _paged_register_pages(self, token_ids, slot: int,
                              adapter: str | None = None) -> None:
        """Index every FULL page of ``token_ids`` (whose KV fills
        ``slot``'s first pages, computed under ``adapter``) for refcounted
        sharing, keyed in the adapter's namespace."""
        if self.prefix_cache is None:
            return
        P = self.paged.page_size
        nfull = len(token_ids) // P
        if nfull <= 0:
            return
        pages = self.paged.slot_pages(slot)[:nfull]
        if len(pages) == nfull:
            self.prefix_cache.register(
                self._ns_ids(adapter, token_ids[:nfull * P]), pages)

    def _paged_store_prefix(self, req: Request, plen: int, slot: int,
                            last_logits) -> None:
        """The paged twin of :meth:`_store_prefix`: the prompt's KV is
        already in the slot's pages, so storing it is indexing them, plus
        the kv-pool write-through of a page-wise entry."""
        self._paged_register_pages(req.prompt_ids[:plen], slot,
                                   req.adapter)
        if getattr(self.kv_pool, "offload_on_put", False):
            self.kv_pool.offload(
                self._ns_ids(req.adapter, req.prompt_ids[:plen]),
                self._paged_gather_entry(slot, plen, last_logits))

    def _session_note_finish(self, slot: int, req: Request,
                             token_ids) -> None:
        """Session pin and fleet publish of a finishing paged slot (JAX
        ``_session_note_finish``). ``token_ids`` is the KV-valid history
        (``hist[:-1]``: the last emitted token's KV was never written).
        Pins the full-page chain under the session id; with a handoff
        store, gathers a page-aligned copy on this thread (the pages are
        still slot-mapped) and hands it to the store's publisher, which
        copies it to the host and puts it, as the handoff's publishers
        do."""
        P = self.paged.page_size
        nfull = len(token_ids) // P
        pages = self.paged.slot_pages(slot)[:nfull] if nfull > 0 else []
        self.session_store.note_finish(
            req.session_id, token_ids, pages, adapter=req.adapter,
            cache_outcome=req.cache_outcome)
        if self.handoff is not None and nfull > 0:
            with self.steptrace.scope("publish"):
                # no last logits: the entry is a page-aligned PARTIAL
                # prefix by design, and the claiming replica recomputes at
                # least the suffix, which gives fresh logits
                entry = self._paged_gather_entry(slot, nfull * P, None)
                ready = None
                if self.device.type == "cuda":
                    ready = torch.cuda.Event()
                    ready.record()
            self.session_store.publish(req.session_id,
                                       token_ids[:nfull * P], entry, ready)

    # --- the disaggregated handoff (JAX engine.py:2424-2540) ----------------

    def _complete_handoff(self, slot: int, req: Request, plen: int,
                          last_logits, rows=None) -> None:
        """Prefill-role completion: the prompt's KV is in ``slot``. Copy
        it (and the last logits the decode replica samples its first
        token from) into an entry that owes nothing to the slot, free the
        slot, and queue the entry for a publisher thread, which copies it
        to the host and publishes it under the request's handoff id, then
        finishes the request without a token. The engine thread pays the
        gather only; a slow or dead pool stalls the waiting request, never
        the step loop. ``rows``: the prompt's rows, already copied."""
        with self.steptrace.scope("publish"):
            if self.paged is not None:
                entry = self._paged_gather_entry(slot, plen, last_logits)
                self.paged.release_slot(slot)
            else:
                entry = PrefixEntry(
                    length=plen, bucket=plen,
                    rows=(rows if rows is not None
                          else self._slot_rows(slot, plen)),
                    last_logits=last_logits)
            ready = None
            if self.device.type == "cuda":
                # the publisher's copy waits on this, on a stream of its
                # own
                ready = torch.cuda.Event()
                ready.record()
            self.slot_req[slot] = None
            self.slot_ready[slot] = False
            self.slot_budget[slot] = 0
            self.slot_hist[slot] = None
            self.slot_constraint[slot] = None
            if not self._publishers:
                self._publishers = [
                    threading.Thread(target=self._run_publisher,
                                     daemon=True,
                                     name=f"handoff-publisher-{i}")
                    for i in range(self._n_publishers)]
                for t in self._publishers:
                    t.start()
            self._publish_queue.put((req, plen, entry, ready))

    def _run_publisher(self) -> None:
        """A handoff publisher: copy an entry to the host and publish it,
        then finish its request ("handoff", or "handoff_failed" when the
        copy or the store failed), so a caller waiting on the request
        knows the KV is claimable. Several run at once: publishes are
        independent I/O."""
        stream = None
        while True:
            item = self._publish_queue.get()
            if item is None:
                return
            req, plen, entry, ready = item
            t0 = time.monotonic()
            staged = 0
            try:
                if ready is None:
                    host = kvp.entry_to_host(entry)
                else:
                    # never while another thread captures a graph
                    with CAPTURE_LOCK.work():
                        if stream is None:
                            stream = torch.cuda.Stream(device=self.device)
                        with torch.cuda.stream(stream):
                            stream.wait_event(ready)
                            for layer in entry.rows:
                                for t in layer.values():
                                    t.record_stream(stream)
                            entry.last_logits.record_stream(stream)
                            host = kvp.entry_to_host(entry)
                del entry
                # ledger account handoff_staging (host plane): the entry's
                # RAM between the copy to the host and the store's put,
                # freed below whether the put lands or not
                staged = host_entry_bytes(host)
                self._hbm.book("handoff_staging", staged)
                self.handoff.publish(req.handoff_id, host)
            except Exception as e:  # noqa: BLE001 — a transport fault or a
                # pool refusal: the request must still finish, and the
                # caller serves it elsewhere
                with self._publish_lock:
                    self.handoff_publish_failed += 1
                _log.warning("handoff publish %s failed: %s: %s",
                             req.handoff_id, type(e).__name__, e)
                req.finish_reason = "handoff_failed"
            else:
                with self._publish_lock:
                    self.handoff_published += 1
                req.finish_reason = "handoff"
            if staged:
                self._hbm.book("handoff_staging", -staged)
            # the copy to the host and the store's put: the transfer cost
            # the disaggregation trade pays, per request
            self._trace_phase(req, "handoff.publish", time.monotonic() - t0,
                              handoff_id=req.handoff_id, prompt_tokens=plen,
                              ok=req.finish_reason == "handoff")
            req.cp_add("handoff_wire", time.monotonic() - t0)
            req.finish_time = time.monotonic()
            # the KV being claimable is a prefill replica's first token
            req.first_token_time = req.finish_time
            self._record_finished(req)
            req.tokens.put(_FINISH)
            self.stats.observe_finished(req)

    # --- speculative decoding (JAX engine.py:1242-1358, 3360-3580) ---------

    def _draft(self, hist: list[int], k: int) -> list[int] | None:
        """Prompt-lookup draft: the ``k`` tokens that followed the most
        recent earlier occurrence of the trailing n-gram (n from
        ``speculative_ngram`` down to 1) in the last 2048 tokens, or None.
        Vectorized: it runs on the host before every round."""
        window = np.asarray(hist[-2048:], np.int64)
        for n in range(self.speculative_ngram, 0, -1):
            if window.size <= n:
                continue
            pat = window[-n:]
            # start positions before the trailing n-gram itself where all
            # n tokens match
            limit = window.size - n
            hitmask = window[:limit] == pat[0]
            for j in range(1, n):
                hitmask &= window[j:limit + j] == pat[j]
            hits = np.nonzero(hitmask)[0]
            if hits.size:
                i = int(hits[-1])
                cont = window[i + n: i + n + k].tolist()
                if cont:
                    return cont          # 1..k tokens; the round zero-fills
        return None

    def _spec_applicable(self, active: list[int]) -> bool:
        """Whether a spec round can run this step (shared with the mixed
        step's composition test, so the two never disagree): every active
        slot greedy, and the round's k + 1 rows inside the cache for every
        ready row and every mid-prefill row (the verify writes dead rows
        at a mid-prefill row's watermark; a clamp there would shift them
        back over its prompt)."""
        k = self.speculative_k
        if k is None:
            return False
        if not all(self._greedy[s] for s in active):
            return False                  # lossless under greedy only
        return (all(self.slot_len[s] + k + 1 <= self.cache_len
                    for s in active)
                and all(st["done"] + k + 1 <= self.cache_len
                        for st in self.slot_prefill.values()))

    def _spec_headroom(self, active: list[int]) -> int:
        """Cache rows left for the extension above the k + 1 verify rows:
        min over decoding and mid-prefill rows."""
        lens = [int(self.slot_len[s]) for s in active]
        lens += [st["done"] for st in self.slot_prefill.values()]
        return (self.cache_len - (self.speculative_k + 1)
                - (max(lens) if lens else 0))

    def _draft_model_propose(self, active: list[int], k: int) -> dict:
        """The draft model's proposal: re-sync each slot's draft cache to
        its history (eager single-slot chunks of ``W`` while the gap is
        wider than ``W``), then one roll over every slot. Returns
        ``{slot: k tokens}``."""
        W = self._draft_window
        rows = []
        for s in active:
            hist = self.slot_hist[s]
            req = self.slot_req[s]
            if hist is None or req is None:
                continue
            if self._draft_uid[s] != req.uid:        # a new request
                self._draft_uid[s] = req.uid
                self._draft_sync[s] = 0
            # the roll writes up to len(hist) + k rows and the W-wide
            # catch-up must fit too; a clamped write near the end would
            # shift back over synced KV. Such a slot is skipped, and as
            # an idle row below its dead write may land on its synced
            # rows: drop its watermark, so it re-syncs in full
            if (len(hist) + k > self.cache_len
                    or len(hist) - 1 + W > self.cache_len):
                self._draft_uid[s] = -1
                continue
            while len(hist) - int(self._draft_sync[s]) > W:
                done = int(self._draft_sync[s])
                chunk = hist[done: done + W]
                self._chunk_slot_impl(self.draft_model, self.draft_cache, s,
                                      chunk, done, W)
                self.draft_chunks_run += 1
                self.dispatch_meter.count()
                self._draft_sync[s] = done + len(chunk)
            rows.append(s)
        if not rows:
            return {}
        catchup = np.zeros((self.max_slots, W), np.int64)
        starts = np.zeros((self.max_slots,), np.int64)
        lens = np.zeros((self.max_slots,), np.int64)
        for s in range(self.max_slots):
            if s in rows:
                gap = self.slot_hist[s][int(self._draft_sync[s]):]
                catchup[s, :len(gap)] = gap
                starts[s] = self._draft_sync[s]
                lens[s] = len(gap)
            else:                            # idle rows: a dead write
                starts[s] = min(int(self._draft_sync[s]),
                                self.cache_len - W)
        out = self.graphs.run("droll", k, all_greedy=True, generator=None,
                              width=W, catchup=catchup, roll_starts=starts,
                              roll_lens=lens)
        drafts = out["drafts"].cpu().numpy()
        self.draft_rolls_run += 1
        self.dispatch_meter.count()
        proposed = {}
        for s in rows:
            self._draft_sync[s] = len(self.slot_hist[s])
            proposed[s] = [int(t) for t in drafts[s]]
        return proposed

    def _try_speculative(self, active: list[int]) -> bool:
        """One fused spec round: draft ``k`` tokens per slot (ngram or the
        draft model), then verify them and decode the planned block's
        remaining ``m`` steps in one dispatch (on the card one replay of
        ``("spec" | "pspec", m, True, width, window)``), and commit each
        slot's accepted tokens, bonus token and extension. Returns False
        (nothing dispatched but a draft) when the round does not apply or
        nothing was drafted: the caller runs the plain block."""
        k = self.speculative_k
        with self.steptrace.scope("plan"):
            applicable = self._spec_applicable(active)
            if applicable:
                m = plan_spec_extension(
                    block=self._plan_block(active), k=k,
                    headroom=self._spec_headroom(active))
        if not applicable:
            return False
        # draft before touching the page pool (drafting needs no page),
        # so a step that drafts nothing preempts nobody for a
        # reservation it never uses
        with self.steptrace.scope("draft_propose"):
            if self.draft_model is not None:
                drafts = self._draft_model_propose(active, k)
            else:
                drafts = {}
                for s in active:
                    d = self._draft(self.slot_hist[s], k)
                    if d is not None:
                        drafts[s] = d
        if not drafts:
            return False
        w = k + 1 + m                         # rows the round writes
        if self.paged is not None:
            # reserve the round's rows (may preempt; a preempted slot's
            # draft watermark is dropped in _paged_preempt)
            with self.steptrace.scope("admit"):
                active = self._paged_reserve_active(active, w)
            if not active:
                return True
            drafts = {s: d for s, d in drafts.items() if s in active}
        with self.steptrace.scope("index_build"):
            tokens = np.zeros((self.max_slots, k + 1), np.int64)
            tokens[:, 0] = self.slot_last_token
            for s, d in drafts.items():
                tokens[s, 1:1 + len(d)] = d
            mask = np.zeros((self.max_slots,), np.int64)
            mask[active] = 1
        # constrained slots: k + 1 masks staged along each slot's drafts,
        # so a grammar-forbidden draft stops the acceptance (m is 0 then:
        # _plan_block caps a constrained block at 1)
        gmasks = self._grammar_spec_masks(active, tokens, k, drafts)
        gm = {} if gmasks is None else {"gmasks": gmasks}
        # the verify is the target's forward: it runs under the slots'
        # adapters (the drafts above were base)
        gm["lora"] = self._lora_args()
        with self.steptrace.scope("dispatch_wait"):
            win = self._window()
            if self.paged is not None:
                width = self._paged_width(
                    max(int(self.slot_len[s]) for s in active) + w)
                base = self._paged_index_vec(width, w)
                valid = np.zeros((self.max_slots,), np.int64)
                for s in active:
                    valid[s] = w
                    self._paged_cow_fork(s, int(self.slot_len[s]), w)
                out = self.graphs.run(
                    "pspec" if gmasks is None else "pmspec", m,
                    all_greedy=True, generator=None, width=width,
                    spec_tokens=tokens, index=base, spec_mask=mask,
                    gidx=self.paged.gather_idx(width),
                    vidx=window_idx(base, width, w),
                    sidx=self.paged.scatter_idx(base, valid, w), **gm)
            else:
                # the whole cache is the view: free rows' dead window is
                # clamped inside it, live rows fit (_spec_applicable and
                # the headroom cap on m)
                base = self._paged_index_vec(self.cache_len, w)
                out = self.graphs.run(
                    "spec" if gmasks is None else "mspec", m,
                    all_greedy=True, generator=None, spec_tokens=tokens,
                    index=base, spec_mask=mask, **gm)
            win.launched()
            spec = out["spec"].cpu().numpy()  # out | n_acc | extra, one copy
            dev_s, wall = win.close()
            # the verify is one (k + 1)-row forward per slot and m
            # single-token steps; useful positions only (an undrafted
            # slot's zero padding is lost MFU)
            useful = {s: len(drafts.get(s, ())) + 1 + m for s in active}
            keys = sum(CostModel.block_keys(useful[s],
                                            int(self.slot_len[s]))
                       for s in active)
            self._note_device_phase(
                "decode", tokens=sum(useful.values()), attended_keys=keys,
                weight_passes=1 + m, kv_read_tokens=keys, dt=dev_s)
        self.spec_rounds += 1
        self.spec_verifies_run += 1
        self.decode_steps_run += m
        self.dispatch_meter.count()
        with self.steptrace.scope("sample_commit"):
            for s in active:
                self.slot_req[s].cp_add("decode_dispatch", wall)
            for s in active:
                n_acc = int(spec[s, k + 1])
                n_drafted = len(drafts.get(s, ()))
                self.spec_proposed += n_drafted
                self.spec_accepted += min(n_acc, n_drafted)
                burst = [int(t) for t in spec[s, :n_acc + 1]]
                burst += [int(t) for t in spec[s, k + 2:]]
                for tok in burst:
                    if self.slot_req[s] is None:
                        break                     # finished mid-burst
                    self._commit_token(s, tok)
                    self.spec_round_tokens += 1
        return True

    # --- grammar (structured output, JAX engine.py:3609-3713) --------------

    def _ensure_constraint(self, req: Request):
        """``req``'s grammar cursor, minted from its compiled automaton at
        first touch (activation), or None."""
        if req.constraint_state is None and req.params.constraint is not None:
            with self.steptrace.scope("grammar_compile"):
                req.constraint_state = req.params.constraint.cursor()
        return req.constraint_state

    def _constrained_active(self, active: list[int]) -> bool:
        return any(self.slot_constraint[s] is not None for s in active)

    def _grammar_mask_rows(self, cursors) -> np.ndarray:
        """(len(cursors), vocab) f32 additive mask rows, zero rows for
        None entries (at least one is not None). The host time, lazy
        state compiles included, goes into
        ``grammar_mask_seconds_total``."""
        t0 = time.monotonic()
        with self.steptrace.scope("grammar_mask"):
            out = np.zeros(
                (len(cursors),
                 next(c.vocab_size for c in cursors if c is not None)),
                np.float32)
            for j, cs in enumerate(cursors):
                if cs is not None:
                    out[j] = self._mask_row(cs)
        self.grammar_mask_seconds_total += time.monotonic() - t0
        return out

    def _mask_row(self, cs) -> np.ndarray:
        """``cs``'s mask row; a lazy vocab-wide compile of its state books
        under ``grammar_compile``."""
        if cs.needs_compile():
            with self.steptrace.scope("grammar_compile"):
                cs.auto.ensure(cs.cur)
        return cs.mask_row()

    def _fill_stage(self, name: str, rows: dict) -> np.ndarray:
        """Write ``rows`` ({index: mask row}) into the graphs' host stage
        of ``name`` in place, and zero the rows the last fill wrote that
        this one does not: the stage is all zeros elsewhere."""
        stage = self.graphs.mask_stage(name)
        for i, row in rows.items():
            stage[i] = row
        for i in self._stage_rows.get(name, set()) - rows.keys():
            stage[i] = 0.0
        self._stage_rows[name] = set(rows)
        return stage

    def _grammar_masks(self, active: list[int]):
        """The (max_slots, vocab) f32 mask of this step's decode (each
        constrained slot's state row, zeros elsewhere), or None when no
        active slot is constrained: the unmasked paths then run."""
        if not self._constrained_active(active):
            return None
        t0 = time.monotonic()
        with self.steptrace.scope("grammar_mask"):
            stage = self._fill_stage("gmask", {
                s: self._mask_row(cs)
                for s, cs in enumerate(self.slot_constraint)
                if cs is not None})
        self.grammar_mask_seconds_total += time.monotonic() - t0
        return stage

    def _grammar_spec_masks(self, active: list[int], tokens, k: int,
                            drafts: dict):
        """The (max_slots, k + 1, vocab) masks of a spec round, or None
        when no active slot is constrained. Each constrained slot's
        grammar advances tentatively over its round's input tokens:
        position ``j`` gets the state after the first ``j`` drafts. A
        forbidden token ends the staging (the acceptance stops there;
        the zero rows past it are inert), and counts in
        ``spec_grammar_rejects`` when it was a real draft, not padding."""
        rows = [(s, self.slot_constraint[s]) for s in active
                if self.slot_constraint[s] is not None]
        if not rows:
            return None
        t0 = time.monotonic()
        with self.steptrace.scope("grammar_mask"):
            staged = {}
            for s, cs in rows:
                auto, cur = cs.auto, cs.cur
                n_drafted = len(drafts.get(s, ()))
                for j in range(k + 1):
                    if not auto.compiled(cur):
                        with self.steptrace.scope("grammar_compile"):
                            auto.ensure(cur)
                    staged[s, j] = auto.mask(cur)
                    if j >= k:
                        break
                    nxt = auto.step(cur, int(tokens[s, j + 1]))
                    if nxt is None:
                        if j < n_drafted:
                            self.spec_grammar_rejects += 1
                        break
                    cur = nxt
            gmasks = self._fill_stage("gmasks", staged)
        self.grammar_mask_seconds_total += time.monotonic() - t0
        return gmasks

    def _constraint_commit(self, slot: int, cs, tok: int) -> None:
        """Advance ``slot``'s grammar cursor over an emitted token; a
        completed value finishes the stream with ``"stop"``. An EOS
        emission is the grammar's own allowed stop (accepting states
        admit it) and is not consumed."""
        if cs is None:
            return
        if self.eos_id is not None and tok == self.eos_id:
            return
        if cs.advance(tok) and self.slot_req[slot] is not None:
            self._finish_slot(slot, "stop")

    # --- decode --------------------------------------------------------------

    def _plan_block(self, active: list[int]) -> int:
        """This step's decode block length (policy in
        :func:`~.mixed_step.plan_decode_block`). While a ready slot is
        constrained the block is 1 (its mask holds one automaton state;
        the spec round is the constrained multi-token path, which this
        drives to ``m = 0``)."""
        if self._constrained_active(active):
            return 1
        soonest = None
        if active and self.pending.qsize() > 0:
            soonest = int(min(
                min(self.slot_budget[s], self.cache_len - 1 - self.slot_len[s])
                for s in active))
        chunk = headroom = None
        if self.slot_prefill:
            chunk = self.chunked_prefill
            headroom = min(self.cache_len - chunk - st["done"]
                           for st in self.slot_prefill.values())
        return plan_decode_block(
            decode_steps=self.decode_steps, queue_depth=self.pending.qsize(),
            soonest_finish=soonest, chunk=chunk, prefill_headroom=headroom)

    def _mixed_feasible(self, n: int) -> tuple[bool, str]:
        """Whether this step can run as one fused dispatch: every write of
        it must land inside the cache, away from attended KV."""
        c = self.chunked_prefill
        if n > c:
            return False, (f"block length exceeds the chunk window: n {n} "
                           f"> chunk {c}")
        for slot, st in self.slot_prefill.items():
            if st["done"] + c + n > self.cache_len:
                return False, (
                    "prefill row near the cache end: "
                    f"slot {slot} done {st['done']} + chunk {c} + block {n} "
                    f"> cache_len {self.cache_len}")
        for s in range(self.max_slots):
            if s in self.slot_prefill or self.slot_req[s] is None:
                continue
            if int(self.slot_len[s]) + c > self.cache_len:
                return False, (
                    "decode row lacks the chunk dead-write window: "
                    f"slot {s} len {int(self.slot_len[s])} + chunk {c} > "
                    f"cache_len {self.cache_len}")
        return True, ""

    def _sampling_arrays(self, active: list[int], gmask=None) -> dict:
        out = dict(all_greedy=bool(self._greedy[active].all()),
                   generator=self.generator, tokens=self.slot_last_token,
                   temperature=self._temperature, top_k=self._top_k,
                   top_p=self._top_p, greedy=self._greedy)
        if gmask is not None:
            out["gmask"] = gmask
        return out

    def _mixed_dispatch(self, active: list[int], n: int) -> bool:
        """Every mid-prefill slot advances one chunk and every ready slot
        decodes an ``n``-block, in one dispatch. Returns False (nothing
        dispatched) only when the paged reservation drained either half:
        the caller then runs the step's remainder sequentially."""
        c = self.chunked_prefill
        if self.paged is not None:
            # the decode half's n rows per ready slot (may preempt); the
            # prefill half was reserved at admission, and the scan's
            # garbage rows above each watermark scatter to the trash page
            with self.steptrace.scope("admit"):
                active = self._paged_reserve_active(active, n)
            if not active or not self.slot_prefill:
                return False
        with self.steptrace.scope("index_build"):
            entries = self._prefill_entries()
            tok, starts, lens = self._chunk_batch_rows(entries)
            advance = np.zeros((self.max_slots,), np.int64)
            advance[active] = n
        # the decode half masks each constrained slot (n is 1 then);
        # mid-prefill rows are masked at their first token, in _activate
        gmask = self._grammar_masks(active)
        masked = "" if gmask is None else "m"
        # the slot plane's adapters cover both halves
        arrays = dict(chunk_ids=tok, starts=starts, lens=lens,
                      advance=advance, lora=self._lora_args(),
                      **self._sampling_arrays(active, gmask))
        # the one fused dispatch's device time splits between the phases
        # by their FLOPs (by tokens without a cost model)
        pf_tokens = sum(len(chunk) for _, _, chunk in entries)
        pf_keys = sum(CostModel.chunk_keys(len(chunk), st["done"])
                      for _, st, chunk in entries)
        dc_tokens = n * len(active)
        dc_keys = sum(CostModel.block_keys(n, int(self.slot_len[s]))
                      for s in active)
        with self.steptrace.scope("dispatch_wait"):
            win = self._window()
            if self.paged is None:
                out = self.graphs.run(masked + "mixed", n, **arrays)
            else:
                # the view holds each prefill row's chunk and the scan's n
                # garbage rows above it, and each occupied decode row's
                # dead chunk window (the scan's real n rows overwrite its
                # head)
                width = self._paged_width(max(
                    [st["done"] + c + n for _, st, _ in entries]
                    + [int(self.slot_len[s]) + c
                       for s in range(self.max_slots)
                       if s not in self.slot_prefill
                       and self.slot_req[s] is not None] + [c + n]))
                starts = np.minimum(starts, width - c)
                valid = np.zeros((self.max_slots,), np.int64)
                for slot, st, chunk in entries:
                    starts[slot] = st["done"]
                    valid[slot] = len(chunk)
                    self._paged_cow_fork(slot, st["done"], len(chunk))
                for s in active:
                    valid[s] = n
                    self._paged_cow_fork(s, int(self.slot_len[s]), n)
                arrays["starts"] = starts
                out = self.graphs.run(
                    "p" + masked + "mixed", n, width=width,
                    gidx=self.paged.gather_idx(width),
                    vidx=window_idx(starts, width, c),
                    sidx=self.paged.scatter_idx(starts, valid, c), **arrays)
            win.launched()
            toks = out["toks"].cpu().numpy()
            dev_s, wall = win.close()
            self.mixed_blocks += 1
            self.chunk_batches_run += 1
            self.decode_steps_run += n
            self.dispatch_meter.count()
            for slot, st, chunk in entries:
                # a copy: the graph's output is rewritten by its next
                # replay
                st["last_logits"] = out["chunk_last"][slot:slot + 1].clone()
                st["done"] += len(chunk)
            self._trace_chunks(entries, wall, batched=True, fused=True)
            cm = self.cost_model
            if cm is not None:
                pf, df = (cm.step_flops(pf_tokens, pf_keys),
                          cm.step_flops(dc_tokens, dc_keys))
                share = pf / (pf + df) if pf + df > 0 else 0.5
            else:
                share = pf_tokens / max(pf_tokens + dc_tokens, 1)
            self._note_device_phase(
                "prefill", tokens=pf_tokens, attended_keys=pf_keys,
                weight_passes=1, kv_read_tokens=pf_keys, dt=dev_s * share)
            self._note_device_phase(
                "decode", tokens=dc_tokens, attended_keys=dc_keys,
                weight_passes=n, kv_read_tokens=dc_keys,
                dt=dev_s * (1 - share))
        with self.steptrace.scope("sample_commit"):
            # the decode rows waited the whole fused dispatch too
            for s in active:
                self.slot_req[s].cp_add("decode_dispatch", wall)
            self._finalize_prefills()
            self._commit_block(active, toks, n)
        return True

    def _decode_index(self) -> np.ndarray:
        """Each row's write index for a decode block: a ready row at its
        length, a mid-prefill row at its watermark (the block's garbage
        rows above it are rewritten by its next chunk), a free row at 0
        (dead). A row is never sent to 0 while it holds a prompt's KV."""
        index = np.zeros((self.max_slots,), np.int64)
        for s in range(self.max_slots):
            if s in self.slot_prefill:
                index[s] = self.slot_prefill[s]["done"]
            elif self.slot_req[s] is not None:
                index[s] = self.slot_len[s]
        return index

    def _decode(self, active: list[int], n: int) -> None:
        # each constrained slot's mask row, applied in the same dispatch
        # (_plan_block made n 1; decode_scan raises otherwise)
        gmask = self._grammar_masks(active)
        lora = self._lora_args()
        with self.steptrace.scope("dispatch_wait"):
            win = self._window()
            if self.paged is not None:
                out = self._paged_decode_dispatch(active, n, gmask, lora)
            else:
                out = self.graphs.run(
                    "decode" if gmask is None else "mdecode", n,
                    index=self._decode_index(), lora=lora,
                    **self._sampling_arrays(active, gmask))
            win.launched()
            toks = out["toks"].cpu().numpy()
            dev_s, wall = win.close()
            keys = sum(CostModel.block_keys(n, int(self.slot_len[s]))
                       for s in active)
            self._note_device_phase(
                "decode", tokens=n * len(active), attended_keys=keys,
                weight_passes=n, kv_read_tokens=keys, dt=dev_s)
        self.decode_steps_run += n
        self.dispatch_meter.count()
        with self.steptrace.scope("sample_commit"):
            for s in active:
                self.slot_req[s].cp_add("decode_dispatch", wall)
            self._commit_block(active, toks, n)

    def step(self) -> bool:
        """One engine iteration. Returns False when fully idle. The step
        recorder brackets the whole step (the Perfetto lanes are captured
        only while the tracer has a file sink); an idle poll records
        nothing. While :func:`~..obs.debug.enable_debug` traps NaNs the
        step runs under the trap."""
        with self._lock, CAPTURE_LOCK.work(), torch.inference_mode(), \
                debug.step_trap():
            before = self.dispatch_meter.total
            self.steptrace.step_begin(
                timeline=getattr(self.tracer, "has_file_sink", False))
            busy = False
            try:
                busy = self._step_locked()
                return busy
            finally:
                spent = self.dispatch_meter.total - before
                self.last_step_dispatches = spent
                if busy or spent:
                    self.dispatch_meter.note_step(spent)
                    self.steptrace.step_end(self.tracer)
                else:
                    self.steptrace.step_abort()
                self._update_stats()

    def _step_locked(self) -> bool:
        with self.steptrace.scope("admit"):
            admitted = self._admit()
        budget = self.prefill_budget
        active = self._ready_slots()
        # at decode_steps 1 a spec engine keeps speculating while prompts
        # prefill: a round yields 1 + accepted tokens per dispatch, the
        # fused step one. A decode replica never suspends it (a prefill
        # there is the rare degraded path, JAX engine.py:4012-4025). It
        # composes only where the round can run after this step's chunks
        # have advanced each prefill row
        with self.steptrace.scope("plan"):
            spec_composes = (
                (self.decode_steps == 1 or self.role == "decode")
                and self._spec_applicable(active)
                and all(st["done"] + budget * self.chunked_prefill
                        + self.speculative_k + 1 <= self.cache_len
                        for st in self.slot_prefill.values()))
        pre_progress = False
        if (self.mixed_step and self.slot_prefill and active
                and not spec_composes):
            if budget > 1:
                # the fused step carries one chunk; spend the rest of the
                # prefill budget first, and let a prompt that finishes
                # there join this step's block
                pre_progress = self._advance_prefills(budget - 1)
                budget = 1
                active = self._ready_slots()
            if self.slot_prefill and active:
                with self.steptrace.scope("plan"):
                    n = self._plan_block(active)
                    ok, why = self._mixed_feasible(n)
                # a decode replica reaches here only where speculation
                # cannot run at all, so it never logs a suspension
                if (ok and self.speculative_k is not None
                        and self.role != "decode"
                        and not self._spec_suspended_logged):
                    self._spec_suspended_logged = True
                    _log.info("speculative decoding suspended while a "
                              "prompt is mid-prefill: the fused mixed "
                              "step runs plain decode blocks (greedy "
                              "outputs are unchanged: spec is lossless); "
                              "speculation resumes when no prefill is in "
                              "flight")
                if ok and self._mixed_dispatch(active, n):
                    return True
                if not ok:
                    kind = why.split(":", 1)[0]   # log each kind once
                    if kind not in self._mixed_fallbacks_logged:
                        self._mixed_fallbacks_logged.add(kind)
                        _log.info("fused mixed step fell back to "
                                  "sequential dispatches: %s", why)
        progressed = self._advance_prefills(budget) or pre_progress
        active = self._ready_slots()
        if not active:
            return admitted or progressed or bool(self.slot_prefill)
        if self._try_speculative(active):
            return True
        with self.steptrace.scope("plan"):
            n = self._plan_block(active)
            # every row the block writes must land inside the cache
            if n > 1 and any(self.slot_len[s] + n > self.cache_len
                             for s in active):
                n = 1
        if self.paged is not None:
            with self.steptrace.scope("admit"):
                active = self._paged_reserve_active(active, n)
            if not active:
                return True   # the reservation preempted or finished all
        self._decode(active, n)
        return True

    # --- background loop -----------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="inference-engine")
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                with self._pause:    # a paused() caller holds the loop here
                    pass
                if not self.step():  # idle: wait for a submit
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
        except Exception as e:  # noqa: BLE001 — the loop's boundary: record
            # the fault; waiting requests see EngineDeadError via is_alive
            self.error = e
            _log.exception("inference engine loop died")

    def _hbm_book(self, owner: str, n_bytes: int) -> None:
        """Book one durable allocation under ``owner`` and remember it, so
        :meth:`stop` frees exactly what ``__init__`` booked."""
        self._hbm.book(owner, n_bytes)
        self._hbm_booked[owner] = n_bytes

    def stop(self) -> None:
        """Stop the loop and the publishers, drop every session pin, and
        return every ledger byte this engine booked (idempotent: a second
        stop finds the books already empty)."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        for _ in self._publishers:   # each publisher exits on a None
            self._publish_queue.put(None)
        self._publishers = []
        if self.session_store is not None:
            # pool leak checks then see only live-slot references
            self.session_store.close()
        self._hbm_release()
        unwatch_builds(self.compile_meter)
        if self.paged is not None:
            self.paged.close()

    @contextlib.contextmanager
    def paused(self):
        """No step in flight while open. The loop waits at ``_pause``
        before its next step, so the caller holds the step lock from the
        end of the step in flight, however busy the engine (a bare
        ``with engine._lock`` can lose the lock to the loop for as long as
        work keeps coming)."""
        with self._pause, self._lock:
            yield

    def is_alive(self) -> bool:
        """True while submitted requests can still make progress."""
        if self._stop.is_set() or self.error is not None:
            return False
        return self._thread is None or self._thread.is_alive()

    # --- introspection -------------------------------------------------------

    def debug_kv(self) -> dict:
        """The ``GET /debug/kv`` payload: page-pool occupancy, sharing,
        fragmentation and per-slot block-table sizes; a contiguous engine
        reports its fixed reservation. Read from HTTP threads without the
        engine lock, as in JAX."""
        if self.paged is None:
            return {
                "layout": "contiguous",
                "max_slots": self.max_slots,
                "cache_len": self.cache_len,
                "kv_tokens_reserved": self.max_slots * self.cache_len,
                "ledger_account": "kv.contiguous",
                "kv_bytes": _kv_bytes(self.cache),
            }
        snap = self.paged.debug_snapshot()
        live = 0
        for s in range(self.max_slots):
            # .get: the engine thread pops slot_prefill concurrently
            st = self.slot_prefill.get(s)
            if st is not None:
                live += int(st["done"])
            elif self.slot_req[s] is not None:
                live += int(self.slot_len[s])
        mapped_tokens = snap["pages_slot_mapped"] * self.paged.page_size
        snap["live_tokens"] = live
        # allocated-but-unfilled slack of the slot-mapped pages: the
        # contiguous layout's (cache_len - context) per slot, shrunk to
        # under a page
        snap["fragmentation"] = (
            round(1.0 - live / mapped_tokens, 4) if mapped_tokens else 0.0)
        snap["preemptions"] = self.preemptions
        snap["rejected_too_large"] = self.rejected_too_large
        # the draft cache's tax on an explicit pool, in target tokens and
        # in the bytes of its tensors
        snap["draft_kv_reserved_tokens"] = self.draft_kv_reserved_tokens
        snap["draft_kv_account_bytes"] = self.draft_kv_bytes()
        if self.prefix_cache is not None:
            snap["prefix_index_entries"] = self.prefix_cache.n_entries
        return snap

    def draft_kv_bytes(self) -> int:
        """Device bytes of the draft model's K and V cache (0 without a
        draft): its ledger account ``kv.draft``."""
        if self.draft_cache is None:
            return 0
        return _kv_bytes(self.draft_cache)

    def debug_requests(self, limit: int = 64) -> dict:
        """The ``GET /debug/requests`` payload: the ring of recently
        finished requests, each with its critical-path segments
        (``CP_SEGMENTS``). The engine segments partition the request's
        submit-to-finish wall time (``host_gap`` is the residual);
        ``stream_flush`` is the API's SSE tail, measured concurrently with
        decode, and may be absent while a stream's handler is still
        open. Lock-free snapshots of the GIL-atomic deque."""
        now = time.monotonic()
        out = []
        for r in list(self.finished)[-limit:]:
            wall = (r.finish_time - r.submit_time
                    if r.finish_time is not None else None)
            out.append({
                "uid": r.uid,
                "finish_reason": r.finish_reason,
                "prompt_tokens": len(r.prompt_ids),
                "completion_tokens": r.n_generated,
                "cache": r.cache_outcome,
                "ttft_s": (round(r.ttft_s, 6)
                           if r.ttft_s is not None else None),
                "wall_s": round(wall, 6) if wall is not None else None,
                "age_s": (round(now - r.finish_time, 3)
                          if r.finish_time is not None else None),
                "segments": {k: round(v, 6) for k, v in r.cp.items()},
            })
        return {
            "capacity": self.finished.maxlen,
            "segments": list(CP_SEGMENTS),
            "critical_path_seconds_total":
                {k: round(v, 6) for k, v in
                 self.stats.critical_path_snapshot().items()},
            "finished": out,
        }

    def debug_sessions(self) -> dict:
        """The ``GET /debug/sessions`` payload: pinned conversations and
        the turn, eviction and pull counters; ``{"enabled": false}``
        without a store, so the route answers on every replica."""
        if self.session_store is None:
            return {"enabled": False}
        return self.session_store.debug_snapshot()

    def page_capacity_detail(self, prompt_tokens: int) -> dict:
        """Why a prompt gets 422: the page math of the API's error body."""
        P = self.paged.page_size
        return {"prompt_tokens": prompt_tokens, "page_size": P,
                "pages_needed": pages_for(prompt_tokens + 1, P),
                "pages_capacity": self.paged.pool.capacity}

    # --- convenience ---------------------------------------------------------

    def generate(self, prompt_ids, params: SamplingParams | None = None,
                 *, adapter: str | None = None) -> list[int]:
        """Blocking single-request helper (drives steps if no thread runs)."""
        req = self.submit(prompt_ids, params, adapter=adapter)
        if self._thread is None:
            while self.step():
                pass
        return req.result()
