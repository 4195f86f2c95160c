"""Continuous-batching inference engine, contiguous KV core.

Port of ``llm_in_practise_tpu/serve/engine.py`` (the contiguous layout):

- **Slot-based KV cache**: one ``(max_slots, cache_len, n_kv_head,
  head_dim)`` buffer pair per layer. Requests are admitted into free slots
  mid-flight; every step decodes all slots in one batched forward.
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

Threading: HTTP handler threads call :meth:`InferenceEngine.submit`,
which touches no tensor; one background thread runs :meth:`step` and
does all device work. Tokens stream to per-request queues.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from llm_in_practise_tpu_torch.infer.sampling import sample_token_batched
from llm_in_practise_tpu_torch.serve.graphs import StepGraphs
from llm_in_practise_tpu_torch.serve.mixed_step import (
    batched_chunk,
    plan_decode_block,
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
    constraint: Any = None  # structured output: not ported, must stay None


_FINISH = object()  # sentinel closing a request's token queue


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

    On the card each decode block and each fused mixed step is one CUDA
    graph replay (:mod:`.graphs`).
    """

    def __init__(self, model, *, max_slots: int = 8, cache_len: int = 512,
                 eos_id: int | None = None, cache_dtype=torch.bfloat16,
                 seed: int = 0, prefix_cache=None,
                 chunked_prefill: int | None = None, mesh=None,
                 speculative_k: int | None = None, draft_model=None,
                 decode_steps: int = 1, prefill_budget: int = 1,
                 mixed_step: bool = True, kv_layout: str = "contiguous",
                 adapter_registry=None, max_queue: int | None = None,
                 queue_timeout_s: float | None = None):
        if prefix_cache:
            raise _not_ported("prefix_cache", 3, "prefix KV reuse")
        if speculative_k is not None or draft_model is not None:
            raise _not_ported("speculative_k", 4, "speculative decoding")
        if kv_layout != "contiguous":
            if kv_layout == "paged":
                raise _not_ported("kv_layout='paged'", 3, "paged KV")
            raise ValueError(f"kv_layout must be 'contiguous' or 'paged', "
                             f"got {kv_layout!r}")
        if mesh is not None:
            raise _not_ported("mesh", 14, "sharded serving")
        if adapter_registry is not None:
            raise _not_ported("adapter_registry", 5, "LoRA serving")
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
        self.model = model
        self.device = model.device
        self.max_slots = max_slots
        limit = getattr(model.config, "max_seq_len", None)
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
        self.cache = model.init_cache(max_slots, self.cache_len,
                                      dtype=cache_dtype)
        self.graphs = StepGraphs(model, self.cache, max_slots=max_slots,
                                 chunk=chunked_prefill,
                                 decode_steps=decode_steps,
                                 capture=self.device.type == "cuda")

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

        self.pending: "queue.Queue[Request]" = queue.Queue()
        self._uid = itertools.count()
        self._lock = threading.Lock()
        # serializes the max_queue check-then-put (two HTTP threads must
        # not both see depth N-1) and the shed count
        self._submit_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None
        self._mixed_fallbacks_logged: set[str] = set()
        # counters: forward passes by kind (decode tokens stepped over
        # every slot; one-shot prefill batches; batched chunks over every
        # slot, the fused step's included; single-slot chunks), blocks,
        # sheds, and step-path dispatches (the JAX DispatchMeter's count)
        self.decode_steps_run = 0
        self.prefill_batches_run = 0
        self.chunk_batches_run = 0
        self.chunk_slots_run = 0
        self.mixed_blocks = 0
        self.multi_blocks = 0
        self.multi_steps_total = 0
        self.requests_shed = 0
        self.dispatches_total = 0
        self.last_step_dispatches = 0

    # --- submission ----------------------------------------------------------

    def submit(self, prompt_ids, params: SamplingParams | None = None) -> Request:
        """Queue a request; safe from any thread (touches no tensor). Past
        ``max_queue`` waiting requests it is shed at once."""
        params = params or SamplingParams()
        if params.constraint is not None:
            raise _not_ported("SamplingParams.constraint", 5,
                              "structured output")
        prompt_ids = list(map(int, prompt_ids))
        if not prompt_ids:
            raise ValueError("empty prompt")
        max_prompt = self.cache_len - 2
        if len(prompt_ids) > max_prompt:  # sliding-window crop
            prompt_ids = prompt_ids[-max_prompt:]
        req = Request(next(self._uid), prompt_ids, params, engine=self)
        with self._submit_lock:
            shed = (self.max_queue is not None
                    and self.pending.qsize() >= self.max_queue)
            if not shed:
                self.pending.put(req)
        if shed:
            return self._shed(req)
        self._wake.set()
        return req

    def _shed(self, req: Request) -> Request:
        """Finish ``req`` at once with ``finish_reason="queue_full"`` and no
        tokens; the API layer answers 429."""
        req.finish_time = time.monotonic()
        req.finish_reason = "queue_full"
        req.tokens.put(_FINISH)
        with self._submit_lock:
            self.requests_shed += 1
        return req

    # --- admission and prefill -----------------------------------------------

    def _admit(self) -> bool:
        """Shed the stale head of the queue, then move pending requests into
        free slots: long prompts start a chunked prefill, the rest prefill
        together in one batched forward."""
        timeout_s = self.queue_timeout_s
        if timeout_s is not None:
            # FIFO: staleness is monotone from the head
            now = time.monotonic()
            while True:
                with self.pending.mutex:
                    head = self.pending.queue[0] if self.pending.queue else None
                    if head is None or now - head.submit_time <= timeout_s:
                        break
                    self.pending.queue.popleft()
                self._shed(head)
        admitted = False
        batch: list[tuple[int, Request]] = []
        for slot in range(self.max_slots):
            if self.slot_req[slot] is not None:
                continue
            req = None
            while req is None:
                try:
                    req = self.pending.get_nowait()
                except queue.Empty:
                    break
                if (timeout_s is not None
                        and time.monotonic() - req.submit_time > timeout_s):
                    self._shed(req)
                    req = None
            if req is None:
                break
            plen = len(req.prompt_ids)
            self.slot_req[slot] = req   # reserved; activated after prefill
            self.slot_ready[slot] = False
            if self._should_chunk(0, plen):
                self.slot_prefill[slot] = {"req": req, "plen": plen,
                                           "done": 0, "last_logits": None}
            else:
                batch.append((slot, req))
            admitted = True
        if batch:
            self._prefill_batch(batch)
        return admitted

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

    def _prefill_batch(self, batch: list[tuple[int, Request]]) -> None:
        dev = self.device
        n = len(batch)
        lens = [len(req.prompt_ids) for _, req in batch]
        width = max(lens)
        ids = np.zeros((n, width), np.int64)
        for j, (_, req) in enumerate(batch):
            ids[j, :lens[j]] = req.prompt_ids
        pre = self.model.init_cache(n, width, dtype=self.cache_dtype)
        hidden, pre = self.model(torch.from_numpy(ids).to(dev), cache=pre,
                                 return_hidden=True)
        last_pos = torch.tensor(lens, device=dev) - 1
        last = hidden[torch.arange(n, device=dev), last_pos]     # (n, D)
        logits = self.model.head(last).to(torch.float32)         # (n, V)
        slots = torch.tensor([s for s, _ in batch], device=dev)
        for eng, layer in zip(self.cache, pre):
            eng["k"][slots, :width] = layer["k"]
            eng["v"][slots, :width] = layer["v"]
        first = sample_token_batched(
            self.generator, logits,
            temperature=torch.tensor(
                [r.params.temperature for _, r in batch], device=dev),
            top_k=torch.tensor([r.params.top_k for _, r in batch], device=dev),
            top_p=torch.tensor([r.params.top_p for _, r in batch], device=dev),
            greedy=torch.tensor([r.params.greedy for _, r in batch],
                                device=dev),
        ).cpu().numpy()
        self.prefill_batches_run += 1
        self.dispatches_total += 1
        for j, (slot, req) in enumerate(batch):
            self._activate_with_token(slot, req, lens[j], int(first[j]))

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
        the single-slot chunk. Then activate finished prompts."""
        c = self.chunked_prefill
        progressed = False
        while budget > 0 and self.slot_prefill:
            entries = self._prefill_entries()
            batchable = len(entries) > 1 and all(
                int(self.slot_len[s]) + c <= self.cache_len
                for s in range(self.max_slots)
                if s not in self.slot_prefill
                and self.slot_req[s] is not None)   # free rows are dead
            if batchable:
                tok, starts, lens = self._chunk_batch_rows(entries)
                dev = self.device
                last, _ = batched_chunk(
                    self.model, self.cache, torch.from_numpy(tok).to(dev),
                    torch.from_numpy(starts).to(dev),
                    torch.from_numpy(lens).to(dev))
                self.chunk_batches_run += 1
                self.dispatches_total += 1
                for slot, st, chunk in entries:
                    st["last_logits"] = last[slot:slot + 1]
                    st["done"] += len(chunk)
            else:
                for slot, st, chunk in entries:
                    st["last_logits"] = self._chunk_slot(slot, chunk,
                                                         st["done"])
                    st["done"] += len(chunk)
            budget -= 1
            progressed = True
            self._finalize_prefills()
        return progressed

    def _chunk_slot(self, slot: int, chunk: list[int], done: int
                    ) -> torch.Tensor:
        """One padded chunk of ``slot`` at ``done``, against a one-slot view
        of the cache (its writes land in the slot's own rows). Returns the
        (1, vocab) f32 logits at the chunk's last real position."""
        dev = self.device
        ids = np.zeros((1, self.chunked_prefill), np.int64)
        ids[0, :len(chunk)] = chunk
        view = [{"k": layer["k"][slot:slot + 1],
                 "v": layer["v"][slot:slot + 1],
                 "index": torch.tensor([done], device=dev)}
                for layer in self.cache]
        hidden, _ = self.model(torch.from_numpy(ids).to(dev), cache=view,
                               return_hidden=True)
        self.chunk_slots_run += 1
        self.dispatches_total += 1
        return self.model.head(hidden[:, len(chunk) - 1]).to(torch.float32)

    def _finalize_prefills(self) -> None:
        """Activate every chunked prefill whose prompt is fully fed."""
        for slot in list(self.slot_prefill):
            st = self.slot_prefill[slot]
            if st["done"] < st["plen"]:
                continue
            del self.slot_prefill[slot]
            self._activate(slot, st["req"], st["plen"], st["last_logits"])

    def _activate(self, slot: int, req: Request, plen: int,
                  last_logits: torch.Tensor) -> None:
        """Sample the first token from the prompt's last logits and make the
        slot decodable."""
        dev, p = self.device, req.params
        first = sample_token_batched(
            self.generator, last_logits,
            temperature=torch.tensor([p.temperature], device=dev),
            top_k=torch.tensor([p.top_k], device=dev),
            top_p=torch.tensor([p.top_p], device=dev),
            greedy=torch.tensor([p.greedy], device=dev))
        self._activate_with_token(slot, req, plen, int(first[0]))

    def _activate_with_token(self, slot: int, req: Request, plen: int,
                             first_id: int) -> None:
        req.first_token_time = time.monotonic()
        self.slot_req[slot] = req
        self.slot_ready[slot] = True
        self.slot_last_token[slot] = first_id
        self.slot_len[slot] = plen
        self.slot_budget[slot] = req.params.max_tokens - 1
        self._temperature[slot] = req.params.temperature
        self._top_k[slot] = req.params.top_k
        self._top_p[slot] = req.params.top_p
        self._greedy[slot] = req.params.greedy
        self._emit(slot, first_id)

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
        req = self.slot_req[slot]
        req.finish_time = time.monotonic()
        req.finish_reason = reason
        req.tokens.put(_FINISH)
        self.slot_req[slot] = None
        self.slot_ready[slot] = False
        self.slot_budget[slot] = 0

    def _commit_token(self, slot: int, tok: int) -> None:
        self.slot_budget[slot] -= 1
        self.slot_len[slot] += 1
        self.slot_last_token[slot] = tok
        self._emit(slot, tok)

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

    # --- decode --------------------------------------------------------------

    def _plan_block(self, active: list[int]) -> int:
        """This step's decode block length (policy in
        :func:`~.mixed_step.plan_decode_block`)."""
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

    def _sampling_arrays(self, active: list[int]) -> dict:
        return dict(all_greedy=bool(self._greedy[active].all()),
                    generator=self.generator, tokens=self.slot_last_token,
                    temperature=self._temperature, top_k=self._top_k,
                    top_p=self._top_p, greedy=self._greedy)

    def _mixed_dispatch(self, active: list[int], n: int) -> None:
        """Every mid-prefill slot advances one chunk and every ready slot
        decodes an ``n``-block, in one dispatch."""
        entries = self._prefill_entries()
        tok, starts, lens = self._chunk_batch_rows(entries)
        advance = np.zeros((self.max_slots,), np.int64)
        advance[active] = n
        out = self.graphs.run("mixed", n, chunk_ids=tok, starts=starts,
                              lens=lens, advance=advance,
                              **self._sampling_arrays(active))
        toks = out["toks"].cpu().numpy()
        self.mixed_blocks += 1
        self.chunk_batches_run += 1
        self.decode_steps_run += n
        self.dispatches_total += 1
        for slot, st, chunk in entries:
            # a copy: the graph's output is rewritten by its next replay
            st["last_logits"] = out["chunk_last"][slot:slot + 1].clone()
            st["done"] += len(chunk)
        self._finalize_prefills()
        self._commit_block(active, toks, n)

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
        out = self.graphs.run("decode", n, index=self._decode_index(),
                              **self._sampling_arrays(active))
        toks = out["toks"].cpu().numpy()
        self.decode_steps_run += n
        self.dispatches_total += 1
        self._commit_block(active, toks, n)

    def step(self) -> bool:
        """One engine iteration. Returns False when fully idle."""
        with self._lock, torch.inference_mode():
            before = self.dispatches_total
            try:
                return self._step_locked()
            finally:
                self.last_step_dispatches = self.dispatches_total - before

    def _step_locked(self) -> bool:
        admitted = self._admit()
        budget = self.prefill_budget
        active = self._ready_slots()
        pre_progress = False
        if self.mixed_step and self.slot_prefill and active:
            if budget > 1:
                # the fused step carries one chunk; spend the rest of the
                # prefill budget first, and let a prompt that finishes
                # there join this step's block
                pre_progress = self._advance_prefills(budget - 1)
                budget = 1
                active = self._ready_slots()
            if self.slot_prefill and active:
                n = self._plan_block(active)
                ok, why = self._mixed_feasible(n)
                if ok:
                    self._mixed_dispatch(active, n)
                    return True
                kind = why.split(":", 1)[0]   # log each kind once
                if kind not in self._mixed_fallbacks_logged:
                    self._mixed_fallbacks_logged.add(kind)
                    _log.info("fused mixed step fell back to sequential "
                              "dispatches: %s", why)
        progressed = self._advance_prefills(budget) or pre_progress
        active = self._ready_slots()
        if not active:
            return admitted or progressed or bool(self.slot_prefill)
        n = self._plan_block(active)
        # every row the block writes must land inside the cache
        if n > 1 and any(self.slot_len[s] + n > self.cache_len
                         for s in active):
            n = 1
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
                if not self.step():  # idle: wait for a submit
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
        except Exception as e:  # noqa: BLE001 — the loop's boundary: record
            # the fault; waiting requests see EngineDeadError via is_alive
            self.error = e
            _log.exception("inference engine loop died")

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def is_alive(self) -> bool:
        """True while submitted requests can still make progress."""
        if self._stop.is_set() or self.error is not None:
            return False
        return self._thread is None or self._thread.is_alive()

    # --- convenience ---------------------------------------------------------

    def generate(self, prompt_ids, params: SamplingParams | None = None
                 ) -> list[int]:
        """Blocking single-request helper (drives steps if no thread runs)."""
        req = self.submit(prompt_ids, params)
        if self._thread is None:
            while self.step():
                pass
        return req.result()
