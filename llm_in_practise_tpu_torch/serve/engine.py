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
    """

    def __init__(self, model, *, max_slots: int = 8, cache_len: int = 512,
                 eos_id: int | None = None, cache_dtype=torch.bfloat16,
                 seed: int = 0, prefix_cache=None,
                 chunked_prefill: int | None = None, mesh=None,
                 speculative_k: int | None = None, draft_model=None,
                 decode_steps: int = 1, kv_layout: str = "contiguous",
                 adapter_registry=None, max_queue: int | None = None,
                 queue_timeout_s: float | None = None):
        if prefix_cache:
            raise _not_ported("prefix_cache", 3, "prefix KV reuse")
        if chunked_prefill is not None:
            raise _not_ported("chunked_prefill", 2, "chunked prefill")
        if decode_steps != 1:
            raise _not_ported("decode_steps>1", 2, "multi-step decode")
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
        if max_queue is not None or queue_timeout_s is not None:
            raise _not_ported("max_queue/queue_timeout_s", 2,
                              "admission control")
        self.model = model
        self.device = model.device
        self.max_slots = max_slots
        limit = getattr(model.config, "max_seq_len", None)
        self.cache_len = min(cache_len, limit) if limit else cache_len
        self.eos_id = eos_id
        self.cache_dtype = cache_dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.cache = model.init_cache(max_slots, self.cache_len,
                                      dtype=cache_dtype)

        # host-side slot table: slot_len mirrors each slot's cache depth,
        # so no finish check ever waits on the device
        self.slot_req: list[Request | None] = [None] * max_slots
        self.slot_ready = np.zeros((max_slots,), bool)
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
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None
        self.decode_steps_run = 0
        self.prefill_batches_run = 0

    # --- submission ----------------------------------------------------------

    def submit(self, prompt_ids, params: SamplingParams | None = None) -> Request:
        """Queue a request; safe from any thread (touches no tensor)."""
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
        self.pending.put(req)
        self._wake.set()
        return req

    # --- admission and prefill -----------------------------------------------

    def _admit(self) -> bool:
        """Move pending requests into free slots and prefill them in one
        batched forward."""
        batch: list[tuple[int, Request]] = []
        for slot in range(self.max_slots):
            if self.slot_req[slot] is not None:
                continue
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                break
            self.slot_req[slot] = req   # reserved; activated after prefill
            self.slot_ready[slot] = False
            batch.append((slot, req))
        if batch:
            self._prefill_batch(batch)
        return bool(batch)

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
        for j, (slot, req) in enumerate(batch):
            self._activate_with_token(slot, req, lens[j], int(first[j]))

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

    def _ready_slots(self) -> list[int]:
        return [s for s, r in enumerate(self.slot_req)
                if r is not None and self.slot_ready[s]]

    # --- decode --------------------------------------------------------------

    def _decode(self, active: list[int]) -> None:
        dev = self.device
        # idle slots decode too (one batched forward over every slot, as the
        # reference does) at depth 0; their rows are rewritten on admission
        index = np.zeros((self.max_slots,), np.int64)
        index[active] = self.slot_len[active]
        index_t = torch.from_numpy(index).to(dev)
        for layer in self.cache:
            layer["index"] = index_t
        tokens = torch.from_numpy(self.slot_last_token).to(dev)[:, None]
        logits, _ = self.model(tokens, cache=self.cache)
        greedy = self._greedy.copy()
        greedy[[s for s in range(self.max_slots) if s not in active]] = True
        next_tok = sample_token_batched(
            self.generator, logits[:, -1, :].to(torch.float32),
            temperature=torch.from_numpy(self._temperature).to(dev),
            top_k=torch.from_numpy(self._top_k).to(dev),
            top_p=torch.from_numpy(self._top_p).to(dev),
            greedy=torch.from_numpy(greedy).to(dev),
        ).cpu().numpy()
        self.decode_steps_run += 1
        for slot in active:
            self._commit_token(slot, int(next_tok[slot]))

    def step(self) -> bool:
        """One engine iteration. Returns False when fully idle."""
        with self._lock, torch.inference_mode():
            admitted = self._admit()
            active = self._ready_slots()
            if active:
                self._decode(active)
            return admitted or bool(active)

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
