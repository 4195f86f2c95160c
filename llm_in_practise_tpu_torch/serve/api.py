"""OpenAI-compatible HTTP server over the continuous-batching engine.

Port of the chat part of ``llm_in_practise_tpu/serve/api.py``:

- ``POST /v1/chat/completions``, non-streaming and SSE streaming
  (``data:`` chunks, then ``data: [DONE]``);
- the ChatML generation prompt built from the OpenAI messages;
- usage accounting, ``GET /v1/models``, ``GET /health``;
- 429 ``queue_full`` (``rate_limit_error``) for a request the engine's
  admission control shed, at submit or after its queue timeout;
- 422 ``prompt_too_large`` with the page math for a prompt that can never
  fit a paged engine's pool (JAX ``api.py:484-497``);
- ``GET /debug/kv``: the engine's KV layout report (JAX ``api.py:1123``);
- structured output (JAX ``api.py:114-170, 372-386, 636-653``):
  ``response_format`` ``json_object`` / ``json_schema`` and forced tool
  calls (``tool_choice`` ``"required"`` or a function) compile through a
  per-server :class:`~.constrain.ConstraintCompiler` against the
  engine's decoded vocabulary, and the engine enforces the grammar in
  its masked step paths; an unsupported schema is a 422
  ``invalid_constraint`` before any engine work; a forced call that
  ends in ``stop`` comes back as ``tool_calls``; ``tools`` with
  ``tool_choice`` ``auto`` / ``none`` is served unconstrained;
- ``POST /v1/embeddings`` (JAX ``api.py:182-252``): the final hidden
  states mean-pooled over each input and unit-normalized, one eager
  forward per input at that input's length;
- LoRA adapters as extra model names (vLLM's ``--lora-modules``, JAX
  ``api.py:77-103, 175-178``): ``adapters`` maps each name to an engine
  or an :class:`~.multi_lora.AdapterHandle`, which the request's
  ``model`` field picks (:meth:`OpenAIServer.engine_for`); an unknown
  ``model`` is a 404 that lists every name, and ``GET /v1/models`` lists
  the base and the adapters. ``/v1/embeddings`` under an adapter's name
  pools its engine's model with no adapter context, so a handle on the
  shared engine answers the base model's vectors, as in JAX.

- disaggregated prefill/decode (JAX ``api.py:254-345, 391-473``,
  :mod:`.disagg`): ``POST /internal/handoff/prefill`` prefills a chat
  request on a prefill-capable replica, publishes its KV and answers the
  handoff id (501 on a decode replica or a model without a handoff
  store, 422 / 429 / 503 as a chat would, 503 ``handoff_failed`` when the
  publish failed); a chat request carrying ``kv_transfer_params``
  ``{"handoff_id": ...}`` claims that entry from the store and decodes
  from it (a lost claim re-prefills locally), and a shed request re-pins
  its claimed entry so the retry elsewhere can still claim it.

- sessions (JAX ``api.py:351-355, 422-448``, :mod:`.sessions`): a chat
  names its conversation by the ``X-Session-ID`` header (which wins) or
  the body's ``session_id``; on an engine with a session store, an
  unknown session claims ``session_hid(sid)`` from the handoff store and
  adopts it (a lost entry is counted and prefills locally, never a 5xx);
  ``GET /debug/sessions`` reports the store;
- the planes (JAX ``api.py:668-1087, 1123-1158``): ``GET /metrics``
  renders :meth:`OpenAIServer._build_registry`'s families over the live
  counters of the engine, the meters, the store, the adapter registry
  and the HBM ledger (the build identity, dispatches and their per-phase
  MFU / bandwidth, compile events, the step timeline's busy and host-gap
  fractions, TTFT / TPOT histograms, the critical path and SLO goodput);
  ``GET /debug/hbm`` is the ledger's ownership tree, ``GET
  /debug/requests`` the recent requests' critical paths, ``GET
  /debug/traces`` the span ring and ``POST /debug/profile`` a bounded
  ``torch.profiler`` capture;
- tracing (JAX ``api.py:291-581, 1178-1192``): a chat is an ``api.chat``
  span (a prefill for handoff ``api.prefill``) that adopts the client's
  ``traceparent`` header, or the ``trace`` a router rides along in
  ``kv_transfer_params``; ``handoff.claim``, ``session.pull`` and
  ``api.stream_flush`` hang under it, and the engine's phase spans too;
- the chat page: ``GET /`` and ``GET /chat`` answer :func:`webui_html`,
  a streaming chat over ``/v1/chat/completions``.

Built on the stdlib ``ThreadingHTTPServer``. Handler threads submit
requests and read token queues; the engine's own thread does every step.
An embedding forward runs on its handler thread under the engine's lock,
between two steps. The tensor-parallel families (``llm_tp_size``,
``llm_collective_*``) wait for sharded serving (ROADMAP.md queue A item
14).
"""

from __future__ import annotations

import contextlib
import dataclasses
import html
import json
import logging
import sys
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from llm_in_practise_tpu_torch.data.sft import IM_START, render_chatml
from llm_in_practise_tpu_torch.obs.buildinfo import register_build_info
from llm_in_practise_tpu_torch.obs.cost import device_memory_stats
from llm_in_practise_tpu_torch.obs.hbm import (
    get_ledger,
    host_entry_bytes,
    register_hbm_ledger,
)
from llm_in_practise_tpu_torch.obs.meter import HandoffMeter, register_goodput
from llm_in_practise_tpu_torch.obs.registry import Registry
from llm_in_practise_tpu_torch.obs.trace import parse_traceparent
from llm_in_practise_tpu_torch.serve import constrain, schemas
from llm_in_practise_tpu_torch.serve.disagg import (
    new_handoff_id,
    validate_roles,
)
from llm_in_practise_tpu_torch.serve.engine import (
    _FINISH,
    EngineDeadError,
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.http_util import (
    JsonHandler,
    serve_obs_get,
    serve_obs_post,
)
from llm_in_practise_tpu_torch.serve.sessions import session_hid

_log = logging.getLogger(__name__)


def build_prompt(messages) -> str:
    """OpenAI messages -> ChatML generation prompt."""
    rendered = render_chatml(
        [{"role": m.role, "content": m.content} for m in messages])
    return rendered + f"\n{IM_START}assistant\n"


class OpenAIServer:
    """Wires engine + tokenizer + HTTP. ``tokenizer`` needs ``encode``/``decode``.

    ``role`` gates the handoff endpoint (a ``"decode"`` server answers it
    501); ``handoff`` is the store a decode server claims from, by default
    the engine's own. ``tracer`` records the API's spans, by default the
    engine's tracer (one ring per replica)."""

    def __init__(self, engine: InferenceEngine, tokenizer, *,
                 model_name: str = "llm-in-practise-tpu-torch",
                 adapters: dict | None = None, role: str = "both",
                 handoff=None, tracer=None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.tracer = tracer if tracer is not None else engine.tracer
        self.role = validate_roles(role)
        self.handoff = (handoff if handoff is not None
                        else getattr(engine, "handoff", None))
        self.handoff_meter = HandoffMeter()
        # extra model names served by adapters (serve/adapters.py)
        self.adapters = dict(adapters or {})
        self._httpd: ThreadingHTTPServer | None = None
        # structured output: the grammar compile cache (handler threads
        # compile; a repeated schema hits it) and the decoded vocabulary
        # it compiles against
        self.constraints = constrain.ConstraintCompiler()
        self._vocab_lock = threading.Lock()
        self._vocab: list[str] | None = None   # guarded-by: _vocab_lock
        self.vocab_seconds = 0.0
        self._structured_lock = threading.Lock()
        # structured requests by kind (llm_structured_requests_total)
        self.structured_counts = {"json_object": 0, "json_schema": 0,
                                  "tool_call": 0}
        self.registry = self._build_registry()

    # --- structured output ---------------------------------------------------

    def _constraint_vocab(self) -> list[str]:
        """The engine's per-id decoded pieces (made once; the first call
        times it in ``vocab_seconds``)."""
        with self._vocab_lock:
            if self._vocab is None:
                vs = getattr(getattr(self.engine.model, "config", None),
                             "vocab_size", None)
                if vs is None:
                    raise constrain.ConstraintError(
                        "this model exposes no vocab_size; structured "
                        "output is unavailable")
                t0 = time.monotonic()
                self._vocab = constrain.vocab_strings(self.tokenizer,
                                                      int(vs))
                self.vocab_seconds = time.monotonic() - t0
            return self._vocab

    def compile_constraint(self, req: "schemas.ChatCompletionRequest"):
        """The request's shared compiled automaton, or None when it is
        unconstrained. Raises :class:`~.constrain.ConstraintError` on an
        invalid or unsupported spec (HTTP 422)."""
        rf_type = (req.response_format or {}).get("type")
        if (rf_type in (None, "text")
                and req.tool_choice in (None, "auto", "none")):
            # never touch the vocabulary for a plain chat
            return None
        return self.constraints.get(
            response_format=req.response_format, tools=req.tools,
            tool_choice=req.tool_choice, vocab=self._constraint_vocab(),
            vocab_key=id(self.engine), eos_id=self.engine.eos_id)

    @contextlib.contextmanager
    def quiesce_engines(self):
        """Pause every engine this server reaches (``InferenceEngine.
        paused``, once per engine behind its adapter handles): while open
        no step, and so no CUDA graph launch from an engine thread, is in
        flight (``POST /debug/profile`` starts and stops the profiler
        under it)."""
        pausers = {}
        for eng in (self.engine, *self.adapters.values()):
            if hasattr(eng, "paused"):
                pausers.setdefault(id(eng._lock), eng.paused)
        with contextlib.ExitStack() as stack:
            for _, paused in sorted(pausers.items()):
                stack.enter_context(paused())
            yield

    def engine_for(self, model: str | None):
        """The engine (or adapter handle) serving ``model``, or None."""
        if model in (None, "", self.model_name):
            return self.engine
        return self.adapters.get(model)

    # --- request handling ----------------------------------------------------

    def handle_embeddings(self, body: dict, send_json):
        """``POST /v1/embeddings``: the OpenAI embeddings schema over the
        final hidden states, mean-pooled over each input's tokens and
        unit-normalized. 422 on a malformed ``input``, 404 on an unknown
        model."""
        inputs = body.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]

        def ok(x):
            if isinstance(x, str):
                return True
            return (isinstance(x, list)
                    and all(isinstance(t, int) for t in x))

        if not isinstance(inputs, list) or not inputs or not all(
                ok(x) for x in inputs):
            return send_json(422, {"error": {
                "message": "input must be a string, list of strings, or "
                           "list of integer token lists",
                "type": "invalid_request_error"}})
        engine = self.engine_for(body.get("model"))
        if engine is None:
            return send_json(404, {"error": {
                "message": f"model {body.get('model')!r} not found",
                "type": "invalid_request_error"}})
        data, total = [], 0
        for i, item in enumerate(inputs):
            ids = (list(item) if isinstance(item, list)
                   else self.tokenizer.encode(item))
            ids = ids[: engine.cache_len] or [0]
            total += len(ids)
            vec = self.embed_ids(ids, engine)
            norm = float(np.linalg.norm(vec)) or 1.0
            data.append({"object": "embedding", "index": i,
                         "embedding": (vec / norm).tolist()})
        return send_json(200, {
            "object": "list",
            "data": data,
            "model": body.get("model") or self.model_name,
            "usage": {"prompt_tokens": total, "total_tokens": total},
        })

    def embed_ids(self, ids: list[int], engine=None) -> np.ndarray:
        """The mean of the final hidden states over ``ids`` (f64, not
        normalized): one uncached forward of ``engine``'s model (default
        the base engine's) at ``len(ids)`` rows, with no adapter context,
        under the engine's lock so it runs between two steps."""
        engine = engine if engine is not None else self.engine
        x = torch.tensor([ids], dtype=torch.int64, device=engine.device)
        with engine._lock, torch.inference_mode():
            hidden = engine.model(x, return_hidden=True)
            pooled = hidden[0].to(torch.float32).mean(dim=0)
            return pooled.cpu().numpy().astype(np.float64)

    def _session_pull(self, engine, session_id: str | None,
                      span=None) -> None:
        """The fleet miss path (JAX ``api.py:422-448``): a session this
        replica holds nothing for (the router moved it here) claims its
        published entry from the handoff store on this thread (a
        ``session.pull`` span under ``span``) and hands it to the store,
        which admission consumes; a lost entry only means a local prefill,
        counted, never an error."""
        store = getattr(engine, "session_store", None)
        if session_id is None or store is None or store.known(session_id):
            return
        pool = getattr(engine, "handoff", None) or self.handoff
        if pool is None:
            return
        with self.tracer.span("session.pull", parent=span,
                              session=session_id) as ps:
            pulled = pool.claim(session_hid(session_id))
            ps.set(found=pulled is not None)
        if pulled is not None:
            store.adopt(session_id, pulled)
            get_ledger().pulse("handoff_staging", host_entry_bytes(pulled))
        else:
            store.note_lost()

    def handle_prefill(self, body: dict, send_json, trace=None):
        """``POST /internal/handoff/prefill``: the prefill half of a
        disaggregated request. Prefill only, publish the prompt's KV into
        the model's handoff store, and answer the handoff id that a
        router passes to a decode replica in ``kv_transfer_params``.
        ``trace``: the caller's ``traceparent`` context; the
        ``api.prefill`` span joins it."""
        if self.role == "decode":
            return send_json(501, {"error": {
                "message": "decode replicas do not prefill for handoff",
                "type": "unsupported_error"}})
        try:
            req = schemas.ChatCompletionRequest.from_dict(
                dict(body, model=body.get("model") or self.model_name))
        except schemas.ValidationError as e:
            return send_json(422, {"error": {
                "message": str(e), "type": "invalid_request_error"}})
        engine = self.engine_for(req.model)
        if engine is None:
            return send_json(404, {"error": {
                "message": f"model {req.model!r} not found",
                "type": "invalid_request_error"}})
        if getattr(engine, "handoff", None) is None:
            # per model: an engine without a store of its own must not
            # burn a prefill whose publish cannot land
            return send_json(501, {"error": {
                "message": f"model {req.model!r} has no handoff store on "
                           "this replica",
                "type": "unsupported_error"}})
        prompt_ids = self.tokenizer.encode(build_prompt(req.messages))
        hid = new_handoff_id()
        span = self.tracer.start_span("api.prefill", parent=trace,
                                      model=req.model, handoff_id=hid)
        # the span's finish_reason is what the caller saw
        outcome = "error"
        try:
            handle = engine.submit(prompt_ids, SamplingParams(max_tokens=1),
                                   handoff_id=hid, trace=span.context())
            try:
                handle.result()   # a prefill emits no token
            except EngineDeadError:
                outcome = "engine_dead"
                return send_json(503, {"error": {
                    "message": "engine is not running",
                    "type": "internal_error", "code": "engine_dead"}})
            if handle.finish_reason == "too_large":
                outcome = "too_large"
                detail = engine.page_capacity_detail(len(prompt_ids))
                return send_json(422, {"error": {
                    "message": (
                        "prompt can never fit this replica's KV page pool "
                        f"({detail['pages_needed']} pages needed vs "
                        f"{detail['pages_capacity']} capacity)"),
                    "type": "invalid_request_error",
                    "code": "prompt_too_large", "detail": detail}})
            if handle.finish_reason == "queue_full":
                outcome = "queue_full"
                return send_json(429, {"error": {
                    "message": "prefill queue full — retry another replica",
                    "type": "rate_limit_error", "code": "queue_full"}})
            if handle.finish_reason != "handoff":
                outcome = "handoff_failed"
                return send_json(503, {"error": {
                    "message": "KV publish failed (pool unreachable or "
                               "handoff budget exhausted) — serve this "
                               "request undisaggregated",
                    "type": "internal_error", "code": "handoff_failed"}})
            outcome = "handoff"
            return send_json(200, {"handoff_id": hid,
                                   "prompt_tokens": len(handle.prompt_ids),
                                   "model": req.model})
        finally:
            span.end(finish_reason=outcome)

    def handle_chat(self, body: dict, send_json, send_stream,
                    session_id: str | None = None, trace=None):
        try:
            req = schemas.ChatCompletionRequest.from_dict(body)
        except schemas.ValidationError as e:
            return send_json(422, {"error": {
                "message": str(e), "type": "invalid_request_error"}})
        # sessions: the X-Session-ID header (``session_id``) wins; the body
        # field covers clients that cannot set headers. An engine without
        # a store ignores it
        if session_id is None and isinstance(body.get("session_id"), str):
            session_id = body["session_id"]
        engine = self.engine_for(req.model)
        if engine is None:
            return send_json(404, {"error": {
                "message": f"model {req.model!r} not found; have "
                           f"{[self.model_name, *self.adapters]}",
                "type": "invalid_request_error"}})
        prompt_ids = self.tokenizer.encode(build_prompt(req.messages))
        params = SamplingParams(
            temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
            greedy=req.temperature == 0.0, max_tokens=req.max_tokens)
        # structured output: compile the grammar the engine enforces; an
        # invalid or unsupported spec is a client error, before any
        # engine work
        try:
            automaton = self.compile_constraint(req)
        except constrain.ConstraintError as e:
            return send_json(422, {"error": {
                "message": str(e), "type": "invalid_request_error",
                "code": "invalid_constraint"}})
        kind = None
        if automaton is not None:
            kind = automaton.kind
            with self._structured_lock:
                self.structured_counts[kind] += 1
            params = dataclasses.replace(params, constraint=automaton)
        xfer = body.get("kv_transfer_params")
        hid = xfer.get("handoff_id") if isinstance(xfer, dict) else None
        # trace continuity: the traceparent header first; the handoff
        # body's ride-along copy covers a hop whose intermediary strips
        # headers (the prefill -> decode hop stays one trace)
        ctx = trace
        if ctx is None and isinstance(xfer, dict) and xfer.get("trace"):
            ctx = parse_traceparent(str(xfer["trace"]))
        span = self.tracer.start_span(
            "api.chat", parent=ctx, model=req.model or self.model_name,
            stream=bool(req.stream), handed_off=bool(hid))
        try:
            return self._chat(engine, req, prompt_ids, params, kind, hid,
                              session_id, span, send_json, send_stream)
        except BaseException as e:
            # a handler fault answers 500 in do_POST; the span records it
            span.end(status=500, finish_reason="error",
                     error=type(e).__name__)
            raise

    def _chat(self, engine, req, prompt_ids, params, kind, hid, session_id,
              span, send_json, send_stream):
        """The chat after validation, under its ``api.chat`` ``span``,
        which every outcome ends."""
        # disaggregated serving: a router that prefilled this prompt on a
        # prefill replica points at the pinned entry; a lost claim
        # degrades to a local prefill, counted by the engine
        kv_entry = store = None
        if hid:
            # the model's own store (handoff namespaces are per model),
            # else the server's
            store = getattr(engine, "handoff", None) or self.handoff
            with self.tracer.span("handoff.claim", parent=span,
                                  handoff_id=str(hid)) as cs:
                if store is not None:
                    kv_entry = store.claim(str(hid))
                cs.set(found=kv_entry is not None)
            self.handoff_meter.claim_outcome(kv_entry is not None)
            if kv_entry is not None:
                # claim-side staging: the host entry lives only until
                # admission scatters it, shorter than any scrape, so it
                # pulses (peak) instead of booking (level)
                get_ledger().pulse("handoff_staging",
                                   host_entry_bytes(kv_entry))
        self._session_pull(engine, session_id, span)
        handle = engine.submit(prompt_ids, params, kv_entry=kv_entry,
                               session_id=session_id, trace=span.context())
        req_id = schemas.completion_id()

        def queue_full_429(message):
            # one shape for both shed paths (max_queue at submit, and a
            # later queue_timeout shed): a gateway's retry keys on it. A
            # shed request never used its claimed entry (claims are
            # consumed once): re-pin it, so the retry claims it instead of
            # paying the prefill again
            if kv_entry is not None:
                try:
                    store.publish(str(hid), kv_entry)
                except Exception as e:  # noqa: BLE001 — the retry
                    # degrades to a local prefill; say where the entry went
                    self.handoff_meter.note_repin(False)
                    _log.warning("could not re-pin shed handoff entry %s "
                                 "(%s: %s); the retry will re-prefill",
                                 hid, type(e).__name__, e)
                else:
                    self.handoff_meter.note_repin(True)
            span.end(status=429, finish_reason="queue_full")
            return send_json(429, {"error": {
                "message": message + " — retry later or against another "
                                     "replica",
                "type": "rate_limit_error", "code": "queue_full"}})

        # a paged prompt that can never fit the pool is a client error,
        # not load: 422 with the page math, at submit, before any stream
        if handle.finish_reason == "too_large":
            detail = engine.page_capacity_detail(len(prompt_ids))
            span.end(status=422, finish_reason="too_large")
            return send_json(422, {"error": {
                "message": (
                    "prompt can never fit this replica's KV page pool: "
                    f"{detail['pages_needed']} pages needed (prompt "
                    f"{detail['prompt_tokens']} tokens + 1 at page_size "
                    f"{detail['page_size']}) vs {detail['pages_capacity']} "
                    "pages capacity"),
                "type": "invalid_request_error",
                "code": "prompt_too_large",
                "detail": detail}})
        # admission control: a max_queue rejection is synchronous at
        # submit, so it is answered before any stream starts
        if handle.finish_reason == "queue_full":
            return queue_full_429("engine queue full")

        def engine_dead_503():
            span.end(status=503, finish_reason="engine_dead")
            return send_json(503, {"error": {
                "message": "engine is not running; retry against another "
                           "replica",
                "type": "internal_error", "code": "engine_dead"}})

        if req.stream:
            # hold the 200 until the first token (or finish) arrives: a
            # dead engine is then a 503, not an empty stream
            try:
                first = handle.next_item()
            except EngineDeadError:
                return engine_dead_503()
            if first is _FINISH and handle.finish_reason == "queue_full":
                return queue_full_429("request timed out waiting for a slot")
            return send_stream(self._stream_chunks(
                engine, handle, first, req, req_id, span))

        try:
            out_ids = handle.result()
        except EngineDeadError:
            return engine_dead_503()
        if handle.finish_reason == "queue_full":  # queue_timeout shed
            return queue_full_429("request timed out waiting for a slot")
        text = self.tokenizer.decode(out_ids)
        tool_calls = None
        if kind == "tool_call" and handle.finish_reason == "stop":
            # the grammar guarantees {"name": ..., "arguments": {...}}:
            # re-shape it into the OpenAI tool_calls wire format (a call
            # cut by "length" stays raw content)
            try:
                call = json.loads(text)
                tool_calls = [schemas.tool_call_entry(
                    call["name"],
                    json.dumps(call["arguments"], separators=(",", ":")))]
            except (ValueError, KeyError, TypeError):
                tool_calls = None
        span.end(status=200, finish_reason=handle.finish_reason or "stop",
                 completion_tokens=len(out_ids))
        return send_json(200, schemas.chat_completion_response(
            req_id=req_id, model=req.model, text=text,
            finish_reason=handle.finish_reason or "stop",
            usage=schemas.Usage(len(prompt_ids), len(out_ids)),
            tool_calls=tool_calls))

    def _stream_chunks(self, engine, handle, first, req, req_id, span):
        """The SSE events of a streamed chat. The time the consumer spends
        writing each chunk (the yield-to-resume gaps; the engine's decode
        waits inside ``next_item`` are not counted) is the
        ``api.stream_flush`` span and the request's ``stream_flush``
        segment, and ``span`` ends with how the stream ended."""
        flush_s = 0.0
        n_chunks = 0
        try:
            t = time.monotonic()
            yield schemas.chat_completion_chunk(
                req_id=req_id, model=req.model, delta=None)
            flush_s += time.monotonic() - t
            n_chunks += 1
            tokens, prev_text = [], ""
            tok = first
            while tok is not _FINISH:
                tokens.append(tok)
                text = self.tokenizer.decode(tokens)
                delta, prev_text = text[len(prev_text):], text
                if delta:
                    t = time.monotonic()
                    yield schemas.chat_completion_chunk(
                        req_id=req_id, model=req.model, delta=delta)
                    flush_s += time.monotonic() - t
                    n_chunks += 1
                tok = handle.next_item()
            t = time.monotonic()
            yield schemas.chat_completion_chunk(
                req_id=req_id, model=req.model, delta=None,
                finish_reason=handle.finish_reason or "stop")
            flush_s += time.monotonic() - t
            n_chunks += 1
        finally:
            self.tracer.record("api.stream_flush", span, duration_s=flush_s,
                               chunks=n_chunks)
            exc = sys.exc_info()[1]
            # the request's own segment only on a clean end: the stream
            # then saw the finish the engine releases after its last cp
            # write, so this thread owns the dict (swapped, not mutated:
            # /debug/requests may be reading the old one). A disconnect
            # books the aggregate only
            if exc is None:
                handle.cp = {**handle.cp,
                             "stream_flush": handle.cp.get("stream_flush",
                                                           0.0) + flush_s}
            engine.stats.note_stream_flush(flush_s)
            if exc is None:
                span.end(status=200,
                         finish_reason=handle.finish_reason or "stop")
            elif isinstance(exc, GeneratorExit):
                span.end(status=200, finish_reason="client_disconnect",
                         chunks_sent=n_chunks)
            else:
                span.end(status=200, finish_reason="stream_error",
                         error=type(exc).__name__, chunks_sent=n_chunks)

    # --- the scrape plane ----------------------------------------------------

    def _build_registry(self) -> Registry:
        """The ``/metrics`` families (JAX ``OpenAIServer._build_registry``'s
        names, types, labels and help, the subset the port has): each
        reads the live counters of the engine, the meters, the session
        store, the adapter registries or the HBM ledger at scrape time,
        so no count is kept twice."""
        reg = Registry()
        eng = self.engine
        s = eng.stats
        # the build identity: the labels a fleet joins every series on
        register_build_info(reg, {
            "server": "api",
            "model": self.model_name,
            "role": self.role,
            "max_slots": eng.max_slots,
            "cache_len": eng.cache_len,
            "kv_layout": "paged" if eng.paged is not None else "dense",
            "speculative_k": getattr(eng, "speculative_k", 0),
            "decode_steps": getattr(eng, "decode_steps", 1),
            "adapters": sorted(self.adapters),
        })
        reg.counter_func("llm_requests_total",
                         lambda: s.requests_total,
                         "requests submitted to the engine")
        reg.counter_func("llm_tokens_generated_total",
                         lambda: s.tokens_generated_total,
                         "output tokens emitted")
        reg.gauge_func("llm_num_requests_waiting", lambda: s.queue_depth,
                       "requests queued for a slot")
        reg.gauge_func("llm_num_requests_running", lambda: s.active_slots,
                       "requests occupying slots")
        reg.counter_func("llm_requests_shed_total",
                         lambda: s.requests_shed,
                         "requests shed by admission control")
        # dispatch accounting: dispatches per step is the step scheduler's
        # plan (the fused mixed step makes it ~1.0 under mixed load)
        dm = eng.dispatch_meter
        reg.counter_func("llm_dispatches_total", lambda: dm.total,
                         "jitted engine-program launches")
        reg.gauge_func("llm_dispatches_per_step",
                       lambda: dm.mean_per_step,
                       "rolling mean dispatches per engine step")
        reg.counter_func("llm_mixed_blocks_total",
                         lambda: eng.mixed_blocks,
                         "fused prefill+decode dispatches")

        # the device plane: live per-phase MFU / bandwidth use / tokens per
        # dispatch. A phase appears at its first dispatch; without a
        # data-sheet peak (the CPU) the utilization gauges carry no
        # samples, the token gauge still does
        def _phase_gauge(field):
            def read():
                return [({"phase": phase}, snap[field])
                        for phase, snap in dm.phase_snapshot().items()
                        if snap.get(field) is not None]
            return read

        reg.gauge_func("llm_dispatch_mfu", _phase_gauge("mfu"),
                       "rolling per-dispatch model FLOP utilization "
                       "(useful FLOPs / wall time / chip peak)")
        reg.gauge_func("llm_dispatch_hbm_bw_util",
                       _phase_gauge("hbm_bw_util"),
                       "rolling per-dispatch HBM bandwidth utilization "
                       "(weights + KV traffic / wall time / peak BW)")
        reg.gauge_func("llm_dispatch_tokens_per_dispatch",
                       _phase_gauge("tokens_per_dispatch"),
                       "rolling mean tokens processed per dispatch")
        # compile telemetry: the engine's CUDA-graph captures and the
        # kernel builds in the server's life
        cmeter = eng.compile_meter
        reg.counter_func("llm_compile_events_total",
                         lambda: cmeter.compile_events,
                         "jit executable-cache misses paid by the "
                         "serving thread")
        reg.counter_func("llm_compile_seconds_total",
                         lambda: cmeter.compile_seconds,
                         "cumulative seconds stalled in jit "
                         "trace/compile (persistent-cache loads "
                         "included)")

        # the card's allocator, read live; a CPU engine renders the family
        # with no samples (fail open)
        def _hbm():
            stats = device_memory_stats(eng.device)
            return [({"kind": kind}, value)
                    for kind, value in (("in_use",
                                         stats.get("bytes_in_use")),
                                        ("peak",
                                         stats.get("peak_bytes_in_use")),
                                        ("limit",
                                         stats.get("bytes_limit")))
                    if value is not None]

        reg.gauge_func("llm_device_hbm_bytes", _hbm,
                       "device memory from device.memory_stats(): "
                       "bytes in use / peak / limit")
        # the ownership ledger: per-owner attribution of the bytes the
        # family above only totals, and the residual between the two
        register_hbm_ledger(reg)
        # SLO goodput: tokens priced by whether their request met the TTFT
        # / TPOT SLOs; zero until thresholds are configured
        register_goodput(reg, s.goodput)
        # per-role latency labels: a prefill replica's TTFT is KV-ready
        # time, a decode replica's TPOT the interference-free number
        role_labels = {} if self.role == "both" else {"role": self.role}

        def _ttft():
            out = [(role_labels, s.ttft)]
            out.extend(({**role_labels, "cache": k}, acc)
                       for k, acc in sorted(s.ttft_by_cache.items()))
            return out

        reg.histogram_func("llm_ttft_seconds", _ttft,
                           "time to first token (prefill replicas: "
                           "KV-claimable time); cache-labeled children "
                           "split by admission prefix/handoff outcome")
        reg.histogram_func("llm_tpot_seconds",
                           lambda: [(role_labels, s.tpot)],
                           "mean time per output token after the first")
        # the step timeline: where the engine thread's time between
        # dispatches goes, and the device-busy / host-gap dial; every read
        # goes through the recorder's atomically swapped snapshot
        stp = eng.steptrace

        def _host_gap():
            snap = stp.snapshot()
            return [({"activity": a}, v)
                    for a, v in sorted(snap["host_seconds"].items())]

        reg.counter_func("llm_host_gap_seconds_total", _host_gap,
                         "engine-thread seconds between dispatches, by "
                         "host activity (queue_drain/admit/plan/"
                         "index_build/draft_propose/grammar_compile/"
                         "grammar_mask/dispatch_wait/sample_commit/"
                         "publish/other)")
        reg.counter_func(
            "llm_step_wall_seconds_total",
            lambda: stp.snapshot()["step_wall_seconds_total"],
            "cumulative engine step() wall seconds (non-idle steps)")
        reg.counter_func(
            "llm_engine_steps_total",
            lambda: stp.snapshot()["steps"],
            "non-idle engine step() iterations recorded")
        reg.gauge_func(
            "llm_device_busy_fraction",
            lambda: stp.snapshot()["device_busy_fraction"],
            "rolling fraction of step wall time the device was busy "
            "(forced dispatch windows / step wall, last 50 steps)")
        reg.gauge_func(
            "llm_host_gap_fraction",
            lambda: stp.snapshot()["host_gap_fraction"],
            "rolling fraction of step wall time the chip waited on "
            "Python (1 - device_busy; the item-3 overlap target)")
        # every finished request's wall time by critical-path segment
        # (GET /debug/requests has the per-request view)
        reg.counter_func(
            "llm_request_critical_path_seconds_total",
            lambda: [({"segment": seg}, v) for seg, v in
                     sorted(s.critical_path_snapshot().items())],
            "finished requests' wall seconds by critical-path segment")
        # disaggregation: published / claimed say the handoff plane works;
        # lost and local prefills say how often the decode pool prefilled
        # itself
        hm = self.handoff_meter
        reg.counter_func(
            "llm_handoff_total",
            lambda: [({"event": "published"}, eng.handoff_published),
                     ({"event": "publish_failed"},
                      eng.handoff_publish_failed),
                     ({"event": "claimed"}, hm.claimed),
                     ({"event": "kv_admitted"}, eng.kv_admitted),
                     ({"event": "kv_rejected"}, eng.kv_rejected),
                     ({"event": "repinned"}, hm.repinned),
                     ({"event": "repin_failed"}, hm.repin_failed)],
            "disaggregated KV handoff events")
        reg.counter_func("llm_handoff_lost_total", lambda: hm.lost,
                         "handoff ids that resolved to no entry")
        reg.counter_func("llm_local_prefills_total",
                         lambda: eng.local_prefills,
                         "prefills a decode-role replica ran itself")

        # sessions: the store read live, one snapshot per family; the
        # families exist without a store (no samples), so the set is
        # stable
        def _sess(reader):
            def read():
                st = getattr(eng, "session_store", None)
                return [] if st is None else reader(st.counters())
            return read

        reg.gauge_func("llm_sessions_active",
                       _sess(lambda c: [({}, c["active"])]),
                       "conversations with server-held KV pinned on "
                       "this replica")
        reg.gauge_func("llm_session_pinned_pages",
                       _sess(lambda c: [({}, c["pinned_pages"])]),
                       "KV pages refcount-pinned under session handles")
        reg.counter_func(
            "llm_session_turns_total",
            _sess(lambda c: [({"cache": k}, v)
                             for k, v in sorted(c["turns"].items())]),
            "finished session turns by admission cache outcome "
            "(hit / partial / cold)")
        reg.counter_func(
            "llm_session_evictions_total",
            _sess(lambda c: [({"reason": k}, v)
                             for k, v in sorted(c["evictions"].items())]),
            "session pin evictions (ttl / pressure / capacity)")
        reg.counter_func(
            "llm_session_pulls_total",
            _sess(lambda c: [({"event": k}, v)
                             for k, v in sorted(c["pulls"].items())]),
            "fleet warm-path events (published / publish_failed / "
            "claimed / lost)")

        # the prefix cache, read live (no cache: no samples)
        def _pc(attr):
            def read():
                pc = eng.prefix_cache
                return [] if pc is None else [({}, getattr(pc, attr))]
            return read

        reg.counter_func("llm_prefix_cache_hits_total", _pc("hits"))
        reg.counter_func("llm_prefix_cache_full_hits_total",
                         _pc("full_hits"))
        reg.counter_func("llm_prefix_cache_misses_total", _pc("misses"))
        reg.counter_func("llm_prefix_cache_tokens_saved_total",
                         _pc("tokens_saved"))
        reg.gauge_func("llm_prefix_cache_tokens", _pc("cached_tokens"))
        if eng.paged is not None:
            # the paged plane: free pages are admittable tokens, shared
            # pages are prefix reuse, preemptions an undersized pool
            pool = eng.paged.pool

            def _pages():
                free = pool.free_pages
                return [({"state": "free"}, free),
                        ({"state": "used"}, pool.capacity - free),
                        ({"state": "shared"}, pool.shared_pages)]

            reg.gauge_func("llm_kv_pages", _pages,
                           "page-pool occupancy by state (shared = "
                           "refcount > 1, also counted in used)")
            reg.gauge_func("llm_kv_pages_total", lambda: pool.capacity,
                           "allocatable pages in the pool")
            reg.gauge_func("llm_kv_page_size",
                           lambda: pool.page_size,
                           "tokens per KV page")
            reg.gauge_func(
                "llm_kv_page_fragmentation",
                lambda: [({}, eng.debug_kv().get("fragmentation", 0.0))],
                "allocated-but-unfilled token slack of slot-mapped "
                "pages (contiguous layouts waste cache_len - context "
                "per slot; paged keeps this under one page)")
            reg.counter_func("llm_kv_preemptions_total",
                             lambda: eng.preemptions,
                             "slots preempted (recompute-resume) under "
                             "page-pool pressure")
            reg.counter_func("llm_kv_rejected_too_large_total",
                             lambda: eng.rejected_too_large,
                             "prompts refused at submit: pages needed "
                             "exceed pool capacity (HTTP 422)")
        if eng.speculative_k is not None:
            reg.counter_func("llm_spec_proposed_total",
                             lambda: eng.spec_proposed,
                             "drafted tokens submitted to verify")
            reg.counter_func("llm_spec_accepted_total",
                             lambda: eng.spec_accepted,
                             "drafted tokens the verify accepted")
            reg.counter_func("llm_spec_rounds_total",
                             lambda: eng.spec_rounds,
                             "fused spec-verify dispatches issued")
            reg.counter_func("llm_spec_round_tokens_total",
                             lambda: eng.spec_round_tokens,
                             "tokens committed by spec dispatches "
                             "(accepted + bonus + block extension)")

            def _acceptance():
                proposed = eng.spec_proposed     # one read each: a torn
                accepted = eng.spec_accepted     # pair stays <= 1.0
                if proposed <= 0:
                    return []
                return [({}, min(accepted / proposed, 1.0))]

            reg.gauge_func("llm_spec_acceptance_rate", _acceptance,
                           "lifetime accepted/proposed drafted tokens "
                           "(no samples until the first draft)")
        if eng.decode_steps > 1:
            reg.counter_func("llm_multi_decode_blocks_total",
                             lambda: eng.multi_blocks)

        def _structured():
            with self._structured_lock:
                return [({"kind": k}, v)
                        for k, v in sorted(self.structured_counts.items())]

        reg.counter_func(
            "llm_structured_requests_total", _structured,
            "requests that carried a grammar constraint, by kind "
            "(json_object / json_schema / tool_call)")
        reg.counter_func(
            "llm_grammar_mask_seconds_total",
            lambda: eng.grammar_mask_seconds_total,
            "engine-thread seconds staging grammar logit masks "
            "(includes lazy automaton-state compiles; the steptrace "
            "grammar_compile/grammar_mask activities split the two)")
        reg.counter_func(
            "llm_spec_grammar_rejects_total",
            lambda: eng.spec_grammar_rejects,
            "drafted tokens rejected by the grammar during fused "
            "spec-round mask staging (the on-device acceptance "
            "cumprod truncates at each)")

        # multi-LoRA: the base engine's registry and any distinct one
        # behind the adapters= handles, read live (none: no samples)
        def _adapter_regs():
            seen = {}
            for e in (eng, *self.adapters.values()):
                r = getattr(e, "adapter_registry", None)
                if r is not None:
                    seen[id(r)] = r
            return list(seen.values())

        def _adapter_sum(key):
            def read():
                regs = _adapter_regs()
                if not regs:
                    return []
                return [({}, sum(r.stats()[key] for r in regs))]
            return read

        reg.gauge_func("llm_adapters_loaded", _adapter_sum("loaded"),
                       "LoRA adapters resident in the registry banks")
        reg.gauge_func("llm_adapter_bytes", _adapter_sum("bytes_loaded"),
                       "HBM bytes held by loaded adapter factor rows "
                       "(f32 payload at the padded bucket rank)")
        reg.counter_func("llm_adapter_swap_seconds_total",
                         _adapter_sum("swap_seconds_total"),
                         "cumulative seconds spent hot-loading adapter "
                         "checkpoints into the banks")
        reg.counter_func("llm_adapter_evictions_total",
                         _adapter_sum("evictions_total"),
                         "adapter rows evicted under the registry byte "
                         "budget (refcount-0 LRU only)")

        def _tenant_tokens():
            out: dict[str, int] = {}
            for r in _adapter_regs():
                for name, n in r.stats()["tenant_tokens"].items():
                    out[name] = out.get(name, 0) + n
            return [({"adapter": name}, n)
                    for name, n in sorted(out.items())]

        reg.counter_func("llm_tenant_tokens_total", _tenant_tokens,
                         "output tokens generated per adapter tenant "
                         "(finished requests; base-model traffic is "
                         "not labeled)")
        return reg

    def metrics_text(self) -> str:
        return self.registry.render()

    # --- HTTP plumbing -------------------------------------------------------

    def make_handler(self):
        server = self

        class Handler(JsonHandler):
            def _sse(self, events):
                self._responded = True
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    try:
                        for event in events:
                            self.wfile.write(
                                f"data: {json.dumps(event)}\n\n".encode())
                            self.wfile.flush()
                    except Exception as e:  # noqa: BLE001 — headers are out:
                        # report the fault in band, then close with DONE
                        err = {"error": {"message": f"{type(e).__name__}: {e}",
                                         "type": "internal_error"}}
                        self.wfile.write(f"data: {json.dumps(err)}\n\n".encode())
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-stream

            def do_GET(self):
                if serve_obs_get(self, server.metrics_text, server.tracer):
                    return None
                try:
                    if self.path == "/debug/kv":
                        return self._json(200, server.engine.debug_kv())
                    if self.path == "/debug/requests":
                        return self._json(200,
                                          server.engine.debug_requests())
                    if self.path == "/debug/sessions":
                        return self._json(200,
                                          server.engine.debug_sessions())
                    if self.path == "/debug/hbm":
                        return self._json(200, get_ledger().debug_tree())
                    if self.path == "/v1/models":
                        return self._json(200, {
                            "object": "list",
                            "data": [{"id": name, "object": "model",
                                      "owned_by":
                                          "llm-in-practise-tpu-torch"}
                                     for name in (server.model_name,
                                                  *server.adapters)],
                        })
                    if self.path in ("/", "/chat"):
                        return self._text(
                            200, webui_html(server.model_name).encode(),
                            "text/html; charset=utf-8")
                except Exception as e:  # noqa: BLE001 — a GET fault must
                    # answer the client, not drop the connection
                    return self._json(500, {"error": {
                        "message": f"{type(e).__name__}: {e}",
                        "type": "internal_error"}})
                return self._json(404, {"error": {"message": "not found"}})

            def do_POST(self):
                if self.path not in ("/v1/chat/completions",
                                     "/v1/embeddings",
                                     "/internal/handoff/prefill",
                                     "/debug/profile"):
                    return self._json(404, {"error": {"message": "not found"}})
                body, err = self._read_json()
                if err:
                    return self._json(400, err)
                if serve_obs_post(self, body, server.quiesce_engines):
                    return None
                # a client's (or router's) traceparent: the spans minted
                # here join its trace
                ctx = parse_traceparent(self.headers.get("traceparent"))
                try:
                    if self.path == "/v1/embeddings":
                        return server.handle_embeddings(body, self._json)
                    if self.path == "/internal/handoff/prefill":
                        return server.handle_prefill(body, self._json,
                                                     trace=ctx)
                    # the conversation handle rides the header (router or
                    # client) or the body; the header wins
                    return server.handle_chat(
                        body, self._json, self._sse,
                        session_id=self.headers.get("X-Session-ID"),
                        trace=ctx)
                except Exception as e:  # noqa: BLE001 — a handler fault must
                    # still answer the client unless a response already went
                    if self._responded:
                        return None
                    return self._json(500, {"error": {
                        "message": f"{type(e).__name__}: {e}",
                        "type": "internal_error"}})

        return Handler

    def serve(self, host: str = "0.0.0.0", port: int = 8000, *,
              background: bool = False) -> int:
        """Start the engine loop and the HTTP server; returns the bound
        port (``port=0`` picks a free one)."""
        for eng in (self.engine, *self.adapters.values()):
            if eng._thread is None:
                eng.start()

        class _Server(ThreadingHTTPServer):
            request_queue_size = 1024
            daemon_threads = True

        self._httpd = _Server((host, port), self.make_handler())
        bound = self._httpd.server_address[1]
        if background:
            threading.Thread(target=self._httpd.serve_forever,
                             daemon=True).start()
        else:
            self._httpd.serve_forever()
        return bound

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.engine.stop()
        for eng in self.adapters.values():
            eng.stop()


def webui_html(model_name: str) -> str:
    """Minimal streaming chat page — the reference's Gradio web UIs
    (``Scripts/inference/05-…-webui-infr.py``, streaming ``06-…:52-75``)
    without the Gradio dependency: vanilla HTML + fetch over the SSE
    endpoint, incremental delta rendering, multi-turn history."""
    name_html = html.escape(model_name)
    name_js = json.dumps(model_name)  # JS string literal, quotes included
    return """<!doctype html>
<meta charset="utf-8"><title>chat — """ + name_html + """</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:720px;margin:2rem auto;padding:0 1rem}
 #log{border:1px solid #ccc;border-radius:8px;padding:1rem;min-height:300px;
      white-space:pre-wrap}
 .u{color:#036;font-weight:600}.a{color:#222}
 form{display:flex;gap:.5rem;margin-top:1rem}
 input{flex:1;padding:.5rem;font-size:1rem}
 button{padding:.5rem 1rem}
</style>
<h2>""" + name_html + """</h2>
<div id=log></div>
<form id=f><input id=q autocomplete=off placeholder="message…">
<button>send</button></form>
<script>
const log=document.getElementById('log'),f=document.getElementById('f'),
      q=document.getElementById('q'),history=[];
f.onsubmit=async e=>{
  e.preventDefault();
  const text=q.value.trim(); if(!text)return; q.value='';
  history.push({role:'user',content:text});
  log.append(Object.assign(document.createElement('div'),
    {className:'u',textContent:'you: '+text}));
  const out=Object.assign(document.createElement('div'),
    {className:'a',textContent:'bot: '});
  log.append(out);
  const r=await fetch('/v1/chat/completions',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({model:""" + name_js + """,messages:history,
                         stream:true,max_tokens:256})});
  const reader=r.body.getReader(),dec=new TextDecoder();
  let buf='',answer='';
  for(;;){
    const {done,value}=await reader.read(); if(done)break;
    buf+=dec.decode(value,{stream:true});
    let i;
    while((i=buf.indexOf('\\n\\n'))>=0){
      const line=buf.slice(0,i).trim(); buf=buf.slice(i+2);
      if(!line.startsWith('data:'))continue;
      const data=line.slice(5).trim();
      if(data==='[DONE]')continue;
      const delta=JSON.parse(data).choices?.[0]?.delta?.content;
      if(delta){answer+=delta;out.textContent='bot: '+answer;}
    }
  }
  history.push({role:'assistant',content:answer});
};
</script>"""
