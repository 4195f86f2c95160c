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

Built on the stdlib ``ThreadingHTTPServer``. Handler threads submit
requests and read token queues; the engine's own thread does every step.
An embedding forward runs on its handler thread under the engine's lock,
between two steps. ``/metrics``, the other debug routes and the session
pull are not ported yet (ROADMAP.md queue A items 5-6).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from llm_in_practise_tpu_torch.data.sft import IM_START, render_chatml
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
from llm_in_practise_tpu_torch.serve.http_util import JsonHandler

_log = logging.getLogger(__name__)


def build_prompt(messages) -> str:
    """OpenAI messages -> ChatML generation prompt."""
    rendered = render_chatml(
        [{"role": m.role, "content": m.content} for m in messages])
    return rendered + f"\n{IM_START}assistant\n"


class HandoffMeter:
    """Claim-side accounting of the disaggregated handoff, in a decode
    replica's API layer, where handoff ids arrive and resolve to a pinned
    entry or turn out lost (JAX ``obs/meter.py::HandoffMeter``; its
    ``/metrics`` rendering is ROADMAP.md queue A item 6). Handler threads
    increment concurrently, so the increments hold a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.claimed = 0        # guarded-by: _lock — ids that resolved
        self.lost = 0           # guarded-by: _lock — nothing: re-prefill
        self.repinned = 0       # guarded-by: _lock — re-published sheds
        self.repin_failed = 0   # guarded-by: _lock — re-pins that failed

    def claim_outcome(self, entry_found: bool) -> None:
        with self._lock:
            if entry_found:
                self.claimed += 1
            else:
                self.lost += 1

    def note_repin(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self.repinned += 1
            else:
                self.repin_failed += 1


class OpenAIServer:
    """Wires engine + tokenizer + HTTP. ``tokenizer`` needs ``encode``/``decode``.

    ``role`` gates the handoff endpoint (a ``"decode"`` server answers it
    501); ``handoff`` is the store a decode server claims from, by default
    the engine's own."""

    def __init__(self, engine: InferenceEngine, tokenizer, *,
                 model_name: str = "llm-in-practise-tpu-torch",
                 adapters: dict | None = None, role: str = "both",
                 handoff=None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
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

    def handle_prefill(self, body: dict, send_json):
        """``POST /internal/handoff/prefill``: the prefill half of a
        disaggregated request. Prefill only, publish the prompt's KV into
        the model's handoff store, and answer the handoff id that a
        router passes to a decode replica in ``kv_transfer_params``."""
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
        handle = engine.submit(prompt_ids, SamplingParams(max_tokens=1),
                               handoff_id=hid)
        try:
            handle.result()   # a prefill emits no token
        except EngineDeadError:
            return send_json(503, {"error": {
                "message": "engine is not running", "type": "internal_error",
                "code": "engine_dead"}})
        if handle.finish_reason == "too_large":
            detail = engine.page_capacity_detail(len(prompt_ids))
            return send_json(422, {"error": {
                "message": (
                    "prompt can never fit this replica's KV page pool "
                    f"({detail['pages_needed']} pages needed vs "
                    f"{detail['pages_capacity']} capacity)"),
                "type": "invalid_request_error", "code": "prompt_too_large",
                "detail": detail}})
        if handle.finish_reason == "queue_full":
            return send_json(429, {"error": {
                "message": "prefill queue full — retry another replica",
                "type": "rate_limit_error", "code": "queue_full"}})
        if handle.finish_reason != "handoff":
            return send_json(503, {"error": {
                "message": "KV publish failed (pool unreachable or handoff "
                           "budget exhausted) — serve this request "
                           "undisaggregated",
                "type": "internal_error", "code": "handoff_failed"}})
        return send_json(200, {"handoff_id": hid,
                               "prompt_tokens": len(handle.prompt_ids),
                               "model": req.model})

    def handle_chat(self, body: dict, send_json, send_stream):
        try:
            req = schemas.ChatCompletionRequest.from_dict(body)
        except schemas.ValidationError as e:
            return send_json(422, {"error": {
                "message": str(e), "type": "invalid_request_error"}})
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
        # disaggregated serving: a router that prefilled this prompt on a
        # prefill replica points at the pinned entry; a lost claim
        # degrades to a local prefill, counted by the engine
        kv_entry = store = None
        xfer = body.get("kv_transfer_params")
        hid = xfer.get("handoff_id") if isinstance(xfer, dict) else None
        if hid:
            # the model's own store (handoff namespaces are per model),
            # else the server's
            store = getattr(engine, "handoff", None) or self.handoff
            if store is not None:
                kv_entry = store.claim(str(hid))
            self.handoff_meter.claim_outcome(kv_entry is not None)
        handle = engine.submit(prompt_ids, params, kv_entry=kv_entry)
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
            return send_json(429, {"error": {
                "message": message + " — retry later or against another "
                                     "replica",
                "type": "rate_limit_error", "code": "queue_full"}})

        # a paged prompt that can never fit the pool is a client error,
        # not load: 422 with the page math, at submit, before any stream
        if handle.finish_reason == "too_large":
            detail = engine.page_capacity_detail(len(prompt_ids))
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

            def chunks():
                yield schemas.chat_completion_chunk(
                    req_id=req_id, model=req.model, delta=None)
                tokens, prev_text = [], ""
                tok = first
                while tok is not _FINISH:
                    tokens.append(tok)
                    text = self.tokenizer.decode(tokens)
                    delta, prev_text = text[len(prev_text):], text
                    if delta:
                        yield schemas.chat_completion_chunk(
                            req_id=req_id, model=req.model, delta=delta)
                    tok = handle.next_item()
                yield schemas.chat_completion_chunk(
                    req_id=req_id, model=req.model, delta=None,
                    finish_reason=handle.finish_reason or "stop")

            return send_stream(chunks())

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
        return send_json(200, schemas.chat_completion_response(
            req_id=req_id, model=req.model, text=text,
            finish_reason=handle.finish_reason or "stop",
            usage=schemas.Usage(len(prompt_ids), len(out_ids)),
            tool_calls=tool_calls))

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
                if self.path == "/health":
                    return self._json(200, {"status": "ok"})
                if self.path == "/debug/kv":
                    return self._json(200, server.engine.debug_kv())
                if self.path == "/v1/models":
                    return self._json(200, {
                        "object": "list",
                        "data": [{"id": name, "object": "model",
                                  "owned_by": "llm-in-practise-tpu-torch"}
                                 for name in (server.model_name,
                                              *server.adapters)],
                    })
                return self._json(404, {"error": {"message": "not found"}})

            def do_POST(self):
                if self.path not in ("/v1/chat/completions",
                                     "/v1/embeddings",
                                     "/internal/handoff/prefill"):
                    return self._json(404, {"error": {"message": "not found"}})
                body, err = self._read_json()
                if err:
                    return self._json(400, err)
                try:
                    if self.path == "/v1/embeddings":
                        return server.handle_embeddings(body, self._json)
                    if self.path == "/internal/handoff/prefill":
                        return server.handle_prefill(body, self._json)
                    return server.handle_chat(body, self._json, self._sse)
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
