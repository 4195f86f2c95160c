"""OpenAI-compatible HTTP server over the continuous-batching engine.

Port of the chat part of ``llm_in_practise_tpu/serve/api.py``:

- ``POST /v1/chat/completions``, non-streaming and SSE streaming
  (``data:`` chunks, then ``data: [DONE]``);
- the ChatML generation prompt built from the OpenAI messages;
- usage accounting, ``GET /v1/models``, ``GET /health``.

Built on the stdlib ``ThreadingHTTPServer``. Handler threads only submit
requests and read token queues; the engine's own thread does every device
operation. ``/metrics``, ``/v1/embeddings``, the debug routes and the
disaggregation handoff are not ported yet (ROADMAP.md queue A items 5-6).
"""

from __future__ import annotations

import json
import threading
from http.server import ThreadingHTTPServer

from llm_in_practise_tpu_torch.data.sft import IM_START, render_chatml
from llm_in_practise_tpu_torch.serve import schemas
from llm_in_practise_tpu_torch.serve.engine import (
    _FINISH,
    EngineDeadError,
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.http_util import JsonHandler


def build_prompt(messages) -> str:
    """OpenAI messages -> ChatML generation prompt."""
    rendered = render_chatml(
        [{"role": m.role, "content": m.content} for m in messages])
    return rendered + f"\n{IM_START}assistant\n"


class OpenAIServer:
    """Wires engine + tokenizer + HTTP. ``tokenizer`` needs ``encode``/``decode``."""

    def __init__(self, engine: InferenceEngine, tokenizer, *,
                 model_name: str = "llm-in-practise-tpu-torch"):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self._httpd: ThreadingHTTPServer | None = None

    def handle_chat(self, body: dict, send_json, send_stream):
        try:
            req = schemas.ChatCompletionRequest.from_dict(body)
        except schemas.UnsupportedFieldError as e:
            return send_json(400, {"error": {
                "message": str(e), "type": "invalid_request_error",
                "code": "unsupported_field"}})
        except schemas.ValidationError as e:
            return send_json(422, {"error": {
                "message": str(e), "type": "invalid_request_error"}})
        if req.model not in ("", self.model_name):
            return send_json(404, {"error": {
                "message": f"model {req.model!r} not found; have "
                           f"{[self.model_name]}",
                "type": "invalid_request_error"}})
        prompt_ids = self.tokenizer.encode(build_prompt(req.messages))
        params = SamplingParams(
            temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
            greedy=req.temperature == 0.0, max_tokens=req.max_tokens)
        handle = self.engine.submit(prompt_ids, params)
        req_id = schemas.completion_id()

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
        text = self.tokenizer.decode(out_ids)
        return send_json(200, schemas.chat_completion_response(
            req_id=req_id, model=req.model, text=text,
            finish_reason=handle.finish_reason or "stop",
            usage=schemas.Usage(len(prompt_ids), len(out_ids))))

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
                if self.path == "/v1/models":
                    return self._json(200, {
                        "object": "list",
                        "data": [{"id": server.model_name, "object": "model",
                                  "owned_by": "llm-in-practise-tpu-torch"}],
                    })
                return self._json(404, {"error": {"message": "not found"}})

            def do_POST(self):
                if self.path != "/v1/chat/completions":
                    return self._json(404, {"error": {"message": "not found"}})
                body, err = self._read_json()
                if err:
                    return self._json(400, err)
                try:
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
        if self.engine._thread is None:
            self.engine.start()

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
