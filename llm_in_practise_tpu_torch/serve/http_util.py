"""Stdlib HTTP plumbing (port of ``llm_in_practise_tpu/serve/http_util.py``):
the JSON handler base of the OpenAI server and the kv-pool's metrics
sidecar, and the observability routes both serve: ``GET /health``,
``GET /metrics``, ``GET /debug/traces`` (the tracer's ring) and ``POST
/debug/profile`` (a bounded ``torch.profiler`` capture, 409 while another
runs)."""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler


class JsonHandler(BaseHTTPRequestHandler):
    """Base handler: JSON responses, body parsing, quiet logging."""

    protocol_version = "HTTP/1.1"
    _responded = False

    def log_message(self, *args):  # quiet
        pass

    def _json(self, status: int, payload: dict):
        self._responded = True
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, status: int, body: bytes, content_type: str):
        self._responded = True
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self):
        """Parse the request body; returns (dict, None) or (None, error)."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}"), None
        except (ValueError, json.JSONDecodeError):
            return None, {"error": {"message": "invalid JSON body"}}


def serve_obs_get(handler: JsonHandler, metrics_text, tracer=None) -> bool:
    """Serve ``/health``, ``/metrics`` (Prometheus text exposition) and
    ``/debug/traces`` (``tracer``'s ring, by default the process tracer);
    returns True when the path was handled. ``metrics_text`` is a zero-arg
    callable. A scrape callback that raises answers a 500 JSON body
    instead of unwinding into socketserver (which would drop the
    connection)."""
    if handler.path == "/health":
        handler._json(200, {"status": "ok"})
        return True
    if handler.path == "/metrics":
        try:
            body = metrics_text().encode()
        except Exception as e:  # noqa: BLE001 — a broken scrape callback
            # must answer the scraper, never kill the handler thread
            handler._json(500, {"error": {
                "message": f"metrics render failed: "
                           f"{type(e).__name__}: {e}",
                "type": "internal_error"}})
            return True
        handler._text(200, body, "text/plain; version=0.0.4")
        return True
    if handler.path == "/debug/traces":
        try:
            if tracer is None:
                from llm_in_practise_tpu_torch.obs.trace import get_tracer

                tracer = get_tracer()
            payload = tracer.debug_payload()
        except Exception as e:  # noqa: BLE001 — same contract as /metrics
            handler._json(500, {"error": {
                "message": f"trace snapshot failed: "
                           f"{type(e).__name__}: {e}",
                "type": "internal_error"}})
            return True
        handler._json(200, payload)
        return True
    return False


def obs_profile_response(body: dict | None,
                         quiesce=None) -> tuple[int, dict]:
    """Handle a ``POST /debug/profile`` body: ``(status, payload)``.

    Body: ``{"duration_s": <float, default 2, clamped to the capture's
    bound>}``. One capture at a time per process: a concurrent request
    gets a 409. The success payload names the capture directory and the
    gzipped Chrome trace (see :mod:`~..obs.prof`); failures are contained
    to this response (a broken profiler must never take a server
    down). ``quiesce``: as :meth:`~..obs.prof.ProfilerCapture.capture`
    takes it."""
    from llm_in_practise_tpu_torch.obs.prof import (
        ProfilerBusyError,
        get_profiler,
    )

    body = body or {}
    if not isinstance(body, dict):
        return 422, {"error": {"message": "body must be a JSON object",
                               "type": "invalid_request_error"}}
    try:
        duration = float(body.get("duration_s", 2.0))
    except (TypeError, ValueError):
        return 422, {"error": {"message": "duration_s must be a number",
                               "type": "invalid_request_error"}}
    try:
        result = get_profiler().capture(duration, quiesce)
    except ProfilerBusyError as e:
        return 409, {"error": {"message": str(e),
                               "type": "conflict_error",
                               "code": "profile_busy"}}
    except Exception as e:  # noqa: BLE001 — a profiler fault (full disk)
        # answers the caller, never crashes the server
        return 500, {"error": {"message": f"{type(e).__name__}: {e}",
                               "type": "internal_error",
                               "code": "profile_failed"}}
    return 200, result


def serve_obs_post(handler: JsonHandler, body: dict | None,
                   quiesce=None) -> bool:
    """Serve ``POST /debug/profile``; returns True when the path was
    handled."""
    if handler.path != "/debug/profile":
        return False
    status, payload = obs_profile_response(body, quiesce)
    handler._json(status, payload)
    return True
