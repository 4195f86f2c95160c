"""Stdlib HTTP plumbing (port of ``llm_in_practise_tpu/serve/http_util.py``):
the JSON handler base of the OpenAI server and the kv-pool's metrics
sidecar, and the ``/health`` + ``/metrics`` pair both serve."""

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


def serve_obs_get(handler: JsonHandler, metrics_text) -> bool:
    """Serve ``/health`` and ``/metrics`` (Prometheus text exposition);
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
    return False
