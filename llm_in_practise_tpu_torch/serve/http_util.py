"""Stdlib HTTP plumbing (port of ``llm_in_practise_tpu/serve/http_util.py``)."""

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

    def _read_json(self):
        """Parse the request body; returns (dict, None) or (None, error)."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}"), None
        except (ValueError, json.JSONDecodeError):
            return None, {"error": {"message": "invalid JSON body"}}
