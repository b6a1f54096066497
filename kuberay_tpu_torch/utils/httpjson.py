"""JSON-over-HTTP handler plumbing for the port's servers (a copy of
``kuberay_tpu/utils/httpjson.py``)."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Tuple


class JsonHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # quiet by default
        pass

    def _send(self, code: int, body: Any = None,
              headers: Dict[str, str] = None):
        data = (json.dumps(body).encode() if body is not None else b"")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> Dict[str, Any]:
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b"{}"
        return json.loads(raw or b"{}")


def serve_background(srv, name: str = "http-server") -> Tuple[object, str]:
    """Run an HTTPServer in a daemon thread; returns (server, base_url)."""
    threading.Thread(target=srv.serve_forever, daemon=True, name=name).start()
    return srv, f"http://{srv.server_address[0]}:{srv.server_address[1]}"
