"""Coordinator client: what a training or serving pod says to the head.

A copy of the part of ``kuberay_tpu/runtime/coordinator_client.py`` that
the pods use, with the same paths and bodies on the wire: structured
events (the launcher's step heartbeats, which the operator's straggler
view reads), the serve app's status (RUNNING / STOPPED, which the
TpuService controller reads) and the submitted serve config
(``--config-from-coordinator``).
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from kuberay_tpu_torch.utils import constants as C


def dashboard_url(coordinator_address: str) -> str:
    """host[:port] coordinator address -> the HTTP API base URL (the job
    API listens on the dashboard port)."""
    host = coordinator_address.split(":")[0]
    return f"http://{host}:{C.PORT_DASHBOARD}"


class CoordinatorError(Exception):
    """``code`` carries the HTTP status when the server answered and None
    when the request never completed (connect refused, timeout)."""

    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        self.code = code


class CoordinatorClient:
    """HTTP client for the coordinator API (dashboard port).

    ``auth_token`` (default: the TPU_AUTH_TOKEN env the operator injects)
    is sent as a Bearer header when set."""

    def __init__(self, base_url: str, timeout: float = 5.0,
                 auth_token: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.auth_token = (auth_token if auth_token is not None
                           else os.environ.get("TPU_AUTH_TOKEN", ""))

    def _req(self, method: str, path: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        req = urllib.request.Request(
            f"{self.base_url}{path}", data=data, method=method,
            headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            raise CoordinatorError(f"{method} {path}: HTTP {e.code}",
                                   code=e.code) from e
        except Exception as e:
            raise CoordinatorError(f"{method} {path}: {e}") from e

    def set_serve_app_status(self, name: str, status: str,
                             message: str = "") -> None:
        self._req("PUT", f"/api/serve/applications/{name}/status",
                  {"status": status, "message": message})

    def get_serve_apps(self) -> Dict[str, Any]:
        return self._req("GET", "/api/serve/applications/")

    def get_serve_config(self) -> Dict[str, Any]:
        """The submitted serve config (the TpuService controller's PUT)."""
        return self._req("GET", "/api/serve/config")

    def post_events(self, events: List[Dict[str, Any]]) -> int:
        return self._req("POST", "/api/events",
                         {"events": events}).get("recorded", 0)
