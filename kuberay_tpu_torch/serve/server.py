"""Inference HTTP server for the PyTorch engine.

Port of the core of ``kuberay_tpu/serve/server.py``: a background thread
drains the continuous batcher; HTTP handlers enqueue requests and wait on
per-request events.  Same wire format as the JAX server:

    POST /v1/completions   {"prompt_tokens": [...], "max_tokens": N,
                            "temperature": T, "top_p": P, "top_k": K,
                            "eos_token": E, "stop_token_ids": [...]}
                           -> {"id", "tokens", "finish_reason",
                               "prompt_len", "ttft_ms"}
                           with X-TPU-Queue-Depth / X-TPU-Active-Slots
    GET  /healthz | /stats

Streaming, the KV-block endpoints, coordinator registration and
multi-host serving are not ported yet.

Run:  python -m kuberay_tpu_torch.serve.server --model llama3_8b
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
import uuid
from http.server import ThreadingHTTPServer
from typing import Any, Dict, Optional

from kuberay_tpu_torch.serve.engine import Request, Response, ServeEngine
from kuberay_tpu_torch.utils import constants as C
from kuberay_tpu_torch.utils.httpjson import JsonHandler, serve_background


class ServeFrontend:
    def __init__(self, engine: ServeEngine, max_queue: int = 256):
        self.engine = engine
        self.max_queue = max_queue
        self._degraded: Optional[str] = None
        self._lock = threading.Lock()
        self._waiters: Dict[str, threading.Event] = {}
        self._results: Dict[str, Response] = {}
        self._stop = threading.Event()
        self._stats = {"requests": 0, "completed": 0, "rejected": 0,
                       "tokens_out": 0, "failed_degraded": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-engine-loop")
        self._thread.start()

    @property
    def degraded(self) -> Optional[str]:
        with self._lock:
            return self._degraded

    def _handle_degraded(self, reason: str) -> None:
        """One-way: stop admitting and fail every pending waiter (an
        immediate 503 beats a client-timeout hang)."""
        with self._lock:
            if self._degraded is not None:
                return
            self._degraded = reason
            waiters = list(self._waiters.values())
            self._waiters.clear()
            self._stats["failed_degraded"] += len(waiters)
        for ev in waiters:
            ev.set()                       # submit() sees no result -> None

    def _loop(self):
        while not self._stop.is_set():
            if self.degraded is not None:
                self._stop.wait(0.1)
                continue
            if not self.engine.has_work():
                self._stop.wait(0.005)
                continue
            try:
                responses = self.engine.step()
            except Exception as e:
                # The loop must keep answering: report the failure on
                # stderr, /healthz and /stats, and fail the waiters.
                traceback.print_exc(file=sys.stderr)
                self._handle_degraded(f"engine step failed: {e!r}")
                continue
            for resp in responses:
                with self._lock:
                    self._stats["completed"] += 1
                    self._stats["tokens_out"] += len(resp.tokens)
                    ev = self._waiters.pop(resp.request_id, None)
                    if ev is not None:
                        # Only park results someone still waits for.
                        self._results[resp.request_id] = resp
                if ev is not None:
                    ev.set()

    def submit(self, prompt_tokens, max_tokens=64, temperature=0.0,
               eos_token=None, timeout: float = 300.0, top_p: float = 1.0,
               top_k: int = 0, stop_token_ids=None) -> Optional[Response]:
        """Enqueue one request and wait for it; None when overloaded,
        degraded or timed out."""
        rid = uuid.uuid4().hex
        ev = threading.Event()
        with self._lock:
            if self._degraded is not None or \
                    len(self.engine.queue) >= self.max_queue:
                self._stats["rejected"] += 1
                return None
            self._stats["requests"] += 1
            self._waiters[rid] = ev
            self.engine.add_request(Request(
                rid, list(prompt_tokens), max_new_tokens=max_tokens,
                temperature=temperature, top_p=top_p, top_k=top_k,
                eos_token=eos_token, stop_token_ids=stop_token_ids))
        if not ev.wait(timeout):
            with self._lock:
                self._waiters.pop(rid, None)
                self._results.pop(rid, None)
            return None
        with self._lock:
            return self._results.pop(rid, None)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {**self._stats,
                   "active_slots": self.engine.num_active,
                   "queued": len(self.engine.queue),
                   **self.engine.stats}
            degraded = self._degraded
        if degraded is not None:
            out["degraded"] = degraded
        return out

    def drain(self, timeout: float = 60.0) -> bool:
        """Let the engine loop finish queued + in-flight requests.  True
        when drained, False on timeout or when degraded."""
        if self.degraded is not None:
            return False
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.engine.has_work():
                return True
            time.sleep(0.05)
        return False

    def close(self, timeout: Optional[float] = 2.0):
        """Stop the engine loop."""
        self._stop.set()
        self._thread.join(timeout=timeout)

    # -- HTTP --------------------------------------------------------------

    def make_server(self, host="0.0.0.0",
                    port=C.PORT_SERVE) -> ThreadingHTTPServer:
        frontend = self

        class Handler(JsonHandler):
            def _load_headers(self):
                """Continuous-batching feedback for the gateway."""
                st = frontend.engine.stats
                return {"X-TPU-Queue-Depth": str(st["queue_depth"]),
                        "X-TPU-Active-Slots": str(st["active_slots"])}

            def do_GET(self):
                if self.path == "/healthz":
                    if frontend.degraded is not None:
                        return self._send(503, {
                            "status": "degraded",
                            "reason": frontend.degraded})
                    return self._send(200, {"status": "ok"})
                if self.path == "/stats":
                    return self._send(200, frontend.stats())
                return self._send(404, {"message": "unknown path"})

            def do_POST(self):
                if self.path != "/v1/completions":
                    return self._send(404, {"message": "unknown path"})
                try:
                    body = self._body()
                except ValueError as e:
                    return self._send(400, {"message": f"bad body: {e}"})
                if not isinstance(body, dict):
                    return self._send(400, {"message": "body must be a JSON "
                                                       "object"})
                prompt = body.get("prompt_tokens")
                if not isinstance(prompt, list) or not prompt or \
                        not all(isinstance(t, int) for t in prompt):
                    return self._send(
                        400, {"message": "prompt_tokens must be a non-empty "
                                         "list of token ids"})
                vocab = frontend.engine.cfg.vocab_size
                if not all(0 <= t < vocab for t in prompt):
                    return self._send(400, {
                        "message": f"token ids must be in [0, {vocab})"})
                if body.get("stream"):
                    return self._send(501, {
                        "message": "streaming is not supported by this "
                                   "server yet"})
                try:
                    max_tokens = int(body.get("max_tokens", 64))
                    temperature = float(body.get("temperature", 0.0))
                    top_p = float(body.get("top_p", 1.0))
                    top_k = int(body.get("top_k", 0))
                    stop_ids = body.get("stop_token_ids")
                    if stop_ids is not None and (
                            not isinstance(stop_ids, list) or
                            not all(isinstance(t, int) for t in stop_ids)):
                        return self._send(400, {
                            "message": "stop_token_ids must be a list "
                                       "of token ids"})
                    # Clamped: an unbounded client timeout would become an
                    # unbounded shutdown time.
                    timeout = min(float(body.get("timeout", 300.0)), 600.0)
                except (TypeError, ValueError) as e:
                    return self._send(400, {"message": f"bad parameter: {e}"})
                if max_tokens <= 0:
                    return self._send(400, {"message": "max_tokens must be > 0"})
                if not 0.0 < top_p <= 1.0:
                    return self._send(400, {"message": "top_p must be in (0, 1]"})
                if top_k < 0:
                    return self._send(400, {"message": "top_k must be >= 0"})
                resp_headers = self._load_headers()
                resp = frontend.submit(
                    prompt, max_tokens=max_tokens, temperature=temperature,
                    eos_token=body.get("eos_token"), timeout=timeout,
                    top_p=top_p, top_k=top_k, stop_token_ids=stop_ids)
                if resp is None:
                    return self._send(503,
                                      {"message": "overloaded or timed out"},
                                      headers=resp_headers)
                return self._send(200, {
                    "id": resp.request_id,
                    "tokens": resp.tokens,
                    "finish_reason": resp.finish_reason,
                    "prompt_len": resp.prompt_len,
                    "ttft_ms": (round(resp.ttft_s * 1e3, 3)
                                if resp.ttft_s is not None else None),
                }, headers=resp_headers)

        srv = ThreadingHTTPServer((host, port), Handler)
        # Non-daemon handler threads: server_close() joins them, so a
        # response is not cut off at shutdown.
        srv.daemon_threads = False
        return srv

    def serve_background(self, host="127.0.0.1", port=0):
        return serve_background(self.make_server(host, port), "serve-http")


def main(argv=None):
    import argparse
    import signal

    import torch

    from kuberay_tpu_torch.models import llama
    from kuberay_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(prog="kuberay-tpu-torch-serve")
    ap.add_argument("--model", default="llama_1b", choices=sorted(llama.CONFIGS))
    ap.add_argument("--port", type=int, default=C.PORT_SERVE)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain paths)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = llama.CONFIGS[args.model]
    # Seed-0 random init: no checkpoint loading in the port yet.
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(cfg, gen, device)
    engine = ServeEngine(cfg, params, max_slots=args.max_slots,
                         max_len=args.max_len, device=device)
    frontend = ServeFrontend(engine)
    srv = frontend.make_server(args.host, args.port)
    print(f"serving {args.model} on {args.host}:{srv.server_address[1]} "
          f"({device})", flush=True)

    def _on_term(signum, frame):
        # srv.shutdown() must not run on the thread inside serve_forever.
        print("serve: SIGTERM — draining", flush=True)
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_term)
    try:
        srv.serve_forever()
    finally:
        drained = frontend.drain(timeout=60.0)
        srv.server_close()
        print(f"serve: drained={drained}", flush=True)
        frontend.close(timeout=None)


if __name__ == "__main__":
    main()
