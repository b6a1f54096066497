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
                           ("stream": true -> NDJSON, chunked: one
                           {"tokens": [...]} line per engine emission,
                           then {"id", "finish_reason", "prompt_len",
                           "num_tokens"} or {"error": ...})
    GET  /healthz | /stats | /metrics

A ``traceparent`` request header is adopted (the engine's spans join
that trace) and echoed.  ``/metrics`` is Prometheus text: every numeric
stat as a ``tpu_serve_*`` counter or gauge, then the engine registry's
request-phase histogram ``tpu_serve_request_duration_seconds``.

The KV-block endpoints, coordinator registration (and
``--config-from-coordinator``) and multi-host serving are not ported yet.

Run:  python -m kuberay_tpu_torch.serve.server --model llama3_8b
          [--paged [--block-size 16] [--num-blocks N]] [--kv-quant int8]
          [--prefill-chunk N] [--speculative N] [--weight-quant int8]
          [--app-name NAME]

``--paged`` serves from the paged KV pool with prefix caching
(``serve/paged_engine.py``); ``--kv-quant int8`` stores K/V in int8, in
the paged pool or, without ``--paged``, in the dense cache;
``--prefill-chunk`` prefills prompts in chunks of that many tokens;
``--speculative`` drafts that many tokens by prompt lookup for greedy
requests; ``--weight-quant int8`` serves int8 weights.
"""

from __future__ import annotations

import itertools
import json
import queue
import sys
import threading
import time
import traceback
import uuid
from http.server import ThreadingHTTPServer
from typing import Any, Dict, Optional

from kuberay_tpu_torch.obs.trace import TraceContext
from kuberay_tpu_torch.serve.engine import Request, Response, ServeEngine
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine
from kuberay_tpu_torch.utils import constants as C
from kuberay_tpu_torch.utils.httpjson import JsonHandler, serve_background
from kuberay_tpu_torch.utils.metrics import MetricsRegistry

# Monotonic stats render as Prometheus counters, the rest as gauges.
METRIC_COUNTERS = frozenset({
    "requests", "completed", "rejected", "tokens_out", "prefix_hit_tokens",
    "prefix_query_tokens", "drafted", "accepted", "verify_steps"})


def render_stats(stats: Dict[str, Any]) -> str:
    """Every numeric stat as a ``tpu_serve_<key>`` counter or gauge, in
    key order."""
    lines = []
    for k, v in sorted(stats.items()):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        name = f"tpu_serve_{k}"
        kind = "counter" if k in METRIC_COUNTERS else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {v}")
    return "\n".join(lines) + "\n"


class ServeFrontend:
    def __init__(self, engine: ServeEngine, max_queue: int = 256):
        self.engine = engine
        self.max_queue = max_queue
        self._degraded: Optional[str] = None
        self._lock = threading.Lock()
        self._waiters: Dict[str, threading.Event] = {}
        self._results: Dict[str, Response] = {}
        # rid -> queue of token lists for a streaming consumer; completion
        # is signalled through the rid's waiter event.
        self._streams: Dict[str, "queue.Queue"] = {}
        self._stop = threading.Event()
        self._stats = {"requests": 0, "completed": 0, "rejected": 0,
                       "tokens_out": 0, "failed_degraded": 0}
        engine.token_callback = self._on_tokens
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

    def _admit(self, rid, ev, prompt_tokens, max_tokens, temperature,
               eos_token, stream_queue=None, top_p=1.0, top_k=0,
               stop_token_ids=None, trace=None) -> bool:
        """Admission shared by blocking and streaming submits: the
        degraded and backlog rejections, the stats."""
        with self._lock:
            if self._degraded is not None or \
                    len(self.engine.queue) >= self.max_queue:
                self._stats["rejected"] += 1
                return False
            self._stats["requests"] += 1
            self._waiters[rid] = ev
            if stream_queue is not None:
                self._streams[rid] = stream_queue
            self.engine.add_request(Request(
                rid, list(prompt_tokens), max_new_tokens=max_tokens,
                temperature=temperature, top_p=top_p, top_k=top_k,
                eos_token=eos_token, stop_token_ids=stop_token_ids,
                trace=trace))
            return True

    def submit(self, prompt_tokens, max_tokens=64, temperature=0.0,
               eos_token=None, timeout: float = 300.0, top_p: float = 1.0,
               top_k: int = 0, stop_token_ids=None,
               trace=None) -> Optional[Response]:
        """Enqueue one request and wait for it; None when overloaded,
        degraded or timed out."""
        rid = uuid.uuid4().hex
        ev = threading.Event()
        if not self._admit(rid, ev, prompt_tokens, max_tokens, temperature,
                           eos_token, top_p=top_p, top_k=top_k,
                           stop_token_ids=stop_token_ids, trace=trace):
            return None
        if not ev.wait(timeout):
            with self._lock:
                self._waiters.pop(rid, None)
                self._results.pop(rid, None)
            return None
        with self._lock:
            return self._results.pop(rid, None)

    # -- streaming ---------------------------------------------------------

    def _on_tokens(self, rid: str, tokens) -> None:
        """Engine-thread hook: push freshly emitted tokens to a stream."""
        with self._lock:
            q = self._streams.get(rid)
        if q is not None:
            q.put(list(tokens))

    def submit_stream(self, prompt_tokens, max_tokens=64, temperature=0.0,
                      eos_token=None, timeout: float = 300.0,
                      top_p: float = 1.0, top_k: int = 0,
                      stop_token_ids=None, trace=None):
        """Generator of token lists as the engine emits them (singles for
        plain decode, runs for accepted speculation), ending with the
        Response, or None on overload, degradation or timeout."""
        rid = uuid.uuid4().hex
        ev = threading.Event()
        q: queue.Queue = queue.Queue()
        # Never yield under self._lock: a suspended generator would hold
        # it across the consumer's socket writes and stall the engine.
        if not self._admit(rid, ev, prompt_tokens, max_tokens, temperature,
                           eos_token, stream_queue=q, top_p=top_p,
                           top_k=top_k, stop_token_ids=stop_token_ids,
                           trace=trace):
            yield None
            return
        deadline = time.monotonic() + timeout
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    yield None
                    return
                if ev.is_set():
                    # Finished (or degraded): the queued tokens, then the
                    # Response (popped under the lock, yielded outside).
                    while True:
                        try:
                            yield q.get_nowait()
                        except queue.Empty:
                            break
                    with self._lock:
                        final = self._results.pop(rid, None)
                    yield final
                    return
                try:
                    yield q.get(timeout=min(0.1, remaining))
                except queue.Empty:
                    continue
        finally:
            with self._lock:
                self._streams.pop(rid, None)
                self._waiters.pop(rid, None)
                self._results.pop(rid, None)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {**self._stats,
                   "active_slots": self.engine.num_active,
                   "queued": len(self.engine.queue),
                   **self.engine.spec_stats,
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
                if self.path == "/metrics":
                    text = render_stats(frontend.stats())
                    reg = frontend.engine.metrics
                    if reg is not None:
                        text += reg.render()
                    return self._send_text(200, text,
                                           "text/plain; version=0.0.4")
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
                # Adopt the caller's trace (the engine's spans join it) and
                # echo it.
                trace = TraceContext.from_traceparent(
                    self.headers.get("traceparent"))
                resp_headers = self._load_headers()
                if trace is not None:
                    resp_headers["traceparent"] = trace.to_traceparent()
                if body.get("stream"):
                    return self._stream_completion(
                        prompt, max_tokens, temperature,
                        body.get("eos_token"), timeout, top_p, top_k,
                        stop_ids, trace, resp_headers)
                resp = frontend.submit(
                    prompt, max_tokens=max_tokens, temperature=temperature,
                    eos_token=body.get("eos_token"), timeout=timeout,
                    top_p=top_p, top_k=top_k, stop_token_ids=stop_ids,
                    trace=trace)
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

            def _stream_completion(self, prompt, max_tokens, temperature,
                                   eos_token, timeout, top_p, top_k,
                                   stop_token_ids, trace, resp_headers):
                """Chunked NDJSON: one {"tokens": [...]} line per engine
                emission, then a final line with the finish reason, or
                {"error": ...} if the request died mid-stream.  Rejection
                is decided before the headers go out, so an overloaded or
                degraded stream gets the blocking path's 503."""
                gen = frontend.submit_stream(
                    prompt, max_tokens=max_tokens, temperature=temperature,
                    eos_token=eos_token, timeout=timeout, top_p=top_p,
                    top_k=top_k, stop_token_ids=stop_token_ids, trace=trace)
                first = next(gen, None)
                if first is None:
                    gen.close()
                    return self._send(503,
                                      {"message": "overloaded or timed out"},
                                      headers=resp_headers)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                for k, v in resp_headers.items():
                    self.send_header(k, v)
                self.end_headers()

                def emit(doc) -> bool:
                    data = json.dumps(doc).encode() + b"\n"
                    try:
                        self.wfile.write(
                            f"{len(data):x}\r\n".encode() + data + b"\r\n")
                        self.wfile.flush()
                        return True
                    except (BrokenPipeError, ConnectionError, OSError):
                        return False

                for item in itertools.chain([first], gen):
                    if item is None:
                        emit({"error": "overloaded, degraded, or timed "
                                       "out"})
                        break
                    if isinstance(item, list):
                        if not emit({"tokens": item}):
                            gen.close()
                            return      # client gone
                    else:
                        emit({"id": item.request_id,
                              "finish_reason": item.finish_reason,
                              "prompt_len": item.prompt_len,
                              "num_tokens": len(item.tokens)})
                        break
                gen.close()
                try:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionError, OSError):
                    pass

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
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool with prefix caching")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV block size (tokens)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged pool blocks (0 = the dense cache's footprint)")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="KV cache storage: bf16 (none) or int8 with "
                         "per-position scales")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill size (0 = whole-prompt prefill)")
    ap.add_argument("--speculative", type=int, default=0,
                    help="prompt-lookup speculative decoding draft length "
                         "(greedy requests; 0 = off)")
    ap.add_argument("--weight-quant", default="none",
                    choices=["none", "int8"],
                    help="W8A16: int8 matmul weights with per-channel "
                         "scales (half the weight bytes)")
    ap.add_argument("--app-name", default="llm",
                    help="the serve application's name")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = llama.CONFIGS[args.model]
    # Seed-0 random init: no checkpoint loading in the port yet.
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(cfg, gen, device)
    engine_kw = dict(max_slots=args.max_slots, max_len=args.max_len,
                     device=device, kv_quant=args.kv_quant,
                     prefill_chunk=args.prefill_chunk,
                     speculative=args.speculative,
                     weight_quant=args.weight_quant,
                     # The tree is handed over: each bf16 leaf is freed
                     # once quantised.
                     donate_params=args.weight_quant != "none",
                     metrics=MetricsRegistry())
    if args.paged:
        engine = PagedServeEngine(cfg, params, num_blocks=args.num_blocks,
                                  block_size=args.block_size, **engine_kw)
    else:
        engine = ServeEngine(cfg, params, **engine_kw)
    del params
    frontend = ServeFrontend(engine)
    srv = frontend.make_server(args.host, args.port)
    kind = "paged" if args.paged else "dense"
    print(f"serving {args.model} on {args.host}:{srv.server_address[1]} "
          f"(app {args.app_name}; {device}, {kind} KV cache, kv quant "
          f"{args.kv_quant}, weight quant {args.weight_quant}, prefill "
          f"chunk {args.prefill_chunk}, speculative {args.speculative})",
          flush=True)

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
