"""Inference HTTP server for the PyTorch engine.

Port of ``kuberay_tpu/serve/server.py``: a background thread drains the
continuous batcher; HTTP handlers enqueue requests and wait on
per-request events.  Same wire format as the JAX server:

    POST /v1/completions   {"prompt_tokens": [...], "max_tokens": N,
                            "temperature": T, "top_p": P, "top_k": K,
                            "eos_token": E, "stop_token_ids": [...]}
                           -> {"id", "tokens", "finish_reason",
                               "prompt_len", "ttft_ms"}
                           ("stream": true -> NDJSON, chunked: one
                           {"tokens": [...]} line per engine emission,
                           then {"id", "finish_reason", "prompt_len",
                           "num_tokens"} or {"error": ...})
    POST /v1/kv/resident   {"prompt_tokens"} -> {"resident_blocks"}
    POST /v1/kv/export     {"prompt_tokens", "skip_blocks", "max_blocks"}
                           -> {"blocks": [{index, hash, k, v}],
                               "block_size"}
    POST /v1/kv/import     {"prompt_tokens", "blocks"}
                           -> {"imported", "skipped"}
    GET  /v1/kv/advert?since=N -> {"seq", "reset", "add", "del"}
    GET  /healthz | /stats | /metrics

Responses carry the gateway's load headers: X-TPU-Queue-Depth and
X-TPU-Active-Slots always; X-TPU-KV-Free-Blocks and X-TPU-KV-Total-Blocks
from a paged engine; X-TPU-KV-Advert-Seq, X-TPU-KV-Host-Free-Blocks and
X-TPU-KV-Host-Total-Blocks from a paged engine with KV tiers.  The
``/v1/kv/*`` endpoints are the disaggregated prefill-to-decode handoff
and the fleet KV index's advert channel (a dense engine answers 501);
they run on the engine-loop thread between steps
(``ServeFrontend.call_engine``), never beside a step.

A ``traceparent`` request header is adopted (the engine's spans join
that trace) and echoed.  ``/metrics`` is Prometheus text: every numeric
stat as a ``tpu_serve_*`` counter or gauge, then the engine registry's
request-phase histogram ``tpu_serve_request_duration_seconds``.

Run:  python -m kuberay_tpu_torch.serve.server --model llama3_8b
          [--paged [--block-size 16] [--num-blocks N]
           [--host-blocks N [--spill-blocks N]]] [--kv-quant int8]
          [--prefill-chunk N] [--speculative N] [--weight-quant int8]
          [--checkpoint-dir DIR [--checkpoint-step N]]
          [--app-name NAME] [--coordinator URL|auto
          [--config-from-coordinator [--config-wait S]]]
          [--tp N [--dist-backend nccl|gloo] [--dist-port P]
           [--group-miss-timeout S] [--group-step-timeout S]
           [--group-compile-timeout S] [--group-budget-multiplier X]]

``--paged`` serves from the paged KV pool with prefix caching
(``serve/paged_engine.py``), ``--host-blocks`` / ``--spill-blocks`` add
its host and spill KV tiers (``serve/kv_tiers.py``); ``--kv-quant int8``
stores K/V in int8, in the paged pool or, without ``--paged``, in the
dense cache;
``--prefill-chunk`` prefills prompts in chunks of that many tokens;
``--speculative`` drafts that many tokens by prompt lookup for greedy
requests; ``--weight-quant int8`` serves int8 weights.

``--checkpoint-dir`` serves the params of a train checkpoint
(``train/checkpoint.py``, the newest step or ``--checkpoint-step``)
instead of seed 0's random weights; a missing checkpoint is a usage
error.  With ``--coordinator`` the app reports RUNNING to the head's
coordinator once its socket is bound and STOPPED before it drains;
``--config-from-coordinator`` first reads the app's block of the
submitted serve config (the TpuService's ``serveConfig``), which
overrides the flags.  ``decode_impl`` other than ``auto`` (as a flag
or a config key) is refused: the port has one decode path.

Tensor parallelism (``--tp``, one process a card): every process of the
slice runs the same command with the worker env (``TPU_WORKER_ID``,
``TPU_WORKER_HOSTNAMES``, or ``TPU_NUM_PROCESSES``; the card is
``LOCAL_RANK``), which joins them into one process group
(``train/launcher.py::initialize_distributed``); tp must equal the
group's size.  Each rank builds the serving mesh, its shards of the
params (seeded, or its chunks of ``--checkpoint-dir``) and of the cache.
Rank 0 serves HTTP through ``serve/multihost.py``'s lockstep engine and
listens for the followers' heartbeats on ``TPU_GROUP_HEALTH_PORT``
(``serve/group_health.py``); every other rank prints ``serve follower i/n
ready``, beats rank 0 and replays its device calls until STOP.  A follower
that dies or wedges degrades the group: ``/healthz`` and pending requests
answer 503, and the app reports DEGRADED to the coordinator (retried until
delivered).  At shutdown rank 0 drains, ends its engine loop, then
broadcasts STOP; a follower waits for it through a SIGTERM.  Under tp > 1
the KV tiers (``--host-blocks``, ``--spill-blocks``) and the ``/v1/kv/*``
block transfer run on rank 0's tier store, each block copy a plan every
rank replays (``serve/multihost.py``).
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import sys
import threading
import time
import traceback
import uuid
from http.server import ThreadingHTTPServer
from typing import Any, Dict, Optional

from kuberay_tpu_torch.obs.trace import TraceContext
from kuberay_tpu_torch.runtime.coordinator_client import (
    CoordinatorClient,
    CoordinatorError,
    dashboard_url,
)
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
    def __init__(self, engine: ServeEngine, max_queue: int = 256,
                 monitor=None, on_degraded=None):
        self.engine = engine
        self.max_queue = max_queue
        self.monitor = monitor               # GroupMonitor (rank 0) or None
        self._on_degraded_cb = on_degraded   # e.g. the coordinator report
        self._degraded: Optional[str] = None
        self._lock = threading.Lock()
        self._waiters: Dict[str, threading.Event] = {}
        self._results: Dict[str, Response] = {}
        # rid -> queue of token lists for a streaming consumer; completion
        # is signalled through the rid's waiter event.
        self._streams: Dict[str, "queue.Queue"] = {}
        # Control calls the engine-loop thread runs between steps (KV-block
        # export and import must not race a step's pool writes): (fn, done
        # event, result box).
        self._control: list = []
        self._stop = threading.Event()
        self._stats = {"requests": 0, "completed": 0, "rejected": 0,
                       "tokens_out": 0, "failed_degraded": 0}
        engine.token_callback = self._on_tokens
        if monitor is not None and hasattr(engine, "attach_monitor"):
            engine.attach_monitor(monitor)
            monitor.on_degraded = self._handle_degraded
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-engine-loop")
        self._thread.start()

    @property
    def degraded(self) -> Optional[str]:
        with self._lock:
            return self._degraded

    def _handle_degraded(self, reason: str) -> None:
        """One-way: stop admitting, fail every pending waiter (an immediate
        503 beats a client-timeout hang) and surface it.  In a tp group the
        engine-loop thread may stay stuck inside a dead collective; the
        recovery is the whole group's replacement, not in-process repair."""
        with self._lock:
            if self._degraded is not None:
                return
            self._degraded = reason
            waiters = list(self._waiters.values())
            self._waiters.clear()
            self._stats["failed_degraded"] += len(waiters)
        # The engine (its STOP broadcast is skipped) and the monitor (so
        # /stats' group view agrees) learn it too, also when the signal
        # came from an engine exception rather than the watchdog.
        if hasattr(self.engine, "group_failed"):
            self.engine.group_failed = True
        if self.monitor is not None:
            self.monitor.mark_degraded(reason)
        for ev in waiters:
            ev.set()                       # submit() sees no result -> None
        if self._on_degraded_cb is not None:
            try:
                self._on_degraded_cb(reason)
            except Exception:
                traceback.print_exc(file=sys.stderr)

    def _loop(self):
        while not self._stop.is_set():
            if self.degraded is not None:
                self._stop.wait(0.1)
                continue
            self._drain_control()
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

    def _drain_control(self):
        """Run the queued control calls on the engine-loop thread."""
        with self._lock:
            if not self._control:
                return
            batch, self._control = self._control, []
        for fn, ev, box in batch:
            try:
                box["result"] = fn(self.engine)
            except Exception as e:          # raised in the caller's thread
                box["error"] = e
            ev.set()

    def call_engine(self, fn, timeout: float = 30.0):
        """Run ``fn(engine)`` on the engine-loop thread, between steps: the
        KV-block endpoints' seam (handler threads never touch the
        allocator or the pool mid-step).  Raises TimeoutError when the
        loop does not get to it in time (wedged or degraded)."""
        ev = threading.Event()
        box: Dict[str, Any] = {}
        with self._lock:
            self._control.append((fn, ev, box))
        if not ev.wait(timeout):
            raise TimeoutError("engine loop did not service the call "
                               f"within {timeout:g}s")
        if "error" in box:
            raise box["error"]
        return box.get("result")

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
        if self.monitor is not None:
            out["group"] = self.monitor.status()
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
        """Stop the engine loop.  ``timeout=None`` waits until the thread
        has ended, which a tp group's rank 0 needs before it broadcasts
        STOP (two threads broadcasting could pair a follower's receive
        with the wrong send).  A degraded group caps the wait: the loop
        thread may be pinned inside a dead collective (it is a daemon, and
        the STOP broadcast is skipped then)."""
        self._stop.set()
        if self.degraded is not None:
            timeout = 2.0 if timeout is None else min(timeout, 2.0)
        self._thread.join(timeout=timeout)

    # -- HTTP --------------------------------------------------------------

    def make_server(self, host="0.0.0.0",
                    port=C.PORT_SERVE) -> ThreadingHTTPServer:
        frontend = self

        class Handler(JsonHandler):
            def _load_headers(self):
                """Continuous-batching feedback for the gateway: the queue
                depth and active slots; a paged engine's free and total
                blocks; a tiered engine's advert cursor and host tier."""
                st = frontend.engine.stats
                h = {"X-TPU-Queue-Depth": str(st["queue_depth"]),
                     "X-TPU-Active-Slots": str(st["active_slots"])}
                if "num_blocks" in st:
                    h["X-TPU-KV-Free-Blocks"] = str(st["free_blocks"])
                    h["X-TPU-KV-Total-Blocks"] = str(st["num_blocks"])
                if "advert_seq" in st:
                    # The gateway pulls /v1/kv/advert when the cursor moves.
                    h["X-TPU-KV-Advert-Seq"] = str(st["advert_seq"])
                    h["X-TPU-KV-Host-Free-Blocks"] = str(
                        st["host_blocks_total"] - st["host_blocks_used"])
                    h["X-TPU-KV-Host-Total-Blocks"] = str(
                        st["host_blocks_total"])
                return h

            def do_GET(self):
                if self.path == "/healthz":
                    if frontend.degraded is not None:
                        return self._send(503, {
                            "status": "degraded",
                            "reason": frontend.degraded})
                    return self._send(200, {"status": "ok"})
                if self.path == "/stats":
                    return self._send(200, frontend.stats())
                if self.path.split("?", 1)[0] == "/v1/kv/advert":
                    return self._kv_advert()
                if self.path == "/metrics":
                    text = render_stats(frontend.stats())
                    reg = frontend.engine.metrics
                    if reg is not None:
                        text += reg.render()
                    return self._send_text(200, text,
                                           "text/plain; version=0.0.4")
                return self._send(404, {"message": "unknown path"})

            def _kv_advert(self):
                """Residency advert delta for the gateway's fleet index:
                ?since=N gives the membership changes after N, or a full
                snapshot once N fell out of the bounded advert log."""
                if not hasattr(frontend.engine, "kv_advert"):
                    return self._send(501, {
                        "message": "KV adverts require a paged engine "
                                   "(--paged)"})
                since = 0
                for part in self.path.partition("?")[2].split("&"):
                    if part.startswith("since="):
                        try:
                            since = int(part[6:])
                        except ValueError:
                            return self._send(400, {
                                "message": "since must be an int"})
                try:
                    doc = frontend.call_engine(lambda e: e.kv_advert(since))
                except TimeoutError as e:
                    return self._send(503, {"message": str(e)})
                return self._send(200, doc, headers=self._load_headers())

            def _kv_endpoint(self):
                """The KV-block handoff (disaggregated serving):
                ``resident`` probes the delta, ``export`` reads a prompt's
                registered blocks off a prefill replica, ``import`` adopts
                them on a decode replica; each through call_engine."""
                if not hasattr(frontend.engine, "import_kv_blocks"):
                    return self._send(501, {
                        "message": "KV-block transfer requires a paged "
                                   "engine (--paged)"})
                if frontend.degraded is not None:
                    return self._send(503, {"message": "degraded"})
                try:
                    body = self._body()
                except ValueError as e:
                    return self._send(400, {"message": f"bad body: {e}"})
                prompt = body.get("prompt_tokens") \
                    if isinstance(body, dict) else None
                if not isinstance(prompt, list) or not prompt or \
                        not all(isinstance(t, int) for t in prompt):
                    return self._send(400, {
                        "message": "prompt_tokens must be a non-empty "
                                   "list of token ids"})
                try:
                    if self.path == "/v1/kv/resident":
                        n = frontend.call_engine(
                            lambda e: e.resident_prefix_blocks(prompt))
                        return self._send(200, {"resident_blocks": n},
                                          headers=self._load_headers())
                    if self.path == "/v1/kv/export":
                        try:
                            skip = int(body.get("skip_blocks", 0))
                            cap = int(body.get("max_blocks", 0))
                        except (TypeError, ValueError):
                            return self._send(400, {
                                "message": "skip_blocks/max_blocks must "
                                           "be ints"})
                        blocks = frontend.call_engine(
                            lambda e: e.export_kv_blocks(
                                prompt, skip_blocks=max(0, skip),
                                max_blocks=max(0, cap)))
                        return self._send(
                            200, {"blocks": blocks,
                                  "block_size": frontend.engine.block_size},
                            headers=self._load_headers())
                    blocks = body.get("blocks")
                    if not isinstance(blocks, list):
                        return self._send(400, {
                            "message": "blocks must be a list"})
                    counts = frontend.call_engine(
                        lambda e: e.import_kv_blocks(prompt, blocks))
                    return self._send(200, counts,
                                      headers=self._load_headers())
                except NotImplementedError as e:
                    # A pool format without the transfer (int8).
                    return self._send(501, {"message": str(e)})
                except TimeoutError as e:
                    return self._send(503, {"message": str(e)})

            def do_POST(self):
                if self.path in ("/v1/kv/resident", "/v1/kv/export",
                                 "/v1/kv/import"):
                    return self._kv_endpoint()
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
                        stop_ids, trace)
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
                                   stop_token_ids, trace):
                """Chunked NDJSON: one {"tokens": [...]} line per engine
                emission, then a final line with the finish reason, or
                {"error": ...} if the request died mid-stream.  Rejection
                is decided before the headers go out, so an overloaded or
                degraded stream gets a 503.  As the JAX server's, neither
                reply carries the load headers or the traceparent echo:
                only Content-Type and Transfer-Encoding on the 200."""
                gen = frontend.submit_stream(
                    prompt, max_tokens=max_tokens, temperature=temperature,
                    eos_token=eos_token, timeout=timeout, top_p=top_p,
                    top_k=top_k, stop_token_ids=stop_token_ids, trace=trace)
                first = next(gen, None)
                if first is None:
                    gen.close()
                    return self._send(503,
                                      {"message": "overloaded or timed out"})
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
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


def register_with_coordinator(app_name: str, coordinator_url: str,
                              status: str = "RUNNING") -> bool:
    """Report the serve app's status to the head's coordinator (what the
    TpuService controller reads)."""
    try:
        CoordinatorClient(coordinator_url).set_serve_app_status(
            app_name, status)
        return True
    except CoordinatorError:
        return False


# The serve config's application keys -> engine CLI args (the
# serveConfig-to-engine wire, as the JAX server reads it): key ->
# (coercion, allowed choices or None).  Explicit CLI flags are
# overwritten: in a managed pod the submitted config is the source of
# truth.
_CONFIG_KEYS = {
    "model": (str, None),
    "paged": (bool, None),
    "block_size": (int, None),
    "num_blocks": (int, None),
    "host_blocks": (int, None),
    "spill_blocks": (int, None),
    "prefill_chunk": (int, None),
    "speculative": (int, None),
    "kv_quant": (str, ("none", "int8")),
    "weight_quant": (str, ("none", "int8")),
    "tp": (int, None),
    "max_slots": (int, None),
    "max_len": (int, None),
    "checkpoint_dir": (str, None),
    "checkpoint_step": (int, None),
    "decode_impl": (str, ("auto", "pallas", "xla", "pallas_interpret")),
    "group_miss_timeout": (float, None),
    "group_step_timeout": (float, None),
    "group_compile_timeout": (float, None),
    "group_budget_multiplier": (float, None),
}


def _unported(key: str, val) -> Optional[str]:
    """Why the port cannot honour config ``key`` = ``val``, or None."""
    if key == "decode_impl" and val != "auto":
        return ("the port has one decode path, its CUDA kernels (auto); "
                "it has no XLA or Pallas path to choose")
    return None


def _apply_coordinator_config(args, ap) -> None:
    """Fetch the submitted serve config and fold this app's settings into
    ``args`` (a bounded wait: the controller PUTs the config only once
    the cluster reports ready, which may be after the pod starts)."""
    if not args.coordinator:
        ap.error("--config-from-coordinator requires --coordinator "
                 "(or auto with the operator env)")
    client = CoordinatorClient(args.coordinator)
    deadline = time.time() + args.config_wait
    cfg = None
    while time.time() < deadline:
        try:
            doc = client.get_serve_config()
        except CoordinatorError:
            doc = {}
        for app in (doc or {}).get("applications", []) or []:
            if app.get("name") == args.app_name:
                cfg = app
                break
        if cfg is not None:
            break
        time.sleep(1.0)
    if cfg is None:
        ap.error(f"serve config for app {args.app_name!r} did not "
                 f"appear on {args.coordinator} within "
                 f"{args.config_wait:.0f}s")
    applied = {}
    for key, (coerce, choices) in _CONFIG_KEYS.items():
        if key not in cfg:
            continue
        try:
            val = coerce(cfg[key])
        except (TypeError, ValueError):
            ap.error(f"serve config {key}={cfg[key]!r}: not a valid "
                     f"{coerce.__name__}")
        if choices is not None and val not in choices:
            ap.error(f"serve config {key}={val!r}: must be one of "
                     f"{choices}")
        why = _unported(key, val)
        if why is not None:
            ap.error(f"serve config {key}={val!r}: {why}")
        setattr(args, key, val)
        applied[key] = val
    print(f"serve config applied for app {args.app_name!r}: {applied}",
          flush=True)


def main(argv=None):
    import argparse
    import signal

    import torch
    import torch.distributed as dist

    from kuberay_tpu_torch.models import llama
    from kuberay_tpu_torch.serve.group_health import (
        GroupMonitor,
        start_heartbeat,
    )
    from kuberay_tpu_torch.serve.multihost import (
        MultihostPagedServeEngine,
        MultihostServeEngine,
        follower_loop,
    )
    from kuberay_tpu_torch.serve.sharding import (
        SERVE_AXES,
        init_sharded_params,
        param_shardings,
        serve_layout,
        serve_mesh,
        tp_factors,
        validate_tp,
    )
    from kuberay_tpu_torch.train.checkpoint import load_params_for_serving
    from kuberay_tpu_torch.train.launcher import (
        WorkerIdentity,
        initialize_distributed,
    )
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
    ap.add_argument("--host-blocks", type=int, default=0,
                    help="host-memory KV tier capacity in blocks (0 = "
                         "tiering off; paged engines only)")
    ap.add_argument("--spill-blocks", type=int, default=0,
                    help="bounded spill KV tier behind the host tier "
                         "(blocks; 0 = off)")
    ap.add_argument("--decode-impl", default="auto",
                    choices=["auto", "pallas", "xla", "pallas_interpret"],
                    help="decode attention path; the port has one, its "
                         "CUDA kernels (auto)")
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
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism: one process a card, tp of "
                         "them (0 = the slice's process count; a slice of "
                         "several processes implies it).  Every process of "
                         "the slice runs this same command; the worker env "
                         "(TPU_WORKER_ID, TPU_WORKER_HOSTNAMES) joins them "
                         "into one group and ranks > 0 become lockstep "
                         "followers")
    ap.add_argument("--group-miss-timeout", type=float,
                    default=float(os.environ.get(
                        "TPU_GROUP_MISS_TIMEOUT", "10")),
                    help="seconds of missed follower heartbeats before "
                         "the group degrades")
    ap.add_argument("--group-step-timeout", type=float,
                    default=float(os.environ.get(
                        "TPU_GROUP_STEP_TIMEOUT", "60")),
                    help="cold-start device-step budget; after ~20 "
                         "observed steps the watchdog switches to an "
                         "adaptive budget (multiplier x rolling p99, "
                         "floored at the miss timeout)")
    ap.add_argument("--group-compile-timeout", type=float,
                    default=float(os.environ.get(
                        "TPU_GROUP_COMPILE_TIMEOUT", "900")),
                    help="budget for an op's first step (kernel builds)")
    ap.add_argument("--group-budget-multiplier", type=float,
                    default=float(os.environ.get(
                        "TPU_GROUP_BUDGET_MULTIPLIER", "20")),
                    help="adaptive budget = this x rolling p99 step "
                         "time")
    ap.add_argument("--dist-backend", default="", choices=("", "nccl",
                                                           "gloo"),
                    help="backend of a multi-process slice's model "
                         "collectives (default: nccl on the card, gloo on "
                         "the cpu; given on a single host, a group of "
                         "one); gloo on the card stages them through "
                         "pinned host buffers, so ranks can share a card")
    ap.add_argument("--dist-port", type=int, default=0,
                    help="port of the process group's rendezvous on "
                         "worker 0 (default: the coordinator port)")
    ap.add_argument("--app-name", default="llm",
                    help="the serve application's name")
    ap.add_argument("--coordinator", default="",
                    help="the head coordinator's URL, or auto (from "
                         "TPU_COORDINATOR_ADDRESS): the app reports "
                         "RUNNING, DEGRADED and STOPPED there")
    ap.add_argument("--checkpoint-dir", default="",
                    help="serve the params of this train checkpoint "
                         "directory instead of seed 0's random weights "
                         "(each rank reads its shards under --tp)")
    ap.add_argument("--checkpoint-step", type=int, default=-1,
                    help="checkpoint step to serve (-1 = latest; 0 is "
                         "a real step)")
    ap.add_argument("--config-from-coordinator", action="store_true",
                    help="read this app's engine settings from the "
                         "coordinator's submitted serve config before "
                         "starting")
    ap.add_argument("--config-wait", type=float, default=60.0,
                    help="seconds to wait for the serve config to "
                         "appear on the coordinator")
    args = ap.parse_args(argv)
    if args.coordinator == "auto":
        addr = os.environ.get(C.ENV_COORDINATOR_ADDRESS, "")
        args.coordinator = dashboard_url(addr) if addr else ""
    if args.config_from_coordinator:
        _apply_coordinator_config(args, ap)
    why = _unported("decode_impl", args.decode_impl)
    if why is not None:
        ap.error(f"--decode-impl {args.decode_impl}: {why}")
    # Slice identity: the training launcher's env contract.  One process
    # a card, so tp is the group's size.
    ident = WorkerIdentity.from_env()
    world = ident.global_process_count
    tp = args.tp if args.tp > 0 else world
    if ident.is_distributed and args.tp == 1:
        tp = world                     # a multi-process slice implies tp
    if tp != world:
        # A group smaller than the slice would leave some processes out
        # of the plans: they hang in their first collective.
        ap.error(f"multi-host serving requires tp == total chips "
                 f"({world}); got --tp {args.tp}. Use --tp 0 (auto)")
    cfg = llama.CONFIGS[args.model]
    try:
        # Every rank refuses a model the mesh cannot split before the
        # group's rendezvous.
        validate_tp(cfg, dict(zip(SERVE_AXES,
                                  tp_factors(tp, cfg.n_kv_heads))))
    except ValueError as e:
        ap.error(str(e))
    device = resolve_device(args.device)
    if ident.is_distributed or args.dist_backend:
        initialize_distributed(ident, args.dist_backend, device,
                               args.dist_port)
    grouped = dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    layout = None
    if grouped:
        layout = serve_layout(serve_mesh(tp, n_kv_heads=cfg.n_kv_heads,
                                         device_type=device.type))
    if args.checkpoint_dir:
        # The train-to-serve handoff.  A missing checkpoint is an error:
        # serving random weights instead would look like a broken model.
        step = None if args.checkpoint_step < 0 else args.checkpoint_step
        params = load_params_for_serving(
            args.checkpoint_dir, step=step, dtype=cfg.dtype, device=device,
            shardings=(param_shardings(cfg, layout) if layout is not None
                       else None))
        if params is None:
            ap.error(f"no checkpoint found in {args.checkpoint_dir}"
                     + (f" at step {step}" if step is not None else ""))
        print(f"restored params from {args.checkpoint_dir} "
              f"(step {'latest' if step is None else step})", flush=True)
    elif layout is not None:
        # Drawn straight into this rank's shards: the flagship model does
        # not fit one card twice.
        params = init_sharded_params(cfg, 0, layout)
    else:
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
                     layout=layout)
    if args.paged:
        engine_kw.update(num_blocks=args.num_blocks,
                         block_size=args.block_size,
                         host_blocks=args.host_blocks,
                         spill_blocks=args.spill_blocks)
    # One class pair for both roles: rank 0's and the followers' engines
    # must match, or the plans' shapes diverge (a hang, not an error).
    follower_cls, lead_cls = (
        (PagedServeEngine, MultihostPagedServeEngine) if args.paged
        else (ServeEngine, MultihostServeEngine))
    hb_port = int(os.environ.get("TPU_GROUP_HEALTH_PORT",
                                 C.PORT_GROUP_HEALTH))
    if rank > 0:
        # A follower: no frontend and no scheduling; replay rank 0's
        # device calls until it broadcasts STOP.  Its heartbeat lets rank
        # 0 detect its death instead of hanging in a collective.
        engine = follower_cls(cfg, params, **engine_kw)
        del params
        host0 = ident.hostnames[0] if ident.hostnames else "127.0.0.1"
        start_heartbeat(host0, hb_port, rank)

        def _follower_term(signum, frame):
            # The group stops together: rank 0 drains, then its STOP
            # plan ends this loop.
            print("serve follower: SIGTERM — waiting for STOP", flush=True)

        try:
            signal.signal(signal.SIGTERM, _follower_term)
        except ValueError:             # not the main thread
            pass
        print(f"serve follower {rank}/{world} ready", flush=True)
        n = follower_loop(engine)
        print(f"serve follower {rank}/{world}: STOP after {n} device "
              f"calls", flush=True)
        dist.destroy_process_group()
        return

    engine_kw["metrics"] = MetricsRegistry()
    monitor = None
    if grouped:
        engine = lead_cls(cfg, params, **engine_kw)
        if world > 1:
            monitor = GroupMonitor(
                expected=list(range(1, world)),
                miss_timeout=args.group_miss_timeout,
                step_timeout=args.group_step_timeout,
                compile_timeout=args.group_compile_timeout,
                budget_multiplier=args.group_budget_multiplier)
            monitor.listen(port=hb_port)
    else:
        engine = follower_cls(cfg, params, **engine_kw)
    del params

    def on_degraded(reason: str) -> None:
        # The TpuService controller maps a DEGRADED app to its
        # ServeGroupDegraded condition and replaces the group.  The
        # transition fires once, so the report retries until delivered.
        print(f"serve: DEGRADED — {reason}", flush=True)
        if not args.coordinator:
            return

        def report_until_delivered():
            while True:
                try:
                    CoordinatorClient(args.coordinator).set_serve_app_status(
                        args.app_name, "DEGRADED", reason)
                    return
                except CoordinatorError:
                    time.sleep(5.0)

        threading.Thread(target=report_until_delivered, daemon=True,
                         name="degraded-report").start()

    frontend = ServeFrontend(engine, monitor=monitor, on_degraded=on_degraded)
    srv = frontend.make_server(args.host, args.port)
    if args.coordinator:
        register_with_coordinator(args.app_name, args.coordinator)
    kind = "paged" if args.paged else "dense"
    tpr = layout.size("tpr") if layout is not None else 1
    print(f"serving {args.model} on {args.host}:{srv.server_address[1]} "
          f"(app {args.app_name}; {device}, {kind} KV cache, kv quant "
          f"{args.kv_quant}, weight quant {args.weight_quant}, prefill "
          f"chunk {args.prefill_chunk}, speculative {args.speculative}, "
          f"tp={tp // tpr} x tpr={tpr}, processes {world})", flush=True)

    def _on_term(signum, frame):
        # srv.shutdown() must not run on the thread inside serve_forever.
        print("serve: SIGTERM — draining", flush=True)
        threading.Thread(target=srv.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:                 # not the main thread
        pass
    try:
        srv.serve_forever()
    finally:
        if args.coordinator:
            # First, so the controller stops routing here while we drain
            # (the socket already stopped accepting).
            register_with_coordinator(args.app_name, args.coordinator,
                                      status="STOPPED")
        drained = frontend.drain(timeout=60.0)
        srv.server_close()
        print(f"serve: drained={drained}", flush=True)
        # The loop thread ends before STOP is broadcast: two threads
        # broadcasting could pair a follower's receive with the wrong
        # send.
        frontend.close(timeout=None)
        if isinstance(engine, lead_cls):
            engine.stop()
        if monitor is not None:
            monitor.close()
    if grouped:
        if frontend.degraded is not None:
            # The loop thread may sit in a dead collective, and tearing
            # the group down could wait on it: leave at once.
            sys.stdout.flush()
            os._exit(1)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
