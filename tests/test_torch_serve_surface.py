"""PyTorch port, the serve surface over real HTTP on a CPU engine:
streaming NDJSON (chunked framing, tokens equal to the blocking path's
and the JAX server's, runs under speculation, 503 before the headers, the
JAX server's header set on the streamed 200 and 503),
``/metrics`` (the JAX server's names and types for the same stats, the
request-phase histograms), ``traceparent`` parsed as the JAX package
parses it and echoed, the engine's spans, and the server's new flags."""

import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.obs import trace as jtrace
from kuberay_tpu.serve import engine as jeng
from kuberay_tpu.serve import server as jserver
from kuberay_tpu.utils import metrics as jmetrics
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.obs import trace as ttrace
from kuberay_tpu_torch.serve import engine as teng
from kuberay_tpu_torch.serve import paged_engine as tpe
from kuberay_tpu_torch.serve import server as tserver
from kuberay_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JCFG = jllama.CONFIGS["llama_tiny"]
TCFG = tllama.CONFIGS["llama_tiny"]
PROMPTS = ([5, 17, 42, 7], [3, 4, 5, 6] * 4, [9, 1, 30])
TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


class Recorder(ttrace.NoopTracer):
    """A tracer that records (trace id, span name, attributes) of the
    request spans (its step spans are the no-op tracer's)."""

    enabled = True

    def __init__(self):
        self.spans = []

    def record_span(self, ctx, name, start, end, **attrs):
        self.spans.append((ctx.trace_id, name, sorted(attrs)))


@pytest.fixture(scope="module")
def trees():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")


def _stop(srv, frontend):
    srv.shutdown()
    srv.server_close()
    frontend.close()


@pytest.fixture(scope="module")
def servers(trees):
    """The port's dense server (and one with speculation, and one that
    admits nothing), and the JAX server (and one that admits nothing),
    each dense one with a metrics registry."""
    jp, tp = trees
    fes = {
        "torch": tserver.ServeFrontend(teng.ServeEngine(
            TCFG, tp, max_slots=2, max_len=64, device="cpu",
            metrics=tmetrics.MetricsRegistry())),
        "spec": tserver.ServeFrontend(teng.ServeEngine(
            TCFG, tp, max_slots=2, max_len=64, device="cpu", speculative=4)),
        "full": tserver.ServeFrontend(teng.ServeEngine(
            TCFG, tp, max_slots=2, max_len=64, device="cpu"), max_queue=0),
        "jax": jserver.ServeFrontend(jeng.ServeEngine(
            JCFG, jp, max_slots=2, max_len=64,
            metrics=jmetrics.MetricsRegistry())),
        "jax_full": jserver.ServeFrontend(jeng.ServeEngine(
            JCFG, jp, max_slots=2, max_len=64), max_queue=0),
    }
    started = {k: fe.serve_background() for k, fe in fes.items()}
    yield {k: url for k, (_, url) in started.items()}, fes
    for k, (srv, _) in started.items():
        _stop(srv, fes[k])


def _post(url, body, headers=None, timeout=60):
    req = urllib.request.Request(
        f"{url}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _get(url, path):
    with urllib.request.urlopen(f"{url}{path}", timeout=30) as resp:
        return resp.status, resp.headers.get("Content-Type"), \
            resp.read().decode()


def _raw_stream(url, body):
    """POST over a raw socket; returns (status line, headers, the chunked
    body's chunks as bytes)."""
    host, port = url.split("//")[1].split(":")
    data = json.dumps(body).encode()
    with socket.create_connection((host, int(port)), timeout=60) as s:
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\nConnection: close\r\n"
                  + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
        raw = b""
        while True:
            got = s.recv(65536)
            if not got:
                break
            raw += got
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:])
    chunks = []
    while True:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            assert rest == b"\r\n"
            break
        chunks.append(rest[:n])
        assert rest[n:n + 2] == b"\r\n"
        rest = rest[n + 2:]
    return lines[0], headers, chunks


def _stream_tokens(url, prompt, max_tokens=6):
    _, _, chunks = _raw_stream(url, {"prompt_tokens": prompt,
                                     "max_tokens": max_tokens,
                                     "stream": True})
    docs = [json.loads(c) for c in chunks]
    return [d["tokens"] for d in docs[:-1]], docs[-1]


# -- streaming ---------------------------------------------------------------

def test_ndjson_chunked_framing(servers):
    urls, _ = servers
    status, headers, chunks = _raw_stream(
        urls["torch"], {"prompt_tokens": PROMPTS[0], "max_tokens": 5,
                        "stream": True})
    assert status == "HTTP/1.1 200 OK"
    assert headers["Content-Type"] == "application/x-ndjson"
    assert headers["Transfer-Encoding"] == "chunked"
    assert "Content-Length" not in headers
    # As the JAX server's stream: no load headers (they ride the blocking
    # replies only).
    assert "X-TPU-Queue-Depth" not in headers
    assert all(c.endswith(b"\n") and c.count(b"\n") == 1 for c in chunks)
    docs = [json.loads(c) for c in chunks]
    assert all(set(d) == {"tokens"} for d in docs[:-1])
    final = docs[-1]
    assert set(final) == {"id", "finish_reason", "prompt_len", "num_tokens"}
    assert final["finish_reason"] == "length"
    assert final["prompt_len"] == len(PROMPTS[0])
    assert final["num_tokens"] == 5 == sum(len(d["tokens"])
                                           for d in docs[:-1])


@pytest.mark.parametrize("prompt", PROMPTS)
def test_streamed_tokens_equal_blocking_and_jax(servers, prompt):
    urls, _ = servers
    lines, final = _stream_tokens(urls["torch"], prompt)
    assert all(len(t) == 1 for t in lines)       # one a plain decode step
    streamed = [t for line in lines for t in line]
    _, _, body = _post(urls["torch"], {"prompt_tokens": prompt,
                                       "max_tokens": 6})
    _, _, jbody = _post(urls["jax"], {"prompt_tokens": prompt,
                                      "max_tokens": 6})
    assert streamed == json.loads(body)["tokens"] == \
        json.loads(jbody)["tokens"]
    assert final["num_tokens"] == 6


def test_stream_carries_runs_under_speculation(servers):
    urls, fes = servers
    prompt = [3, 4, 5, 6] * 6
    lines, final = _stream_tokens(urls["spec"], prompt, max_tokens=24)
    _, _, body = _post(urls["torch"], {"prompt_tokens": prompt,
                                       "max_tokens": 24})
    assert [t for line in lines for t in line] == json.loads(body)["tokens"]
    assert max(len(t) for t in lines) > 1         # an accepted run
    assert fes["spec"].engine.spec_stats["accepted"] > 0
    assert final["num_tokens"] == 24


def test_concurrent_streams_and_blocking_requests(servers):
    """Many streaming and blocking requests at once, with the interpreter
    switching threads often: every stream carries its request's tokens
    (the blocking answer for the same prompt), and the frontend keeps no
    waiter, stream queue or parked result afterwards."""
    urls, fes = servers
    prompts = [[7 + i, 3, 9 + i] for i in range(6)]
    got, errors = {}, []

    def client(k):
        prompt = prompts[k % len(prompts)]
        try:
            if k // len(prompts) % 2:
                _, _, body = _post(urls["torch"], {"prompt_tokens": prompt,
                                                   "max_tokens": 4})
                got[k] = json.loads(body)["tokens"]
            else:
                lines, final = _stream_tokens(urls["torch"], prompt, 4)
                assert final["num_tokens"] == 4
                got[k] = [t for line in lines for t in line]
        except Exception as e:              # reported by the assertion
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4 * len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 4 * len(prompts)
    for k, tokens in got.items():       # streamed == blocking, per prompt
        assert len(tokens) == 4 and tokens == got[k % len(prompts)]
    fe = fes["torch"]
    deadline = time.monotonic() + 10
    while (fe._streams or fe._waiters or fe._results) and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    assert not fe._streams and not fe._waiters and not fe._results


@pytest.mark.parametrize("stream", [True, False])
def test_overload_is_503_before_headers(servers, stream):
    urls, _ = servers
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(urls["full"], {"prompt_tokens": [1, 2], "stream": stream})
    assert e.value.code == 503
    assert e.value.headers["Content-Type"] == "application/json"
    assert json.loads(e.value.read())["message"] == "overloaded or timed out"


def _reply_header_names(url, body, headers=None):
    """(status, sorted header names) of one POST, an error reply's too."""
    try:
        status, got, _ = _post(url, body, headers)
    except urllib.error.HTTPError as e:
        status, got = e.code, dict(e.headers)
        e.read()
    return status, sorted(got)


@pytest.mark.parametrize("traceparent", [TRACEPARENT, None])
@pytest.mark.parametrize("port,ref,status", [
    ("torch", "jax", 200), ("full", "jax_full", 503)])
def test_stream_header_names_equal_jax(servers, port, ref, status,
                                       traceparent):
    """A streamed request's reply, served and overloaded, carries the
    JAX server's header names: Content-Type and Transfer-Encoding on the
    200, a bare 503, neither with load headers or a traceparent echo."""
    urls, _ = servers
    body = {"prompt_tokens": [4, 4, 4], "max_tokens": 2, "stream": True}
    hdrs = {"traceparent": traceparent} if traceparent else None
    got = _reply_header_names(urls[port], body, hdrs)
    want = _reply_header_names(urls[ref], body, hdrs)
    assert got == want and got[0] == status
    assert not any(n.startswith("X-TPU-") or n == "traceparent"
                   for n in got[1])


# -- /metrics ----------------------------------------------------------------

def _types(text):
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


def _series(text, name):
    """The label sets of a histogram's series lines (values dropped)."""
    return sorted(re.findall(rf"^({name}_(?:bucket|sum|count)\S*) ", text,
                             re.M))


def test_metrics_types_and_names_equal_jax(servers):
    urls, fes = servers
    for k in ("torch", "jax"):
        _post(urls[k], {"prompt_tokens": PROMPTS[1], "max_tokens": 4})
    status, ctype, text = _get(urls["torch"], "/metrics")
    assert status == 200 and ctype == "text/plain; version=0.0.4"
    _, _, jtext = _get(urls["jax"], "/metrics")
    types, jtypes = _types(text), _types(jtext)
    common = set(fes["torch"].stats()) & set(fes["jax"].stats())
    assert {"drafted", "accepted", "verify_steps", "requests",
            "completed"} <= common
    for key in common:
        name = f"tpu_serve_{key}"
        assert types[name] == jtypes[name], name
    assert types["tpu_serve_verify_steps"] == "counter"
    assert types["tpu_serve_decode_s"] == "gauge"
    assert all(n.startswith("tpu_serve_") for n in types)


def test_render_stats_matches_jax_rules():
    stats = {"requests": 3, "accepted": 2, "queue_depth": 0, "ok": True,
             "degraded": "no", "decode_s": 0.5, "prefix_hit_tokens": 16}
    text = tserver.render_stats(stats)
    assert text.splitlines() == [
        "# TYPE tpu_serve_accepted counter", "tpu_serve_accepted 2",
        "# TYPE tpu_serve_decode_s gauge", "tpu_serve_decode_s 0.5",
        "# TYPE tpu_serve_prefix_hit_tokens counter",
        "tpu_serve_prefix_hit_tokens 16",
        "# TYPE tpu_serve_queue_depth gauge", "tpu_serve_queue_depth 0",
        "# TYPE tpu_serve_requests counter", "tpu_serve_requests 3"]


def test_phase_histograms_like_jax(trees):
    """One request through each engine: the same histogram series (phases
    queue, prefill, decode and ttft, the same buckets), and the registry
    renders as the JAX package's."""
    jp, tp = trees
    treg, jreg = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    eng = teng.ServeEngine(TCFG, tp, max_slots=2, max_len=64, device="cpu",
                           metrics=treg)
    jeng_ = jeng.ServeEngine(JCFG, jp, max_slots=2, max_len=64,
                             metrics=jreg)
    eng.add_request(teng.Request("a", [1, 2, 3], max_new_tokens=3))
    jeng_.add_request(jeng.Request("a", [1, 2, 3], max_new_tokens=3))
    eng.run()
    jeng_.run()
    name = "tpu_serve_request_duration_seconds"
    text, jtext = treg.render(), jreg.render()
    assert _series(text, name) == _series(jtext, name)
    for phase in ("queue", "prefill", "decode", "ttft"):
        assert f'phase="{phase}"' in text
    assert text.splitlines()[:2] == jtext.splitlines()[:2]   # HELP, TYPE
    # The same observations render the same text (escaping, exemplar).
    for reg in (treg, jreg):
        reg.observe("x_seconds", 0.3, {"k": 'a"b\\'}, exemplar="t1",
                    exemplar_ts=5.0)
        reg.describe("x_seconds", "help\ntext")

    def x_lines(t):
        return [ln for ln in t.splitlines() if "x_seconds" in ln]
    assert x_lines(treg.render()) == x_lines(jreg.render())
    assert len(x_lines(treg.render())) == 16


# -- traceparent -------------------------------------------------------------

@pytest.mark.parametrize("header", [
    TRACEPARENT, "00-t000001-s000002-01", None, "", "garbage",
    "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00f067aa0ba902b7-01",
    "00-abc-def", "00--def-01", "00-" + "a" * 65 + "-b-01",
    "00-a-b-01" + " " * 300, " 00-abc-def-01 "])
def test_traceparent_parsed_as_jax(header):
    got = ttrace.TraceContext.from_traceparent(header)
    want = jtrace.TraceContext.from_traceparent(header)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)
        assert got.to_traceparent() == want.to_traceparent()


@pytest.mark.parametrize("header,echo", [
    (TRACEPARENT, TRACEPARENT), ("garbage", None), (None, None)])
def test_traceparent_adopted_and_echoed(servers, header, echo):
    urls, fes = servers
    for stream in (False, True):
        _, headers, _ = _post(
            urls["torch"], {"prompt_tokens": [4, 4, 4], "max_tokens": 2,
                            "stream": stream},
            headers={"traceparent": header} if header else None)
        # The blocking reply echoes it; a stream, as the JAX server's,
        # does not (its trace is still adopted: the exemplar below).
        assert headers.get("traceparent") == (None if stream else echo)
    if echo:
        _, _, text = _get(urls["torch"], "/metrics")
        assert '# {trace_id="4bf92f3577b34da6a3ce929d0e0e4736"}' in text


def test_engine_spans_like_jax(trees):
    """A traced request gets the JAX engine's spans (engine-queue, prefill,
    decode; kv-alloc in the paged engine) with the same attributes."""
    jp, tp = trees
    ctx = ttrace.TraceContext("t1", "s1")
    jctx = jtrace.TraceContext("t1", "s1")
    got = {}
    for name, make, req in (
            ("torch", lambda r: teng.ServeEngine(
                TCFG, tp, max_slots=2, max_len=64, device="cpu", tracer=r),
             teng.Request("a", [1, 2, 3], max_new_tokens=3, trace=ctx)),
            ("paged", lambda r: tpe.PagedServeEngine(
                TCFG, tp, max_slots=2, max_len=64, block_size=8,
                device="cpu", tracer=r, prefill_chunk=8),
             teng.Request("a", [1, 2, 3], max_new_tokens=3, trace=ctx)),
            ("jax", lambda r: jeng.ServeEngine(
                JCFG, jp, max_slots=2, max_len=64, tracer=r),
             jeng.Request("a", [1, 2, 3], max_new_tokens=3, trace=jctx))):
        rec = Recorder()
        eng = make(rec)
        eng.add_request(req)
        eng.run()
        got[name] = rec.spans
    assert got["torch"] == got["jax"] == [
        ("t1", "engine-queue", []), ("t1", "prefill", ["prompt_len"]),
        ("t1", "decode", ["reason", "tokens"])]
    assert got["paged"] == [("t1", "kv-alloc", ["blocks", "cached_tokens"]),
                            *got["jax"]]


# -- the server's flags ------------------------------------------------------

def test_main_serves_with_the_new_flags():
    """``python -m kuberay_tpu_torch.serve.server`` with --prefill-chunk,
    --speculative, --weight-quant and --app-name streams NDJSON, serves
    /metrics with the phase histograms, and drains on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "kuberay_tpu_torch.serve.server", "--model",
         "llama_tiny", "--paged", "--block-size", "8", "--max-slots", "2",
         "--max-len", "64", "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--prefill-chunk", "8", "--speculative", "4",
         "--weight-quant", "int8", "--app-name", "demo"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        deadline = time.monotonic() + 120
        line = ""
        while "serving" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "server exited early"
        for part in ("app demo", "weight quant int8", "prefill chunk 8",
                     "speculative 4", "paged KV cache"):
            assert part in line, line
        url = "http://" + line.split(" on ")[1].split(" ")[0]
        prompt = [3, 4, 5, 6] * 5
        lines, final = _stream_tokens(url, prompt, max_tokens=12)
        _, _, body = _post(url, {"prompt_tokens": prompt, "max_tokens": 12})
        assert [t for ln in lines for t in ln] == json.loads(body)["tokens"]
        assert final["num_tokens"] == 12
        _, _, text = _get(url, "/metrics")
        assert _types(text)["tpu_serve_request_duration_seconds"] == \
            "histogram"
        for phase in ("queue", "prefill", "decode"):
            assert re.search(r'^tpu_serve_request_duration_seconds_bucket\{'
                             rf'phase="{phase}",le="[^"]+"\}} [1-9]', text,
                             re.M), phase
        assert int(re.search(r"^tpu_serve_verify_steps (\d+)", text,
                             re.M)[1]) > 0
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_new_options_raise_without_a_card(trees, monkeypatch):
    """The serving options keep the port's ground rule: without a card the
    engines and ``main`` raise unless given the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = trees
    opts = dict(weight_quant="int8", prefill_chunk=8, speculative=4,
                metrics=tmetrics.MetricsRegistry())
    for cls in (teng.ServeEngine, tpe.PagedServeEngine):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(TCFG, tp, max_slots=1, max_len=16, **opts)
        assert cls(TCFG, tp, max_slots=1, max_len=16, device="cpu",
                   **opts).device.type == "cpu"
    for extra in (["--weight-quant", "int8"],
                  ["--paged", "--prefill-chunk", "8", "--speculative", "4",
                   "--app-name", "x"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserver.main(["--model", "llama_tiny", "--port", "0", *extra])


@pytest.mark.parametrize("argv", [["--weight-quant", "int4"],
                                  ["--speculative", "x"],
                                  ["--prefill-chunk", "1.5"]])
def test_main_rejects_bad_flags(argv):
    with pytest.raises(SystemExit) as e:
        tserver.main(["--model", "llama_tiny", "--device", "cpu", *argv])
    assert e.value.code == 2
