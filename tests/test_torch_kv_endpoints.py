"""PyTorch port, the server's KV surface against the JAX server: the five
KV load headers, ``/v1/kv/advert`` and ``/v1/kv/resident|export|import``
(status codes and bodies, on paged, tiered, int8-pool and dense engines),
and port replicas behind the JAX package's ``WeightedGateway``: session
resumes through the tiers (the cases of ``tests/test_kv_sessions.py``)
and the disaggregated prefill -> decode handoff.

Both servers run over real sockets on 127.0.0.1; the JAX engines run with
``decode_impl="xla"`` on the same converted ``llama_tiny`` tree.
"""

import base64
import json
import random
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kuberay_tpu.controlplane.store import ObjectStore
from kuberay_tpu.models import llama as jllama
from kuberay_tpu.serve import engine as jeng
from kuberay_tpu.serve import paged_engine as jpe
from kuberay_tpu.serve import server as jserver
from kuberay_tpu.serve.gateway import GatewayConfig, WeightedGateway
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.serve import engine as teng
from kuberay_tpu_torch.serve import server as tserver
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine

torch.set_num_threads(2)

JCFG = jllama.CONFIGS["llama_tiny"]
TCFG = tllama.CONFIGS["llama_tiny"]
BS = 8
PROMPT = list(range(1, 25))                      # 3 full blocks, in-vocab
KV_HEADERS = ("X-TPU-Queue-Depth", "X-TPU-Active-Slots",
              "X-TPU-KV-Free-Blocks", "X-TPU-KV-Total-Blocks",
              "X-TPU-KV-Advert-Seq", "X-TPU-KV-Host-Free-Blocks",
              "X-TPU-KV-Host-Total-Blocks")


@pytest.fixture(scope="module")
def trees():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")


def _engine(pkg, trees, kind, **kw):
    """One engine of ``pkg`` ("jax" or "torch"): "dense", "paged",
    "tiered" (host 64 blocks, spill 4) or "int8" (a paged int8 pool)."""
    jp, tp = trees
    base = dict(max_slots=2, max_len=64, **kw)
    paged = dict(block_size=BS, **({"host_blocks": 64, "spill_blocks": 4}
                                   if kind == "tiered" else {}),
                 **({"kv_quant": "int8"} if kind == "int8" else {}))
    if pkg == "jax":
        if kind == "dense":
            return jeng.ServeEngine(JCFG, jp, **base)
        return jpe.PagedServeEngine(JCFG, jp, decode_impl="xla", **base,
                                    **paged)
    if kind == "dense":
        return teng.ServeEngine(TCFG, tp, device="cpu", **base)
    return PagedServeEngine(TCFG, tp, device="cpu", **base, **paged)


def _request(pkg, rid, prompt, n):
    cls = jeng.Request if pkg == "jax" else teng.Request
    return cls(rid, list(prompt), max_new_tokens=n)


class _Served:
    """An engine behind its package's frontend on 127.0.0.1."""

    def __init__(self, pkg, engine):
        mod = jserver if pkg == "jax" else tserver
        self.engine = engine
        self.frontend = mod.ServeFrontend(engine)
        self.srv, self.url = self.frontend.serve_background()

    def call(self, method, path, body=None, raw=None):
        """(status, JSON body, headers) of one request."""
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        req = urllib.request.Request(
            self.url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, json.load(resp), dict(resp.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e), dict(e.headers)

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.frontend.close()


def _kv(headers):
    return {k: v for k, v in headers.items() if k in KV_HEADERS}


def _warm(pkg, engine):
    """The same history on every engine: two prompts, the second sharing
    PROMPT's first two blocks."""
    engine.add_request(_request(pkg, "a", PROMPT, 3))
    engine.run()
    engine.add_request(_request(pkg, "b", PROMPT[:16] + [90, 91, 92], 2))
    engine.run()


@pytest.fixture(scope="module", params=["dense", "paged", "tiered", "int8"])
def pair(request, trees):
    """The JAX and the port server, each on its engine of one kind, after
    the same history."""
    served = []
    for pkg in ("jax", "torch"):
        eng = _engine(pkg, trees, request.param)
        _warm(pkg, eng)
        served.append(_Served(pkg, eng))
    yield request.param, served[0], served[1]
    for s in served:
        s.close()


# ---------------------------------------------------------------------------
# the load headers (the repaired fault) and the endpoints
# ---------------------------------------------------------------------------

def test_load_headers_equal_the_jax_servers(pair):
    kind, jsrv, tsrv = pair
    body = {"prompt_tokens": [5, 6, 7], "max_tokens": 2}
    got = [s.call("POST", "/v1/completions", body) for s in (jsrv, tsrv)]
    assert got[0][0] == got[1][0] == 200
    assert got[0][1]["tokens"] == got[1][1]["tokens"]
    jh, th = _kv(got[0][2]), _kv(got[1][2])
    assert th == jh
    want = {"dense": 2, "paged": 4, "int8": 4, "tiered": 7}[kind]
    assert len(th) == want
    if kind == "tiered":
        assert int(th["X-TPU-KV-Advert-Seq"]) > 0
        assert th["X-TPU-KV-Host-Total-Blocks"] == "64"


BAD_CALLS = [
    ("GET", "/v1/kv/advert?since=x", None, None),
    ("POST", "/v1/kv/resident", {}, None),
    ("POST", "/v1/kv/resident", {"prompt_tokens": []}, None),
    ("POST", "/v1/kv/export", {"prompt_tokens": [1.5]}, None),
    ("POST", "/v1/kv/import", None, b"{not json"),
    ("POST", "/v1/kv/export", {"prompt_tokens": PROMPT,
                               "skip_blocks": "x"}, None),
    ("POST", "/v1/kv/import", {"prompt_tokens": PROMPT, "blocks": "x"},
     None),
]


@pytest.mark.parametrize("method,path,body,raw", BAD_CALLS)
def test_bad_kv_calls_answer_as_the_jax_server(pair, method, path, body,
                                               raw):
    _, jsrv, tsrv = pair
    got = [s.call(method, path, body, raw)[:2] for s in (jsrv, tsrv)]
    assert got[1] == got[0]
    assert got[1][0] in (400, 501)


def test_kv_calls_answer_as_the_jax_server(pair):
    kind, jsrv, tsrv = pair
    calls = [("GET", "/v1/kv/advert?since=0", None),
             ("GET", "/v1/kv/advert?since=3", None),
             ("POST", "/v1/kv/resident", {"prompt_tokens": PROMPT}),
             ("POST", "/v1/kv/export", {"prompt_tokens": PROMPT,
                                        "skip_blocks": 1}),
             ("POST", "/v1/kv/import", {"prompt_tokens": PROMPT,
                                        "blocks": []})]
    for method, path, body in calls:
        (js, jb, _), (ts, tb, _) = (s.call(method, path, body)
                                    for s in (jsrv, tsrv))
        assert ts == js, (path, tb, jb)
        if path == "/v1/kv/export" and ts == 200:
            assert tb["block_size"] == jb["block_size"] == BS
            assert [(b["index"], b["hash"]) for b in tb["blocks"]] == \
                [(b["index"], b["hash"]) for b in jb["blocks"]]
            for tblk, jblk in zip(tb["blocks"], jb["blocks"]):
                for n in ("k", "v"):
                    np.testing.assert_allclose(
                        np.frombuffer(base64.b64decode(tblk[n]), "<f4"),
                        np.frombuffer(base64.b64decode(jblk[n]), "<f4"),
                        rtol=0, atol=1e-5)
        else:
            assert tb == jb, path
    expect = {"dense": 501, "paged": 200, "tiered": 200, "int8": 200}[kind]
    assert tsrv.call("POST", "/v1/kv/resident",
                     {"prompt_tokens": PROMPT})[0] == expect


def test_export_then_import_over_http_serves_the_cold_tokens(trees):
    """The gateway's three calls by hand, in its order, from a port
    prefill replica to a port decode replica."""
    pf = _Served("torch", _engine("torch", trees, "paged"))
    de = _Served("torch", _engine("torch", trees, "paged"))
    cold = _engine("torch", trees, "paged")
    cold.add_request(_request("torch", "c", PROMPT, 6))
    want = cold.run()[0].tokens
    try:
        assert pf.call("POST", "/v1/completions",
                       {"prompt_tokens": PROMPT, "max_tokens": 1})[0] == 200
        res = de.call("POST", "/v1/kv/resident",
                      {"prompt_tokens": PROMPT})[1]["resident_blocks"]
        blocks = pf.call("POST", "/v1/kv/export",
                         {"prompt_tokens": PROMPT,
                          "skip_blocks": res})[1]["blocks"]
        assert de.call("POST", "/v1/kv/import",
                       {"prompt_tokens": PROMPT, "blocks": blocks})[1] == \
            {"imported": 3, "skipped": 0}
        _, body, headers = de.call("POST", "/v1/completions",
                                   {"prompt_tokens": PROMPT,
                                    "max_tokens": 6})
        assert body["tokens"] == want
        assert de.engine.stats["prefix_hit_tokens"] == 2 * BS
        assert headers["X-TPU-KV-Total-Blocks"] == str(de.engine.num_blocks)
        again = pf.call("POST", "/v1/kv/export",
                        {"prompt_tokens": PROMPT, "skip_blocks": 3})[1]
        assert again["blocks"] == []
    finally:
        pf.close()
        de.close()


def test_call_engine_runs_on_the_loop_thread_and_raises(trees):
    served = _Served("torch", _engine("torch", trees, "paged"))
    try:
        fe = served.frontend
        assert fe.call_engine(lambda e: __import__(
            "threading").current_thread().name) == "serve-engine-loop"
        with pytest.raises(KeyError):
            fe.call_engine(lambda e: {}["missing"])
    finally:
        served.close()


def test_call_engine_times_out_when_the_loop_is_stopped(trees):
    served = _Served("torch", _engine("torch", trees, "paged"))
    served.close()
    with pytest.raises(TimeoutError):
        served.frontend.call_engine(lambda e: 1, timeout=0.2)


def test_tier_flags_reach_the_paged_engine(monkeypatch):
    """--host-blocks / --spill-blocks go to PagedServeEngine as the JAX
    server passes them."""
    seen = {}

    class Stop(Exception):
        pass

    def fake(cfg, params, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(tserver, "PagedServeEngine", fake)
    with pytest.raises(Stop):
        tserver.main(["--model", "llama_tiny", "--device", "cpu", "--paged",
                      "--block-size", "8", "--host-blocks", "32",
                      "--spill-blocks", "4"])
    assert (seen["host_blocks"], seen["spill_blocks"]) == (32, 4)


# ---------------------------------------------------------------------------
# port replicas behind the JAX gateway
# ---------------------------------------------------------------------------

def _route(store, backends, name):
    store.create({
        "apiVersion": "tpu.dev/v1", "kind": "TrafficRoute",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"backends": backends}, "status": {}})


class _Fleet:
    """Tiered replicas of one package behind one WeightedGateway (as
    tests/test_kv_sessions.py's fleet)."""

    def __init__(self, pkg, trees, services, tiers=None):
        self.pkg = pkg
        self.served = {}
        for svc in services:
            eng = _engine(pkg, trees, "tiered")
            self.served[svc] = _Served(pkg, eng)
        store = ObjectStore()
        _route(store, [{"service": s, "weight": 1,
                        **({"tier": tiers[s]} if tiers else {})}
                       for s in services], "route")
        urls = {s: v.url for s, v in self.served.items()}
        self.gateway = WeightedGateway(
            store, "route", resolver=lambda s: urls[s], poll_interval=0.05,
            rng=random.Random(0),
            config=GatewayConfig(epsilon=0.0, block_size=BS))
        time.sleep(0.1)                          # first route poll

    def turn(self, prompt, sid=None, max_tokens=4):
        doc = {"prompt_tokens": list(prompt), "max_tokens": max_tokens,
               "temperature": 0.0}
        if sid is not None:
            doc["session"] = sid
        code, payload, _ = self.gateway.forward_ex(
            "/v1/completions", json.dumps(doc).encode(), 120.0)
        return code, json.loads(payload)

    def engine_call(self, svc, fn):
        return self.served[svc].frontend.call_engine(fn)

    def prefill_tokens(self, svc):
        st = self.engine_call(svc, lambda e: dict(e.stats))
        return st["prefix_query_tokens"] - st["prefix_hit_tokens"]

    def evict_device(self, svc):
        """Cannibalise every cached device block with in-vocab junk posted
        straight to the replica (the gateway never sees it)."""
        served = self.served[svc]
        eng = served.engine
        plen = (eng.max_blocks - 1) * BS
        for j in range(eng.num_blocks // (eng.max_blocks - 1) + 1):
            toks = [(30 + j * plen + i) % 231 + 25 for i in range(plen)]
            assert served.call("POST", "/v1/completions",
                               {"prompt_tokens": toks,
                                "max_tokens": 1})[0] == 200

    def close(self):
        self.gateway.close()
        for s in self.served.values():
            s.close()


def _session_run(pkg, trees, evict):
    """Turn 1, pump, (device eviction), turn 2 of one session; the
    replica's counters between them."""
    fleet = _Fleet(pkg, trees, ["replica-0"])
    try:
        code, doc = fleet.turn(PROMPT, "s1")
        assert code == 200
        fleet.engine_call("replica-0",
                          lambda e: e._pump_demotions(limit=1 << 20))
        if evict:
            fleet.evict_device("replica-0")
            assert fleet.engine_call(
                "replica-0", lambda e: e.resident_prefix_blocks(PROMPT)) == 0
        fetched0 = fleet.engine_call("replica-0",
                                     lambda e: e.tier_fetch_blocks)
        p0 = fleet.prefill_tokens("replica-0")
        turn2 = PROMPT + doc["tokens"] + list(range(30, 38))
        code, doc2 = fleet.turn(turn2, "s1")
        assert code == 200
        return {"tokens": (doc["tokens"], doc2["tokens"]),
                "resumes": fleet.gateway.session_stats()["session_resumes"],
                "prefilled": fleet.prefill_tokens("replica-0") - p0,
                "fetched": fleet.engine_call(
                    "replica-0", lambda e: e.tier_fetch_blocks) - fetched0,
                "turn2_len": len(turn2)}
    finally:
        fleet.close()


@pytest.mark.parametrize("evict", [False, True],
                         ids=["sticks_and_skips_prefill",
                              "promotes_from_host_tier"])
def test_session_resume_like_jax(trees, evict):
    ours, ref = (_session_run(pkg, trees, evict) for pkg in ("torch", "jax"))
    assert ours == ref
    assert ours["resumes"] == 1
    assert ours["prefilled"] < ours["turn2_len"] - BS
    if evict:
        assert ours["fetched"] >= 3


def test_disaggregated_handoff_through_the_jax_gateway(trees):
    """Two port replicas tiered prefill / decode: the gateway's two-hop
    forward ships the prompt's blocks and the answer is the colocated
    one's; a second pass of the same prompt ships nothing."""
    cold = _engine("torch", trees, "paged")
    cold.add_request(_request("torch", "c", PROMPT, 6))
    want = cold.run()[0].tokens
    fleet = _Fleet("torch", trees, ["pf", "de"],
                   tiers={"pf": "prefill", "de": "decode"})
    try:
        code, doc = fleet.turn(PROMPT, max_tokens=6)
        assert code == 200, doc
        assert doc["disagg"]["prefill"] == "pf"
        assert doc["disagg"]["decode"] == "de"
        assert doc["disagg"]["kv_sent"] == 3 and doc["tokens"] == want
        hits = fleet.engine_call("de", lambda e: e.stats["prefix_hit_tokens"])
        assert hits >= 3 * BS
        code, doc = fleet.turn(PROMPT, max_tokens=6)
        assert code == 200 and doc["tokens"] == want
        assert doc["disagg"]["kv_sent"] == 0
        assert doc["disagg"]["kv_skipped"] == 3
    finally:
        fleet.close()
