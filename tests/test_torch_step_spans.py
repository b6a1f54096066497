"""PyTorch port, step spans: the engines' ``engine-step`` trees and the
train step's phases (``obs/trace.py``'s ``span``), on the CPU at
``llama_tiny``.

- One ``engine-step`` root a ``step()``, each child where the engines put
  it (``step-admit`` over ``prefill-enqueue`` and ``prefill-sync``;
  ``step-decode`` over ``decode-enqueue``, ``decode-sync`` and
  ``decode-emit``), for ``ServeEngine`` and ``PagedServeEngine``.
- Each ``decode-enqueue``'s ``step`` is the engine's ``decode_steps``
  after that call, and the enqueue and sync spans lie inside stamps
  taken around the device funnels' calls (one clock,
  ``time.perf_counter``).
- ``trace_records``' self times of a step sum to its duration.
- The no-op tracer records nothing and enters no profiler range unless a
  capture runs; under a CPU ``torch.profiler`` capture both tracers leave
  ``user_annotation`` events named as the spans, the train step's phases
  among them.
- Chunked and speculative engines get their enqueue and sync spans under
  ``step-chunk`` and ``step-verify``.
- The launcher's MFU gauge: the peak by the device's name (or
  ``TPU_PEAK_TFLOPS``) and 6 N + 12 L d S FLOPs a token.
"""

import contextlib
import json
import os
import tempfile
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kuberay_tpu_torch import bench
from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.obs import trace as ttrace
from kuberay_tpu_torch.obs.profile import trace_records
from kuberay_tpu_torch.serve.engine import Request, ServeEngine
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine
from kuberay_tpu_torch.train import launcher
from kuberay_tpu_torch.train import train_step as tts
from kuberay_tpu_torch.utils.metrics import MetricsRegistry

torch.set_num_threads(2)

CFG = llama.CONFIGS["llama_tiny"]
# Three prompts into two slots: admissions in two steps, a shared 8-token
# block prefix for the paged engine's cache.
PROMPTS = [list(range(1, 6)), list(range(1, 13)), list(range(1, 20))]


@pytest.fixture(scope="module")
def params():
    return llama.init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _engine(params, paged, tracer=None, **kw):
    if paged:
        return PagedServeEngine(CFG, params, max_slots=2, max_len=64,
                                block_size=8, device="cpu", tracer=tracer,
                                **kw)
    return ServeEngine(CFG, params, max_slots=2, max_len=64, device="cpu",
                       tracer=tracer, **kw)


def _drive(eng, prompts=PROMPTS, n=4) -> int:
    for i, p in enumerate(prompts):
        eng.add_request(Request(f"r{i}", list(p), max_new_tokens=n))
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
    return steps


def _roots(tracer):
    return [s for s in ttrace.span_tree(tracer.export())
            if s["name"] == "engine-step"]


def _walk(node):
    yield node
    for c in node["children"]:
        yield from _walk(c)


def _names(nodes):
    return [n["name"] for n in nodes]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_one_engine_step_root_a_step(params, paged):
    tr = ttrace.Tracer()
    steps = _drive(_engine(params, paged, tr))
    roots = _roots(tr)
    assert len(roots) == steps
    assert all(r["parent_id"] == "" for r in roots)
    assert len({r["trace_id"] for r in roots}) == steps
    starts = [r["start"] for r in roots]
    assert starts == sorted(starts)
    assert all(a["end"] <= b["start"] for a, b in zip(roots, roots[1:]))
    # Every span of the run hangs under a step: no other roots.
    assert len(ttrace.span_tree(tr.export())) == steps


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_each_child_where_the_tree_puts_it(params, paged):
    tr = ttrace.Tracer()
    _drive(_engine(params, paged, tr))
    admits = decodes = 0
    for root in _roots(tr):
        assert set(_names(root["children"])) <= {"step-admit",
                                                  "step-decode"}
        for child in root["children"]:
            if child["name"] == "step-admit":
                admits += 1
                assert _names(child["children"]) == ["prefill-enqueue",
                                                     "prefill-sync"]
            else:
                decodes += 1
                assert _names(child["children"]) == [
                    "decode-enqueue", "decode-sync", "decode-emit"]
        for node in _walk(root):
            assert node["start"] <= node["end"]
            assert node["attrs"]["cpu_s"] >= 0.0
            for c in node["children"]:
                assert node["start"] <= c["start"] <= c["end"] <= \
                    node["end"]
    assert admits == len(PROMPTS)
    assert decodes >= 3


def _stamp_funnels(eng):
    """Wrap the engine's prefill and decode funnels: each call's
    ``time.perf_counter`` before and after, and ``decode_steps`` after."""
    calls = {"prefill": [], "decode": []}
    prefill, decode = eng._prefill, eng._decode_call

    def stamped_prefill(*args, **kw):
        t0 = time.perf_counter()
        tok = prefill(*args, **kw)
        calls["prefill"].append((t0, time.perf_counter()))
        return tok

    def stamped_decode(*args):
        t0 = time.perf_counter()
        toks = decode(*args)
        calls["decode"].append((t0, time.perf_counter(), eng.decode_steps))
        return toks

    eng._prefill, eng._decode_call = stamped_prefill, stamped_decode
    return calls


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spans_lie_inside_the_funnel_calls(params, paged):
    tr = ttrace.Tracer()
    eng = _engine(params, paged, tr)
    calls = _stamp_funnels(eng)
    _drive(eng)
    spans = tr.export()

    def named(name):
        return sorted((s for s in spans if s["name"] == name),
                      key=lambda s: s["start"])

    assert len(named("step-admit")) == len(calls["prefill"]) == len(PROMPTS)
    # The shared clock: each funnel's enqueue and sync lie inside the
    # stamps taken around the same call.
    for kind in ("prefill", "decode"):
        for phase in ("enqueue", "sync"):
            got = named(f"{kind}-{phase}")
            assert len(got) == len(calls[kind])
            assert all(c[0] <= s["start"] <= s["end"] <= c[1]
                       for s, c in zip(got, calls[kind]))
    # ``step`` is what ``decode_steps`` reads once the call is done.
    assert [s["attrs"]["step"] for s in named("decode-enqueue")] == \
        [c[2] for c in calls["decode"]] == \
        list(range(1, eng.decode_steps + 1))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_self_times_sum_to_the_step(params, paged):
    tr = ttrace.Tracer()
    _drive(_engine(params, paged, tr))
    records = trace_records(tr.export(), {"engine-step": "serve-step"})
    assert len(records) == len(_roots(tr))
    kinds = set()
    for rec in records:
        assert sum(rec["self_s"].values()) == pytest.approx(
            rec["duration_s"], rel=1e-9, abs=1e-12)
        kinds |= set(rec["self_s"])
    assert {"prefill-enqueue", "prefill-sync", "decode-enqueue",
            "decode-sync", "decode-emit"} <= kinds


def test_tracer_span_parents_clock_and_errors():
    tr = ttrace.Tracer()
    ctx = tr.start_request("serve-request")
    t0 = time.perf_counter()
    with tr.span(ctx, "outer", a=1) as outer:
        with tr.span(None, "inner"):
            sum(range(20000))
    with pytest.raises(ValueError):
        with tr.span(None, "failing"):
            raise ValueError("boom")
    t1 = time.perf_counter()
    tr.finish_request(ctx)
    spans = {s["name"]: s for s in tr.export()}
    assert spans["outer"]["parent_id"] == ctx.span_id
    assert spans["outer"]["trace_id"] == ctx.trace_id
    assert spans["inner"]["parent_id"] == outer.span_id
    assert spans["outer"]["attrs"]["a"] == 1
    assert set(spans["inner"]["attrs"]) == {"cpu_s"}
    assert t0 <= spans["outer"]["start"] <= spans["inner"]["start"] <= \
        spans["inner"]["end"] <= spans["outer"]["end"] <= t1
    assert 0.0 <= spans["inner"]["attrs"]["cpu_s"] <= \
        spans["outer"]["attrs"]["cpu_s"]
    assert spans["failing"]["parent_id"] == ""
    assert spans["failing"]["status"] == "error"
    assert "boom" in spans["failing"]["error"]
    # The request root extends to its last child's end.
    assert spans["serve-request"]["end"] >= spans["outer"]["end"]


def test_threads_nest_their_own_spans():
    """Threads share the store and the ids but never a parent: under a
    short switch interval, each thread's spans nest under its own, and
    no span or id is lost."""
    import sys
    import threading

    tr = ttrace.Tracer(max_spans=1 << 16)
    n_threads, n_steps = 12, 60

    def work(k):
        for i in range(n_steps):
            with tr.span(None, "engine-step", thread=k):
                with tr.span(None, "step-decode", thread=k, i=i):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    spans = tr.export()
    assert len(spans) == 2 * n_threads * n_steps
    assert len({s["span_id"] for s in spans}) == len(spans)
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if s["name"] == "engine-step"]
    assert len({s["trace_id"] for s in roots}) == n_threads * n_steps
    for s in spans:
        if s["name"] == "step-decode":
            parent = by_id[s["parent_id"]]
            assert parent["name"] == "engine-step"
            assert parent["attrs"]["thread"] == s["attrs"]["thread"]
            assert parent["trace_id"] == s["trace_id"]
            assert "i" in s["attrs"] and "i" not in parent["attrs"]


def test_noop_tracer_records_nothing_and_enters_no_range(params,
                                                         monkeypatch):
    def refuse(name):
        raise AssertionError(f"range {name} entered with no capture")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    noop = ttrace.NOOP_TRACER
    assert noop.span(None, "x") is noop.span(None, "y")
    eng = _engine(params, True)
    assert eng._tracer is noop
    assert _drive(eng) >= 3
    assert not hasattr(noop, "store")


def _user_annotations(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return [e for e in events if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("traced", [False, True], ids=["noop", "tracer"])
def test_both_tracers_leave_ranges_under_a_capture(params, traced):
    tr = ttrace.Tracer() if traced else None
    eng = _engine(params, True, tr)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps = _drive(eng)
    ranges = _user_annotations(prof)
    names = {e["name"] for e in ranges}
    assert {"engine-step", "step-admit", "prefill-enqueue", "prefill-sync",
            "step-decode", "decode-enqueue", "decode-sync",
            "decode-emit"} <= names
    assert sum(e["name"] == "engine-step" for e in ranges) == steps
    if traced:
        assert len(_roots(tr)) == steps


def _train_batch(seed):
    toks = torch.randint(0, CFG.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks, "targets": torch.roll(toks, -1, 1)}


@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
def test_train_step_phases_under_a_capture(accum):
    tc = tts.TrainConfig(warmup_steps=1, decay_steps=10, grad_accum=accum)
    opt = tts.make_optimizer(tc)
    state = tts.init_train_state(CFG, opt, torch.Generator().manual_seed(0),
                                 device="cpu")
    step = tts.make_train_step(CFG, tc, opt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, m = step(state, _train_batch(1))
    names = [e["name"] for e in _user_annotations(prof)]
    for phase, n in (("train-iteration", 1), ("train-forward", accum),
                     ("train-backward", accum), ("train-optimizer", 1)):
        assert names.count(phase) == n, phase
    assert "train-grad-sync" not in names
    assert torch.isfinite(m["total_loss"])


def test_train_step_outside_a_capture_is_unchanged():
    """The ranges change nothing the step computes: two steps under a
    capture and two outside one give the same state bit for bit."""
    tc = tts.TrainConfig(warmup_steps=1, decay_steps=10)
    batch = _train_batch(2)
    outs = []
    for captured in (False, True):
        opt = tts.make_optimizer(tc)
        state = tts.init_train_state(
            CFG, opt, torch.Generator().manual_seed(0), device="cpu")
        step = tts.make_train_step(CFG, tc, opt)
        with profile(activities=[ProfilerActivity.CPU]) if captured \
                else contextlib.nullcontext():
            for _ in range(2):
                state, _ = step(state, batch)
        outs.append(state["params"])
    for a, b in zip(tts.tree_leaves(outs[0]), tts.tree_leaves(outs[1])):
        assert torch.equal(a, b)


def test_chunked_engine_gets_enqueue_and_sync_under_step_chunk(params):
    tr = ttrace.Tracer()
    eng = _engine(params, True, tr, prefill_chunk=8)
    _drive(eng)
    chunks = [n for r in _roots(tr) for n in r["children"]
              if n["name"] == "step-chunk"]
    # 5, 12 and 19 prompt tokens in chunks of 8: 1 + 2 + 2 chunks (the
    # third request's first block is served from the cache).
    assert len(chunks) >= 4
    for c in chunks:
        assert _names(c["children"]) == ["prefill-enqueue", "prefill-sync"]
    # Every chunk's prefill ran in one of them.
    assert len(chunks) == eng.prefills


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_speculative_engine_gets_verify_spans(params, paged):
    tr = ttrace.Tracer()
    eng = _engine(params, paged, tr, speculative=2)
    _drive(eng, prompts=[[3, 4, 5] * 6, [7, 8] * 8], n=12)
    assert eng.spec_stats["verify_steps"] > 0
    verifies = [n for r in _roots(tr) for n in _walk(r)
                if n["name"] == "step-verify"]
    assert len(verifies) == eng.spec_stats["verify_steps"]
    for v in verifies:
        assert _names(v["children"]) == ["verify-enqueue", "verify-sync",
                                         "verify-emit"]
    parents = {n["span_id"]: n["name"] for r in _roots(tr)
               for n in _walk(r)}
    assert all(parents[v["parent_id"]] == "step-decode" for v in verifies)


# -- the launcher's MFU gauge ------------------------------------------------

@pytest.mark.parametrize("name,env,want", [
    ("NVIDIA H100 80GB HBM3", {}, 989.0),
    ("NVIDIA H100 PCIe", {}, 756.0),
    ("some other card", {}, 0.0),
    ("NVIDIA H100 80GB HBM3", {"TPU_PEAK_TFLOPS": "500"}, 500.0),
    ("NVIDIA H100 80GB HBM3", {"TPU_PEAK_TFLOPS": ""}, 989.0),
])
def test_gauge_peak_from_the_device_name(monkeypatch, name, env, want):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert launcher.card_peak_tflops(torch.device("cuda"), env) == want


def test_gauge_peak_on_the_cpu_only_from_the_env():
    assert launcher.card_peak_tflops(torch.device("cpu"), {}) == 0.0
    assert launcher.card_peak_tflops(
        torch.device("cpu"), {"TPU_PEAK_TFLOPS": "989"}) == 989.0


def test_mfu_gauge_counts_attention_flops(capsys):
    """The loop's gauge: 6 N + 12 L d S FLOPs a token over the peak."""
    n_params, seq, batch = 1_000_000, 512, 4
    per_token = bench.flops_per_token(CFG, n_params, seq)
    assert per_token == 6 * n_params + 12 * CFG.n_layers * CFG.d_model * seq
    reg = MetricsRegistry()
    tel = launcher._Telemetry(events=None, prom=reg, job_id="j",
                              n_params=n_params, flops_per_token=per_token,
                              peak_tflops=989.0)

    class Loader:
        def next(self):
            import numpy as np
            z = np.zeros((batch, seq), np.int32)
            return {"tokens": z, "targets": z}

    def step_fn(state, b):
        time.sleep(0.01)
        return state, {"loss": torch.tensor(1.0)}

    args = types.SimpleNamespace(steps=2, log_every=2, batch=batch,
                                 seq_len=seq, heartbeat_every=0,
                                 checkpoint_every=100)
    ident = launcher.WorkerIdentity(0, 1, [], "", "")
    assert launcher._train_loop(args, ident, {"step": 0}, step_fn, Loader(),
                                None, tel, torch.device("cpu"),
                                lambda t: t) == 0
    capsys.readouterr()
    gauges = {}
    for ln in reg.render().splitlines():
        if ln.startswith("tpu_train_"):
            k, v = ln.split()
            gauges[k] = float(v)
    want = per_token * gauges["tpu_train_tokens_per_sec"] / 1e12 / 989.0
    assert gauges["tpu_train_mfu"] == pytest.approx(want, rel=1e-6)
    assert gauges["tpu_train_mfu"] > 6 * n_params * gauges[
        "tpu_train_tokens_per_sec"] / 1e12 / 989.0
