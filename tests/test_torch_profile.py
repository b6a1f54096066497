"""PyTorch port, span tracing and profiles vs the JAX package's
``obs/trace.py`` and ``obs/profile.py``, and the bench's ``--profile-out``.

- ``profile_spans`` (and ``trace_records``, ``aggregate``, ``span_kind``)
  on the same span lists as JAX's: the same document, compared as
  ``json.dumps(..., sort_keys=True)``, also with the spans in reverse
  order (``tests/test_profile.py``'s cases among them).
- The copied ``Tracer`` against JAX's under one fixed clock: the same
  calls export the same spans (ids included: both count), the same
  ``span_tree``, and the same ``SpanStore`` eviction.
- ``python -m kuberay_tpu_torch.bench --cpu --profile-out PATH`` writes a
  ``tpu-profile/v1`` document whose structure (keys, shapes, kinds,
  counts, the types of the numbers) equals the JAX ``bench.py``'s.
- A port ``ServeEngine`` and ``PagedServeEngine`` given the copied
  ``Tracer`` record the JAX engines' span names for the same requests.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

import bench as jbench
from kuberay_tpu.models import llama as jllama
from kuberay_tpu.obs import profile as jprof
from kuberay_tpu.obs import trace as jtrace
from kuberay_tpu.serve.engine import Request as JRequest
from kuberay_tpu.serve.engine import ServeEngine as JServeEngine
from kuberay_tpu.serve.paged_engine import PagedServeEngine as JPagedEngine
from kuberay_tpu_torch import bench
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.obs import profile as tprof
from kuberay_tpu_torch.obs import trace as ttrace
from kuberay_tpu_torch.serve.engine import Request, ServeEngine
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine

torch.set_num_threads(2)


def _span(trace_id, span_id, parent_id, name, start, end):
    return {"trace_id": trace_id, "span_id": span_id,
            "parent_id": parent_id, "name": name,
            "start": start, "end": end}


def _many_traces():
    """Four serve traces whose decode grows, two train steps, a slice-ready
    window with chain siblings, an orphan and an open root."""
    spans = []
    for i in range(4):
        t0 = 10.0 * i
        spans += [
            _span(f"t{i}", f"r{i}", "", "serve-request", t0, t0 + 4.0),
            _span(f"t{i}", f"p{i}", f"r{i}", "prefill", t0, t0 + 1.0),
            _span(f"t{i}", f"d{i}", f"r{i}", "decode", t0 + 1.0,
                  t0 + 3.0 + i * 0.25),
        ]
    for i in range(2):
        t0 = 100.0 + i
        spans += [
            _span(f"b{i}", f"s{i}", "", "train-step", t0, t0 + 0.9),
            _span(f"b{i}", f"x{i}", f"s{i}", "dispatch", t0, t0 + 0.1),
            _span(f"b{i}", f"h{i}", f"s{i}", "host-fetch", t0 + 0.1,
                  t0 + 0.9),
        ]
    spans += [
        _span("c", "root", "", "slice-ready", 10.0, 20.0),
        _span("c", "a", "", "pod-start", 5.0, 14.0),
        _span("c", "b", "", "queue-wait", 30.0, 40.0),
        _span("c", "e", "", "error:coordinator", 12.0, 12.0),
        _span("c", "ch", "", "chain:TpuCluster/default/x", 0.0, 50.0),
        _span("o", "orphan", "gone", "decode", 1.0, 2.0),
        _span("o", "open", "", "serve-request", 1.0, None),
    ]
    return spans


SPAN_CASES = {
    "serve_window": [
        _span("t1", "root", "", "serve-request", 0.0, 10.0),
        _span("t1", "q", "root", "gateway-queue", 0.0, 2.0),
        _span("t1", "f", "root", "forward", 2.0, 9.0),
        _span("t1", "p", "f", "prefill", 2.0, 4.0),
        _span("t1", "d", "f", "decode", 4.0, 8.0)],
    "overlapping_siblings": [
        _span("t1", "root", "", "serve-request", 0.0, 10.0),
        _span("t1", "a", "root", "prefill", 1.0, 6.0),
        _span("t1", "b", "root", "decode", 3.0, 9.0)],
    "zero_window": [_span("t1", "root", "", "slice-ready", 5.0, 5.0)],
    "many": _many_traces(),
}
ROOTS = [None, {"train-step": "train"},
         {"slice-ready": "control-plane", "train-step": "train"}]


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
@pytest.mark.parametrize("roots", range(len(ROOTS)))
def test_profile_spans_equals_jax(case, roots):
    spans = SPAN_CASES[case]
    kw = {"roots": ROOTS[roots], "meta": {"source": "unit", "n": 1}}
    for order in (spans, list(reversed(spans))):
        want = json.dumps(jprof.profile_spans(order, **kw), sort_keys=True)
        got = json.dumps(tprof.profile_spans(order, **kw), sort_keys=True)
        assert got == want
    assert tprof.trace_records(spans, ROOTS[roots]) == \
        jprof.trace_records(spans, ROOTS[roots])


def test_aggregate_and_span_kind_equal_jax():
    assert tprof.aggregate([]) == jprof.aggregate([]) == \
        {"schema": tprof.PROFILE_SCHEMA, "shapes": {}}
    assert tprof.DEFAULT_ROOTS == jprof.DEFAULT_ROOTS
    for name in ("chain:TpuCluster/default/x", "error:coordinator",
                 "decode", "train-step"):
        assert tprof.span_kind(name) == jprof.span_kind(name)


class _Clock:
    """A clock that moves 0.25 s a reading."""

    def __init__(self):
        self.t = 100.0

    def now(self):
        self.t += 0.25
        return self.t


def _tracer_calls(mod, max_spans=8192):
    tr = mod.Tracer(clock=_Clock(), max_spans=max_spans)
    a = tr.start_request("serve-request", model="m")
    b = tr.start_request("train-step", ts=50.0)
    tr.record_span(a, "engine-queue", 100.0, 100.5)
    tr.record_span(a, "prefill", 100.5, 101.5, blocks=3)
    tr.record_span(a, "kv-alloc", 100.6, 100.7, parent_id="elsewhere",
                   cached_tokens=16)
    tr.record_span(a, "decode", 101.5, 104.0, status="error", error="x")
    tr.record_span(None, "dropped", 1.0, 2.0)
    tr.record_span(b, "dispatch", 50.0, 50.1)
    tr.record_span(b, "host-fetch", 50.1, 51.0)
    tr.finish_request(b, ts=51.0)
    tr.finish_request(b, ts=99.0)                # idempotent
    tr.finish_request(a, status="error", error="boom")
    tr.finish_request(None)
    remote = mod.TraceContext.from_traceparent("00-abc-def-01")
    tr.record_span(remote, "engine-queue", 5.0, 6.0)
    tr.finish_request(remote)
    for i in range(30):
        c = tr.start_request("serve-request", ts=200.0 + i)
        tr.record_span(c, "decode", 200.0 + i, 200.5 + i + 0.01 * i)
        if i % 3:
            tr.finish_request(c, ts=201.0 + i)
    return tr


@pytest.mark.parametrize("max_spans", [8192, 20])
def test_tracer_exports_the_jax_tracers_spans(max_spans):
    ours, ref = (_tracer_calls(m, max_spans) for m in (ttrace, jtrace))
    assert ours.export() == ref.export()
    assert ours.tree() == ref.tree()
    assert ours.store.stats() == ref.store.stats()
    tid = ref.export()[0]["trace_id"]
    assert ours.export(tid) == ref.export(tid)
    if max_spans == 20:
        assert ours.store.dropped > 0


def _structure(x):
    """A document with every number replaced by its type."""
    if isinstance(x, dict):
        return {k: _structure(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_structure(v) for v in x]
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return x if not isinstance(x, str) else "str"
    return type(x).__name__


def test_bench_profile_out_matches_the_jax_benchs(tmp_path, capsys,
                                                  monkeypatch):
    ours_path, ref_path = tmp_path / "ours" / "p.json", tmp_path / "ref.json"
    assert bench.main(["--cpu", "--profile-out", str(ours_path)]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert f"profile -> {ours_path}" in err
    monkeypatch.setattr(sys, "argv", ["bench.py", "--cpu", "--profile-out",
                                      str(ref_path)])
    jbench.main()
    capsys.readouterr()
    ours, ref = (json.loads(p.read_text()) for p in (ours_path, ref_path))
    assert _structure(ours) == _structure(ref)
    assert ours["schema"] == "tpu-profile/v1"
    train = ours["shapes"]["train"]
    assert train["traces"] == ref["shapes"]["train"]["traces"] == 3
    assert set(train["kinds"]) == {"dispatch", "host-fetch"}
    assert all(k["count"] == 3 for k in train["kinds"].values())
    assert sum(k["fraction"] for k in train["kinds"].values()) == \
        pytest.approx(1.0, abs=1e-6)
    assert {k: v for k, v in ours["meta"].items()
            if k not in ("source", "device")} == \
        {k: v for k, v in ref["meta"].items()
         if k not in ("source", "device")}
    # The file is written with sorted keys.
    assert ours_path.read_text() == json.dumps(ours, sort_keys=True)


PROMPTS = [[1, 2, 3, 4, 5], list(range(10, 30)), [7] * 9]


@pytest.mark.parametrize("paged", [False, True])
def test_engine_records_the_jax_engines_span_names(paged):
    jcfg, tcfg = jllama.CONFIGS["llama_tiny"], tllama.CONFIGS["llama_tiny"]
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(max_slots=2, max_len=64)
    if paged:
        kw["block_size"] = 8
        engines = (JPagedEngine(jcfg, jp, decode_impl="xla", **kw),
                   PagedServeEngine(tcfg, tp, device="cpu", **kw))
    else:
        engines = (JServeEngine(jcfg, jp, decode_impl="xla", **kw),
                   ServeEngine(tcfg, tp, device="cpu", **kw))
    names = []
    for eng, tracer, req_cls in zip(engines, (jtrace.Tracer(),
                                              ttrace.Tracer()),
                                    (JRequest, Request)):
        eng._tracer = tracer
        ctxs = {}
        for i, p in enumerate(PROMPTS):
            ctxs[i] = tracer.start_request("serve-request")
            eng.add_request(req_cls(f"r{i}", p, max_new_tokens=4,
                                    trace=ctxs[i]))
        eng.run()
        per = []
        for i in range(len(PROMPTS)):
            tracer.finish_request(ctxs[i])
            per.append(sorted(s["name"] for s in
                              tracer.export(ctxs[i].trace_id)))
        names.append(per)
    assert names[1] == names[0]
    assert all("prefill" in n and "decode" in n for n in names[1])
    if paged:
        assert all("kv-alloc" in n for n in names[1])


@pytest.mark.gpu
def test_bench_profile_phase_on_card():
    """``chip_smoke.py``'s ``bench_profile`` phase: the bench at llama_1b
    with ``--profile-out`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    import chip_smoke
    from kuberay_tpu_torch.ops import _build
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    run = chip_smoke.bench_profile(smi)
    assert run["traces"] == run["line"]["detail"]["steps"]
