"""PyTorch port, the entry points and the bench vs the JAX
package's ``__graft_entry__.py`` and ``bench.py``, and the profiler hook
vs the coordinator's.

- ``python -m kuberay_tpu_torch.bench --cpu`` prints one JSON line with
  the JAX bench's keys (its ``--cpu`` smoke run beside it); the default and
  ``--op`` modes need a card.
- ``entry(device="cpu")``'s forward against ``__graft_entry__.entry()``'s
  on the same params: both packages' ``llama_1b`` entry is pointed at
  ``llama_tiny`` here (a ``llama_1b`` forward at 1 x 512 is a card's
  work; ``chip_smoke.py``'s ``entry`` phase runs it there), tokens 1 x 512,
  float32, within 1e-5.
- ``dryrun_multichip(8, device="cpu")`` prints every ported block's line,
  tensor-parallel serving over 4 of the ranks (tp=2 x tpr=2) among them,
  and the pipeline block's line as the JAX dry run prints it.
- ``ProfileHook`` answers as ``CoordinatorServer``'s hook over start →
  second start → stop → stop, a timer that fires after a newer capture
  began (the generation mismatch), a timer that stops its own capture,
  and ``list_profiles``' order.
"""

import json
import os
import re
import sys
import time

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
import bench as jbench
from kuberay_tpu.models import llama as jllama
from kuberay_tpu.runtime import coordinator_server
from kuberay_tpu_torch import bench, entry
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.runtime import profiler

torch.set_num_threads(2)


def _keys(line: dict):
    return set(line), set(line["detail"])


def test_bench_cpu_line_has_the_jax_bench_keys(capsys, monkeypatch):
    assert bench.main(["--cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(sys, "argv", ["bench.py", "--cpu"])
    jbench.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _keys(ours) == _keys(ref)
    assert ours["metric"] == ref["metric"]
    assert ours["unit"] == ref["unit"]
    d = ours["detail"]
    assert (d["model"], d["batch"], d["seq"], d["steps"]) == (
        "llama_tiny(smoke)", 2, 128, 3)
    assert d["params"] == tllama.CONFIGS["llama_tiny"].num_params()
    assert ours["value"] > 0 and np.isfinite(d["loss"])
    assert ours["vs_baseline"] == 0.0          # no peak for a CPU


def test_bench_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--op"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)


def test_peak_table_names_the_card():
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert bench.peak_tflops("NVIDIA H100 PCIe") == 756.0
    assert bench.peak_tflops("some other card") is None


def test_entry_logits_match_graft_entry(monkeypatch):
    jtiny, ttiny = jllama.CONFIGS["llama_tiny"], tllama.CONFIGS["llama_tiny"]
    monkeypatch.setitem(jllama.CONFIGS, "llama_1b", jtiny)
    monkeypatch.setitem(tllama.CONFIGS, "llama_1b", ttiny)
    jfn, (jparams, jtokens) = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jtokens))
    fn, (params, tokens) = entry.entry(device="cpu")
    assert tokens.shape == (1, 512) and tokens.dtype == torch.int32
    assert not bool(tokens.any())
    assert params["embed"].shape == (ttiny.vocab_size, ttiny.d_model)
    converted = params_from_jax(
        ttiny, jax.tree.map(np.asarray, jparams), "cpu")
    got = fn(converted, tokens)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.timeout(240)
def test_dryrun_multichip_prints_every_ported_block(capfd):
    entry.dryrun_multichip(8, device="cpu", timeout=200.0)
    out = capfd.readouterr().out
    for pat in (r"dryrun_multichip ok: mesh dp=2 fsdp=2 tp=2 loss=\d",
                r"dryrun sp ok: ring attention over sp=8",
                r"dryrun ep ok: MoE over ep=2",
                r"dryrun multislice ok: 2 slices x 4 ranks .* loss=\d",
                r"dryrun serve ok: tp=2 x tpr=2 engine generated 4 tokens"):
        assert len(re.findall(pat, out)) == 1, (pat, out)
    assert [ln for ln in out.splitlines() if "dryrun pp" in ln] == \
        ["dryrun pp ok: 2-stage pipeline"]


class _Clock:
    """A ``time.time`` that moves one second a call, so each capture gets
    its own ``trace-<unix>`` name."""

    def __init__(self):
        self.t = 1_700_000_000

    def __call__(self):
        self.t += 1
        return float(self.t)


def _hooks(tmp_path, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(coordinator_server.time, "time", clock)
    monkeypatch.setattr(profiler.time, "time", clock)
    ref = coordinator_server.CoordinatorServer(
        log_dir=str(tmp_path / "jax"), spawn_jobs=False)
    ours = profiler.ProfileHook(str(tmp_path / "torch" / "profiles"))
    return ref, ours


def _shape(ans: dict) -> dict:
    """An answer with its trace directory reduced to ``trace-<n>``."""
    return {k: (re.sub(r"trace-\d+$", "trace-N", os.path.basename(v))
                if k == "trace_dir" else v) for k, v in ans.items()}


def _capture_sequence(h) -> list:
    """start → second start → stop → stop, then a stale timer's stop (it
    names the first capture while a second one runs), then the stop of
    that second capture."""
    out = [h.start_profile(), h.start_profile(), h.stop_profile(),
           h.stop_profile()]
    first = h.start_profile()["trace_dir"]
    h.stop_profile()
    h.start_profile()
    out += [h.stop_profile(expected=first), h.stop_profile()]
    return [_shape(a) for a in out]


def test_profile_hook_answers_as_the_coordinators(tmp_path, monkeypatch):
    # One hook at a time: jax.profiler and torch.profiler do not trace
    # together in one process.
    ref, ours = _hooks(tmp_path, monkeypatch)
    want = _capture_sequence(ref)
    assert _capture_sequence(ours) == want
    assert want[4] == {"error": "profile generation mismatch (stale timer)"}
    # The port's capture holds a Chrome trace.
    last = ours.list_profiles()[-1]
    trace = tmp_path / "torch" / "profiles" / last / profiler.TRACE_FILE
    assert "traceEvents" in json.loads(trace.read_text())


def test_profile_timer_stops_its_own_capture(tmp_path, monkeypatch):
    answers = []
    for h in _hooks(tmp_path, monkeypatch):
        assert "trace_dir" in h.start_profile(duration_s=0.2)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and h._profiling:
            time.sleep(0.05)
        answers.append(h.stop_profile())
    assert answers == [{"error": "no profile running"}] * 2


def test_list_profiles_sorted_as_the_coordinators(tmp_path, monkeypatch):
    ref, ours = _hooks(tmp_path, monkeypatch)
    assert ref.list_profiles() == ours.list_profiles() == []
    for name in ("trace-30", "trace-100", "trace-2", "notes", "tracez"):
        os.makedirs(os.path.join(ref.profile_dir, name))
        os.makedirs(os.path.join(ours.profile_dir, name))
    assert ours.list_profiles() == ref.list_profiles() == [
        "trace-100", "trace-2", "trace-30"]
