"""PyTorch port, multi-process serving: the server as a tp group, the step
plans, and group health, vs the JAX package.

- The port's server as two processes on the CPU (``--tp 2``, the worker
  env, gloo): each rank restores its shards of a port checkpoint of a JAX
  state; rank 0 answers ``/v1/completions`` with the greedy tokens of
  JAX's ``ServeEngine`` on ``serve_mesh(2)`` over the same params and
  reports its group in ``/stats``; after SIGTERM to both, rank 0 drains
  and broadcasts STOP, the follower has replayed each of rank 0's device
  calls, and both exit 0.
- A killed follower (SIGKILL): rank 0's ``/healthz`` answers 503 within
  ``--group-miss-timeout`` + 5 s, a request answers 503, and rank 0 exits
  at SIGTERM without hanging.
- The plan: JAX's fields but the RNG key and sampling parameters (only
  rank 0 samples), packed into one int32 vector and back bit for bit.
- ``GroupMonitor``: the monitor cases of ``tests/test_group_health.py``
  run on the port's copy and on the JAX original under one fake clock,
  with equal verdicts, reasons and status; the heartbeat wire both ways
  (a port follower beats a JAX monitor, a JAX follower a port monitor).
- Refusals with the JAX server's texts: tp other than the slice's size,
  a tp the model cannot split (before the group's rendezvous),
  ``--decode-impl`` other than ``auto``.
- ``--tp 2 --paged`` with ``--host-blocks`` or ``--spill-blocks`` starts
  a tiered group: rank 0's ``/stats`` shows the tier, a prompt demotes
  and resumes from it, and ``/v1/kv/export`` and ``/v1/kv/import`` answer
  with the group's blocks.
- ``dryrun_multichip(4)``'s serving block: tp=2 x tpr=2 over 4 CPU ranks.
- On the card only (``gpu``): the three decode kernels at the local head
  counts of ``llama3_8b`` at tp=2 (16 q / 4 kv heads) and tp=16 (2 / 1).
"""

import base64
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import json
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.serve import group_health as jgh
from kuberay_tpu.serve import multihost as jmh
from kuberay_tpu.serve.engine import Request as JRequest
from kuberay_tpu.serve.engine import ServeEngine as JServeEngine
from kuberay_tpu.serve import sharding as jsh
from kuberay_tpu.train import train_step as jts
from kuberay_tpu_torch import entry
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import state_from_jax
from kuberay_tpu_torch.serve import group_health as tgh
from kuberay_tpu_torch.serve import multihost as tmh
from kuberay_tpu_torch.serve import server
from kuberay_tpu_torch.train import checkpoint as ckpt
from tests.test_torch_attention import _within_local

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CFG = jllama.CONFIGS["llama_tiny"]
PROMPTS = ([5, 17, 3, 99, 42], [7, 7, 200, 1, 13, 64, 9], list(range(40)))
MAX_TOKENS = 8
MISS = 3.0                      # --group-miss-timeout of the killed group


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(fn, timeout=10.0, poll=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(poll)
    return False


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A JAX state's port checkpoint and JAX's tp=2 greedy tokens on its
    params."""
    tmp = tmp_path_factory.mktemp("tp_server")
    tc = jts.TrainConfig(warmup_steps=1, decay_steps=10)
    state = jts.init_train_state(CFG, jts.make_optimizer(tc),
                                 jax.random.PRNGKey(5))
    eng = JServeEngine(CFG, state["params"], max_slots=2, max_len=64,
                       decode_impl="xla", mesh=jsh.serve_mesh(2))
    for i, p in enumerate(PROMPTS):
        eng.add_request(JRequest(f"r{i}", p, max_new_tokens=MAX_TOKENS))
    want = {r.request_id: r.tokens for r in eng.run()}
    d = str(tmp / "ckpt")
    ckpt.save(d, state_from_jax(tllama.CONFIGS["llama_tiny"],
                                jax.tree.map(np.asarray, state), "cpu"), 1)
    return {"dir": d, "tokens": [want[f"r{i}"] for i in range(len(PROMPTS))]}


class _Group:
    """The port's server as a tp group of processes on the CPU, each one's
    output read as it comes."""

    def __init__(self, n, *flags):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        dist_port, hb_port = _free_port(), _free_port()
        self.lines = [[] for _ in range(n)]
        self.procs = []
        for r in range(n):
            env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                       TPU_WORKER_HOSTNAMES=",".join(["127.0.0.1"] * n),
                       TPU_WORKER_ID=str(r),
                       TPU_GROUP_HEALTH_PORT=str(hb_port))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "kuberay_tpu_torch.serve.server",
                 "--model", "llama_tiny", "--device", "cpu", "--host",
                 "127.0.0.1", "--port", str(self.port), "--dist-port",
                 str(dist_port), "--max-slots", "2", "--max-len", "64",
                 *flags], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
            threading.Thread(target=self._read, args=(r,),
                             daemon=True).start()

    def _read(self, r):
        for line in self.procs[r].stdout:
            self.lines[r].append(line)

    def output(self, r) -> str:
        return "".join(self.lines[r])

    def wait_for(self, r, text, timeout=90.0) -> str:
        assert wait_for(lambda: text in self.output(r) or
                        self.procs[r].poll() is not None, timeout), \
            self.output(r)
        assert text in self.output(r), self.output(r)
        return self.output(r)

    def get(self, path, timeout=10.0):
        try:
            with urllib.request.urlopen(self.url + path,
                                        timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def post(self, path, body, timeout=60.0):
        req = urllib.request.Request(
            self.url + path, method="POST", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def complete(self, prompt, timeout=60.0):
        return self.post("/v1/completions", {"prompt_tokens": prompt,
                                             "max_tokens": MAX_TOKENS},
                         timeout)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=30)


def test_two_process_server_gives_jax_tokens_and_stops_together(served):
    g = _Group(2, "--tp", "2", "--checkpoint-dir", served["dir"])
    try:
        g.wait_for(1, "serve follower 1/2 ready")
        head = g.wait_for(0, "serving llama_tiny")
        assert "tp=2 x tpr=1, processes 2" in head
        got = [g.complete(p) for p in PROMPTS]
        assert [c for c, _ in got] == [200] * len(PROMPTS), got
        assert [b["tokens"] for _, b in got] == served["tokens"]
        code, stats = g.get("/stats")
        assert code == 200 and "degraded" not in stats
        assert stats["group"]["followers"] == [1]
        assert stats["group"]["degraded"] is None
        calls = stats["prefills"] + stats["decode_steps"]
        assert g.get("/healthz")[0] == 200
        for p in g.procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=60) for p in g.procs]
    finally:
        g.kill()
    assert codes == [0, 0], (g.output(0), g.output(1))
    assert "serve: drained=True" in g.output(0)
    assert "waiting for STOP" in g.output(1)
    assert f"serve follower 1/2: STOP after {calls} device calls" in \
        g.output(1)


def test_killed_follower_degrades_to_503_without_a_hang(served):
    g = _Group(2, "--tp", "0", "--checkpoint-dir", served["dir"],
               "--group-miss-timeout", str(MISS))
    try:
        g.wait_for(1, "serve follower 1/2 ready")
        g.wait_for(0, "serving llama_tiny")
        assert g.complete(PROMPTS[0])[0] == 200
        g.procs[1].send_signal(signal.SIGKILL)
        g.procs[1].wait(timeout=30)
        t0 = time.monotonic()
        code, body = g.complete(PROMPTS[1], timeout=MISS + 30)
        assert code == 503, body
        assert wait_for(lambda: g.get("/healthz")[0] == 503,
                        timeout=MISS + 5 - (time.monotonic() - t0))
        code, body = g.get("/healthz")
        assert body["status"] == "degraded" and body["reason"]
        assert g.get("/stats")[1]["group"]["degraded"]
        g.procs[0].send_signal(signal.SIGTERM)
        rc = g.procs[0].wait(timeout=30)
    finally:
        g.kill()
    assert rc != 0
    assert "serve: DEGRADED" in g.output(0)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_plan_holds_the_jax_fields_rank_0_needs_to_replay():
    """JAX's plan less the RNG key and the sampling parameters (only rank
    0 samples); every field of the same shape and dtype.  A paged plan
    also carries a block plan's ids (``bids``, ``max_blocks`` int32, and
    their count ``nbids``): the JAX engine reads and writes whole blocks
    of its sharded pool in one process and has no block plans."""
    for args in ((64, 4, 0, 0), (2048, 8, 4, 128)):
        ours, ref = tmh._zero_plan(*args), jmh._zero_plan(*args)
        assert set(ref) - set(ours) == {"key", "temp", "temps"}
        blocks = {"bids", "nbids"} if args[3] else set()
        assert set(ours) - set(ref) == blocks
        for k, a in ours.items():
            if k in blocks:
                continue
            want = np.asarray(ref[k])
            assert a.shape == (want.shape or (1,)) and a.dtype == want.dtype
        if blocks:
            assert ours["bids"].shape == (args[3],)
            assert ours["nbids"].shape == (1,)
            assert ours["bids"].dtype == ours["nbids"].dtype == np.int32
    assert (tmh.OP_STOP, tmh.OP_PREFILL, tmh.OP_DECODE, tmh.OP_VERIFY) == \
        (jmh.OP_STOP, jmh.OP_PREFILL, jmh.OP_DECODE, jmh.OP_VERIFY)
    assert len({tmh.OP_STOP, tmh.OP_PREFILL, tmh.OP_DECODE, tmh.OP_VERIFY,
                tmh.OP_READ_BLOCKS, tmh.OP_WRITE_BLOCKS}) == 6


def test_plan_packs_to_one_int32_vector_and_back_bit_for_bit():
    rng = np.random.default_rng(0)
    plan = tmh._zero_plan(32, 4, 3, 5)
    filled = {k: (rng.standard_normal(a.shape).astype(a.dtype)
                  if a.dtype == np.float32 else
                  rng.integers(-2 ** 31, 2 ** 31 - 1, a.shape, dtype=a.dtype))
              for k, a in plan.items()}
    flat = tmh._pack(filled)
    assert flat.dtype == torch.int32 and flat.dim() == 1
    back = tmh._unpack(flat.clone(), plan)
    for k, a in filled.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape
        assert back[k].tobytes() == a.tobytes()


# ---------------------------------------------------------------------------
# group health: the monitor and the heartbeat wire
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _missed_heartbeats(mon, clk, log):
    m = mon(expected=[1, 2], miss_timeout=0.3, grace=0.0, clock=clk)
    m.beat(1)
    m.beat(2)
    log.append(m.check())
    clk.advance(0.5)
    m.beat(1)
    log.append(m.check())
    m.beat(2)
    log.append(m.check())          # sticky
    log.append(m.status())


def _step_watchdog(mon, clk, log):
    m = mon(expected=[], miss_timeout=30.0, step_timeout=0.2, clock=clk)
    m.step_begin()
    log.append(m.check())
    clk.advance(0.4)
    log.append(m.check())
    m2 = mon(expected=[], miss_timeout=30.0, step_timeout=0.2, clock=clk)
    m2.step_begin()
    m2.step_end()
    clk.advance(0.4)
    log.append(m2.check())


def _stray_ids(mon, clk, log):
    m = mon(expected=[1], miss_timeout=0.3, grace=0.0, clock=clk)
    m.beat(1)
    m.beat(7)
    clk.advance(0.4)
    m.beat(1)
    log.append(m.check())
    log.append(m.status())


def _grace(mon, clk, log):
    m = mon(expected=[1], miss_timeout=0.2, grace=5.0, clock=clk)
    clk.advance(0.4)
    log.append(m.check())
    clk.advance(5.0)
    log.append(m.check())


def _fires_once(mon, clk, log):
    m = mon(expected=[1], miss_timeout=0.1, grace=0.0,
            on_degraded=log.append, clock=clk)
    clk.advance(0.2)
    m.check()
    m.check()
    m.mark_degraded("later")
    log.append(m.degraded)


def _adaptive_budget(mon, clk, log):
    m = mon(expected=[], miss_timeout=0.5, step_timeout=60.0,
            budget_multiplier=20.0, clock=clk)
    log.append(m.current_step_budget())
    for _ in range(m.MIN_SAMPLES):
        m.step_begin()
        clk.advance(0.005)
        m.step_end()
    log.append(round(m.current_step_budget(), 9))
    for _ in range(30):
        m.step_begin()
        clk.advance(0.2)
        m.step_end()
    log.append(round(m.current_step_budget(), 9))
    log.append(m.status())


def _slow_but_alive(mon, clk, log):
    m = mon(expected=[], miss_timeout=0.05, step_timeout=0.1,
            budget_multiplier=20.0, clock=clk)
    for _ in range(m.MIN_SAMPLES):
        m.step_begin()
        clk.advance(0.01)
        m.step_end()
    budget = m.current_step_budget()
    log.append(round(budget, 9))
    m.step_begin()
    clk.advance(0.12)
    log.append(m.check())
    m.step_end()
    m.step_begin()
    clk.advance(budget + 0.1)
    log.append(m.check())


def _compile_steps(mon, clk, log):
    m = mon(expected=[], miss_timeout=0.5, step_timeout=60.0,
            compile_timeout=300.0, budget_multiplier=20.0, clock=clk)
    m.step_begin(compiling=True)
    clk.advance(0.2)
    m.step_end()
    log.append(list(m._durations))
    for _ in range(m.MIN_SAMPLES):
        m.step_begin()
        clk.advance(0.002)
        m.step_end()
    log.append(round(m.current_step_budget(), 9))
    m.step_begin(compiling=True)
    clk.advance(299.0)
    log.append(m.check())
    clk.advance(2.0)
    log.append(m.check())


SCENARIOS = {"missed_heartbeats": _missed_heartbeats,
             "step_watchdog": _step_watchdog, "stray_ids": _stray_ids,
             "grace": _grace, "fires_once": _fires_once,
             "adaptive_budget": _adaptive_budget,
             "slow_but_alive": _slow_but_alive,
             "compile_steps": _compile_steps}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_group_monitor_behaves_as_the_jax_monitor(name):
    logs = []
    for mod in (tgh, jgh):
        log = []
        SCENARIOS[name](mod.GroupMonitor, FakeClock(), log)
        logs.append(log)
    assert logs[0] == logs[1]
    assert any(x is not None for x in logs[0])


@pytest.mark.parametrize("monitor_mod,beat_mod", [(jgh, tgh), (tgh, jgh)],
                         ids=["port_follower_jax_monitor",
                              "jax_follower_port_monitor"])
def test_heartbeat_wire_interoperates(monitor_mod, beat_mod):
    m = monitor_mod.GroupMonitor(expected=[1], miss_timeout=1.0, grace=10.0)
    port = m.listen(host="127.0.0.1", port=0)
    stop = beat_mod.start_heartbeat("127.0.0.1", port, 1, interval=0.1)
    try:
        assert wait_for(lambda: m.status()["beat_age_seconds"]["1"] < 0.5)
        time.sleep(1.2)
        assert m.check() is None
        stop.set()
        assert wait_for(lambda: m.check() is not None, timeout=5)
        assert "missed heartbeats" in m.check()
    finally:
        stop.set()
        m.close()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts,tp,world", [("a,b", "3", 2), ("", "2", 1),
                                            ("a,b,c,d", "2", 4)])
def test_tp_other_than_the_slice_size_is_refused(monkeypatch, capsys, hosts,
                                                 tp, world):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", hosts)
    with pytest.raises(SystemExit) as e:
        server.main(["--model", "llama_tiny", "--device", "cpu", "--tp", tp])
    assert e.value.code == 2
    assert (f"multi-host serving requires tp == total chips ({world}); "
            f"got --tp {tp}. Use --tp 0 (auto)") in capsys.readouterr().err


@pytest.mark.parametrize("n", [3, 8])
def test_a_tp_the_model_cannot_split_is_refused_before_the_group_starts(
        monkeypatch, capsys, n):
    """Every rank refuses before the rendezvous (no group is joined), with
    the JAX package's text: llama_tiny's 2 kv heads do not split 3 ways,
    and its 4 q heads do not split 8 ways."""
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", ",".join(["a"] * n))
    with pytest.raises(SystemExit):
        server.main(["--model", "llama_tiny", "--device", "cpu"])
    try:
        jsh.validate_tp(CFG, jsh.serve_mesh(n, n_kv_heads=CFG.n_kv_heads))
    except ValueError as e:
        want = str(e)
    assert want in capsys.readouterr().err




@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret"])
def test_decode_impl_other_than_auto_is_refused(capsys, impl):
    with pytest.raises(SystemExit):
        server.main(["--model", "llama_tiny", "--device", "cpu",
                     "--decode-impl", impl])
    assert f"--decode-impl {impl}: {server._unported('decode_impl', impl)}" \
        in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the KV tiers and the block endpoints under tp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag,total", [("--host-blocks", "host_blocks_total"),
                                        ("--spill-blocks",
                                         "spill_blocks_total")])
def test_tp_group_builds_a_tiered_engine(served, flag, total):
    """``--tp 2 --paged`` with a tier starts (the flag was refused before
    the block plans): rank 0's ``/stats`` shows the tier,
    it serves JAX's tp=2 tokens, ``/v1/kv/export`` returns the prompt's 5
    blocks as ``[L, Hkv, 8, D]`` float32 payloads over every kv head,
    ``/v1/kv/import`` of them finds them resident, and the group stops
    together."""
    g = _Group(2, "--tp", "2", "--paged", "--block-size", "8", flag, "8",
               "--checkpoint-dir", served["dir"])
    try:
        g.wait_for(1, "serve follower 1/2 ready")
        g.wait_for(0, "serving llama_tiny")
        code, stats = g.get("/stats")
        assert code == 200 and stats[total] == 8
        got = [g.complete(p) for p in PROMPTS]
        assert [b["tokens"] for _, b in got] == served["tokens"]
        body = {"prompt_tokens": PROMPTS[2]}
        code, exp = g.post("/v1/kv/export", body)
        assert code == 200 and exp["block_size"] == 8
        assert [b["index"] for b in exp["blocks"]] == list(range(5))
        wire = CFG.n_layers * CFG.n_kv_heads * 8 * CFG.head_dim * 4
        assert all(len(base64.b64decode(b[n])) == wire
                   for b in exp["blocks"] for n in ("k", "v"))
        code, counts = g.post("/v1/kv/import",
                              {**body, "blocks": exp["blocks"]})
        assert (code, counts) == (200, {"imported": 0, "skipped": 5})
        for p in g.procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=60) for p in g.procs]
    finally:
        g.kill()
    assert codes == [0, 0], (g.output(0), g.output(1))
    assert "serve follower 1/2: STOP after" in g.output(1)


# ---------------------------------------------------------------------------
# the dry run's serving block
# ---------------------------------------------------------------------------

@pytest.mark.timeout(120)
def test_dryrun_serves_over_four_cpu_ranks(capfd):
    entry.dryrun_multichip(4, device="cpu", timeout=100.0)
    out = capfd.readouterr().out
    assert len(re.findall(
        r"dryrun serve ok: tp=2 x tpr=2 engine generated 4 tokens",
        out)) == 1, out
    # The pipeline block's line, as the JAX dry run prints it at 4.
    assert [ln for ln in out.splitlines() if "dryrun pp" in ln] == \
        ["dryrun pp ok: 2-stage pipeline"]


# ---------------------------------------------------------------------------
# on the card: the decode kernels on a rank's local heads
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_decode_kernels_at_local_head_counts_on_card():
    """The bf16, int8 and paged decode kernels at ``llama3_8b``'s local
    head counts, 16 q / 4 kv (tp=2) and 2 / 1 (tp=16: tp=8 x tpr=2), S 8,
    M 2048, lens 0..2048: each within chip_smoke.py's element-wise limits
    of its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kuberay_tpu_torch.ops import decode_attention as da
    from kuberay_tpu_torch.ops import paged_attention as pa
    from kuberay_tpu_torch.serve.kv_cache import quantize_kv
    g = torch.Generator(device="cuda").manual_seed(0)
    S, M, D, BS = 8, 2048, 128, 16
    lens = torch.tensor([0, 1, 17, 300, 1000, 2047, 2048, 1500],
                        dtype=torch.int32, device="cuda")
    for hq, hkv in ((16, 4), (2, 1)):
        q = torch.randn(S, hq, D, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(S, M, hkv, D, generator=g, device="cuda"
                            ).bfloat16() for _ in range(2))
        assert _within_local(da.decode_attention(q, k, v, lens),
                             da.decode_attention_ref(q, k, v, lens))
        quant = []
        for x in (k, v):
            x8, s = quantize_kv(x.float())
            quant += [x8, s[..., 0].transpose(1, 2).contiguous()]
        assert _within_local(da.decode_attention_quant(q, *quant, lens),
                             da.decode_attention_quant_ref(q, *quant, lens))
        nb = M // BS
        tables = torch.randperm(S * nb, generator=g, device="cuda").reshape(
            S, nb).to(torch.int32)
        pk, pv = (torch.randn(hkv, S * M, D, generator=g, device="cuda"
                              ).bfloat16() for _ in range(2))
        assert _within_local(
            pa.paged_decode_attention(q, pk, pv, lens, tables, BS),
            pa.paged_decode_attention_ref(q, pk, pv, lens, tables, BS))
