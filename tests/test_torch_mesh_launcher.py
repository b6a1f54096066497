"""PyTorch port, the launcher over a multi-process slice.

Two gloo processes (``torch_mesh_worker.py``, kind ``"launcher"``) run
``launcher.main`` with the operator's env (``TPU_WORKER_ID``,
``TPU_WORKER_HOSTNAMES``, ``TPU_NUM_PROCESSES``) and ``--tp 2`` at
``llama_tiny`` on the CPU: ``initialize_distributed`` joins them,
``build_mesh`` lays the model over tp, and the lead's ``train_step``
events carry the losses one process trains to on the same flags (within
1e-5); likewise ``--sp 2`` (the ring).  The heartbeats report the global parameter count and the slice's
device count (each rank's shard count and 1 before the layouts were
ported).  Also ``initialize_distributed``'s arguments, the one-process
refusal of ``--tp 2``, and ``build_mesh`` against the JAX launcher's.
"""

import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax  # noqa: F401  (both frameworks in one process, as the other tests)
import pytest
import torch

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.runtime import coordinator_client
from kuberay_tpu_torch.train import launcher

import torch_mesh_worker

torch.set_num_threads(2)

STEPS = 4
ARGV = ["--model", "llama_tiny", "--device", "cpu", "--steps", str(STEPS),
        "--batch", "4", "--seq-len", "16", "--log-every", "1",
        "--warmup", "1", "--lr", "1e-2"]


class Recorder:
    """A coordinator stand-in that keeps every event posted to it."""

    def __init__(self):
        self.events = []
        rec = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n))
                rec.events.extend(body["events"])
                out = json.dumps({"recorded": len(body["events"])}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()

    def losses(self):
        return [e["args"]["loss"] for e in self.events
                if e["name"] == "train_step"]

    def last_beats(self):
        return {e["host"]: e["args"] for e in self.events
                if e["name"] == "step_heartbeat" and "n_params" in e["args"]}


def _env(rank: int) -> dict:
    return {"TPU_WORKER_ID": str(rank),
            "TPU_WORKER_HOSTNAMES": "localhost,localhost",
            "TPU_NUM_PROCESSES": "2", "TPU_COORDINATOR_ADDRESS": "localhost",
            "TPU_TRAIN_METRICS_PORT": "0"}


def _run_here(recorder, argv):
    """``launcher.main(argv)`` in this process, posting to ``recorder``."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(coordinator_client, "dashboard_url",
                   lambda addr: recorder.url)
        mp.setenv("TPU_COORDINATOR_ADDRESS", "localhost")
        mp.setenv("TPU_TRAIN_METRICS_PORT", "0")
        for k in ("TPU_WORKER_HOSTNAMES", "TPU_NUM_PROCESSES",
                  "TPU_WORKER_ID", "MEGASCALE_NUM_SLICES"):
            mp.delenv(k, raising=False)
        assert launcher.main(argv) == 0
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank run's (--tp 2, then --sp 2), the one-process run's and
    a one-rank group's events."""
    two, one, group1, sp2 = Recorder(), Recorder(), Recorder(), Recorder()
    try:
        task = {"kind": "launcher", "argv": ARGV + ["--tp", "2"],
                "env": [_env(0), _env(1)], "recorder": two.url}
        outs = torch_mesh_worker.spawn(task, {"unused": 0},
                                       tmp_path_factory.mktemp("launch"),
                                       world=2, timeout=120.0)
        sp_task = {**task, "argv": ARGV + ["--sp", "2"],
                   "recorder": sp2.url}
        sp_outs = torch_mesh_worker.spawn(sp_task, {"unused": 0},
                                          tmp_path_factory.mktemp("launch"),
                                          world=2, timeout=120.0)
        assert [int(o["rc"]) for o in sp_outs] == [0, 0]
        _run_here(one, ARGV)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        _run_here(group1, ARGV + ["--dist-backend", "gloo", "--dist-port",
                                  str(port)])
        assert not launcher.dist.is_initialized()
        return outs, two, one, group1, sp2
    finally:
        for r in (two, one, group1, sp2):
            r.close()


@pytest.mark.timeout(180)
def test_two_ranks_with_tp2_train_as_one_process(runs):
    outs, two, one, _, _ = runs
    assert [int(o["rc"]) for o in outs] == [0, 0]
    assert len(one.losses()) == STEPS
    assert two.losses() == pytest.approx(one.losses(), abs=1e-5)
    # Worker 0 alone prints the step lines.
    assert str(outs[0]["stdout"]).count("step ") == STEPS
    assert "step " not in str(outs[1]["stdout"])


@pytest.mark.timeout(180)
def test_heartbeats_report_global_params_and_devices(runs):
    _, two, one, _, _ = runs
    n = llama.CONFIGS["llama_tiny"].num_params()
    beats = two.last_beats()
    assert set(beats) == {"s0w0", "s0w1"}
    for args in beats.values():
        assert args["n_params"] == n
        assert args["device_count"] == 2
    assert [a["device_count"] for a in one.last_beats().values()] == [1]
    assert [a["n_params"] for a in one.last_beats().values()] == [n]


def test_initialize_distributed_joins_the_slice(monkeypatch):
    calls = []
    monkeypatch.setattr(launcher.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(launcher.dist, "barrier", lambda: None)
    ident = launcher.WorkerIdentity.from_env(
        {"TPU_WORKER_HOSTNAMES": "w0.svc,w1.svc,w2.svc,w3.svc",
         "TPU_WORKER_ID": "1", "MEGASCALE_NUM_SLICES": "2",
         "MEGASCALE_SLICE_ID": "1"})
    assert launcher.initialize_distributed(ident, device="cpu") is ident
    assert calls == [(("gloo",), {"init_method": "tcp://w0.svc:8081",
                                  "world_size": 8, "rank": 5})]
    launcher.initialize_distributed(ident, "gloo", "cpu", port=1234)
    assert calls[-1][1]["init_method"] == "tcp://w0.svc:1234"


@pytest.mark.timeout(180)
def test_a_group_of_one_trains_as_one_process(runs):
    """``--dist-backend`` on a single host: a process group of one and the
    sharded step over a mesh of ones (on the card, NCCL's path)."""
    _, _, one, group1, _ = runs
    assert group1.losses() == pytest.approx(one.losses(), abs=1e-5)
    assert [a["device_count"] for a in group1.last_beats().values()] == [1]


@pytest.mark.timeout(180)
def test_two_ranks_with_sp2_train_as_one_process(runs):
    """--sp 2: the sequence split over two ranks, attending through the
    ring (the launcher sets attn_impl="ring_rdma"; plain versions on the
    CPU)."""
    _, _, one, _, sp2 = runs
    assert sp2.losses() == pytest.approx(one.losses(), abs=1e-5)
