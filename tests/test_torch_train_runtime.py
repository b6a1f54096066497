"""PyTorch port, the training pod's runtime glue vs the JAX package.

- ``WorkerIdentity.from_env`` parses the operator's env as the JAX
  launcher's does; the port's constants are the JAX package's values; a
  slice of more than one process joins one process group (ROADMAP A8,
  ported; ``test_torch_mesh_launcher.py`` trains over it).
- Run → interrupt → resume → rerun, the JAX launcher (this file run as a
  script: its own process, on one CPU device, ``_jax_launcher_runs``)
  and the port's (here) under the same flags: the same tokens fed at every global step
  (a resumed run's loader starts again from the seed), the same saves by
  each run and the same steps on disk.
- The step heartbeats and ``train_step`` events the two post to a live
  ``CoordinatorServer`` are the same but for durations, timestamps and
  losses (the two packages draw other random weights); its
  ``StepTracker`` reads both.  A coordinator that goes away stops the
  posting, not the run.
- Worker 0's ``/metrics`` serves the five ``tpu_train_*`` gauges.
- The native loader gives the NumPy path's batches.
"""

import dataclasses
import json
import math
import os
import re
import socket
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch

from kuberay_tpu.obs.steps import StepTracker
from kuberay_tpu.runtime.coordinator_server import CoordinatorServer
from kuberay_tpu.train import launcher as jlauncher
from kuberay_tpu.utils import constants as JC
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.runtime import coordinator_client
from kuberay_tpu_torch.train import checkpoint as ckpt
from kuberay_tpu_torch.train import data as tdata
from kuberay_tpu_torch.train import launcher
from kuberay_tpu_torch.train import train_step as tts
from kuberay_tpu_torch.utils import constants as TC

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STEPS, INTERRUPT_AT = 5, 3


def test_constants_are_the_jax_packages():
    names = [n for n in dir(TC) if n.isupper()]
    assert len(names) == 13
    for n in names:
        assert getattr(TC, n) == getattr(JC, n), n


ENVS = [
    {},
    {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "host-0"},
    {"TPU_WORKER_ID": "2", "TPU_WORKER_HOSTNAMES": "a,b,c,d",
     "TPU_TOPOLOGY": "2x2x1"},
    {"TPU_WORKER_HOSTNAMES": "a,,b", "TPU_NUM_PROCESSES": "4"},
    {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "a,b",
     "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"},
    {"MEGASCALE_NUM_SLICES": "3", "MEGASCALE_SLICE_ID": "2"},
]


@pytest.mark.parametrize("env", ENVS)
def test_worker_identity_matches_jax(env, monkeypatch):
    for k in ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES", "TPU_TOPOLOGY",
              "TPU_NUM_PROCESSES", "MEGASCALE_NUM_SLICES",
              "MEGASCALE_SLICE_ID"):
        monkeypatch.delenv(k, raising=False)
    ours = launcher.WorkerIdentity.from_env(env)
    ref = jlauncher.WorkerIdentity.from_env(env)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("is_distributed", "global_process_id",
                 "global_process_count"):
        assert getattr(ours, prop) == getattr(ref, prop), prop


def test_launcher_refuses_a_slice_of_many_processes(monkeypatch):
    """No longer refused (ROADMAP A8 is ported): the launcher joins the
    slice's process group at worker 0 on the coordinator port, as
    ``jax.distributed.initialize`` does (the group's init is stubbed
    here; two real ranks train in ``test_torch_mesh_launcher.py``)."""
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a,b")
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    calls = []

    def init(*a, **k):
        calls.append((a, k))
        raise RuntimeError("stop after the group's init")

    monkeypatch.setattr(launcher.dist, "init_process_group", init)
    with pytest.raises(RuntimeError, match="stop after"):
        launcher.main(["--model", "llama_tiny", "--steps", "1",
                       "--device", "cpu"])
    assert calls == [(("gloo",), {"init_method": "tcp://a:8081",
                                  "world_size": 2, "rank": 1})]
    ident = launcher.WorkerIdentity.from_env({"TPU_WORKER_HOSTNAMES": "a"})
    assert launcher.initialize_distributed(ident) is ident


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _argv(tmp: Path, who: str) -> list:
    return ["--model", "llama_tiny", "--batch", "2", "--seq-len", "16",
            "--steps", str(STEPS), "--warmup", "1", "--log-every", "1",
            "--heartbeat-every", "2", "--checkpoint-every", "2",
            "--data", str(tmp / "shard.bin"),
            "--checkpoint-dir", str(tmp / f"ckpt-{who}")]


def _port_runs(tmp: Path, coord_url: str, monkeypatch) -> dict:
    """The port's launcher, in this process, as the worker runs JAX's; the
    first run also scrapes /metrics once its step 2 is logged."""
    metrics_port = _free_port()
    monkeypatch.setenv("TPU_TRAIN_METRICS_PORT", str(metrics_port))
    monkeypatch.setenv("TPU_JOB_ID", "torch-run")
    monkeypatch.setattr(coordinator_client, "dashboard_url",
                        lambda address: coord_url)
    fed, saves, scrapes = [], [], []
    run = {"n": 0}
    real_make = launcher.make_train_step
    real_save = ckpt.CheckpointWriter.save_async

    def make_train_step(*args, **kwargs):
        step_fn = real_make(*args, **kwargs)

        def step(state, batch):
            s = state["step"] + 1
            if run["n"] == 0 and s == 3:
                scrapes.append(urllib.request.urlopen(
                    f"http://127.0.0.1:{metrics_port}/metrics",
                    timeout=10).read().decode())
            if run["n"] == 0 and s == INTERRUPT_AT:
                raise KeyboardInterrupt
            fed.append([run["n"], s, batch["tokens"].tolist()])
            return step_fn(state, batch)

        return step

    def save_async(self, state, step):
        saves.append([run["n"], step])
        return real_save(self, state, step)

    monkeypatch.setattr(launcher, "make_train_step", make_train_step)
    monkeypatch.setattr(ckpt.CheckpointWriter, "save_async", save_async)
    argv = _argv(tmp, "torch") + ["--device", "cpu"]
    with pytest.raises(KeyboardInterrupt):
        launcher.main(argv)
    for n in (1, 2):
        run["n"] = n
        assert launcher.main(argv) == 0
    on_disk = sorted(int(n) for n in os.listdir(tmp / "ckpt-torch")
                     if n.isdigit())
    return {"fed": fed, "saves": saves, "on_disk": on_disk,
            "metrics": scrapes[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both launchers' run → interrupt → resume → rerun, posting to one
    live coordinator with a step tracker."""
    tmp = tmp_path_factory.mktemp("launchers")
    tdata.synthetic_shard(str(tmp / "shard.bin"), 17 * 40, vocab=256,
                          seed=5)
    coord = CoordinatorServer(log_dir=str(tmp / "coord-logs"),
                              steps=StepTracker())
    srv, coord_url = coord.serve_background()
    env = dict(os.environ, JAX_PLATFORMS="cpu", TPU_JOB_ID="jax-run",
               TPU_COORDINATOR_ADDRESS="127.0.0.1:1", TPU_PEAK_TFLOPS="989",
               TPU_TRAIN_METRICS_PORT="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=str(ROOT))
    for k in ("TPU_ACCELERATOR_TYPE", "TPU_WORKER_HOSTNAMES",
              "TPU_NUM_PROCESSES", "MEGASCALE_NUM_SLICES"):
        env.pop(k, None)
    proc = subprocess.Popen(
        [sys.executable, __file__, str(tmp / "jax.json"), coord_url, "--",
         *_argv(tmp, "jax"), "--tp", "1"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    mp = pytest.MonkeyPatch()
    try:
        for k in ("TPU_ACCELERATOR_TYPE", "TPU_WORKER_HOSTNAMES",
                  "TPU_NUM_PROCESSES", "MEGASCALE_NUM_SLICES"):
            mp.delenv(k, raising=False)
        mp.setenv("TPU_COORDINATOR_ADDRESS", "127.0.0.1:1")
        mp.setenv("TPU_PEAK_TFLOPS", "989")
        ours = _port_runs(tmp, coord_url, mp)
        out, _ = proc.communicate(timeout=400)
        assert proc.returncode == 0, out[-3000:]
        ref = json.loads((tmp / "jax.json").read_text())
        yield {"ours": ours, "ref": ref, "coord": coord}
    finally:
        mp.undo()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        srv.shutdown()
        srv.server_close()


def test_batches_and_saves_match_jax_over_interrupt_and_resume(runs):
    ours, ref = runs["ours"], runs["ref"]
    assert [f[:2] for f in ours["fed"]] == [f[:2] for f in ref["fed"]]
    for a, b in zip(ours["fed"], ref["fed"]):
        np.testing.assert_array_equal(a[2], b[2])
    # Run 0 trained steps 1-2 and saved 2; run 1 resumed at 2, trained 3-5
    # on the seed's first batches again, saved 4 and the final 5; run 2
    # found step 5 done and neither trained nor saved.
    assert [f[:2] for f in ours["fed"]] == [[0, 1], [0, 2], [1, 3], [1, 4],
                                            [1, 5]]
    np.testing.assert_array_equal(ours["fed"][2][2], ours["fed"][0][2])
    assert ours["saves"] == ref["saves"] == [[0, 2], [1, 4], [1, 5]]
    assert ours["on_disk"] == ref["on_disk"] == [2, 4, 5]


def _normalised(events):
    out = []
    for ev in events:
        ev = {k: v for k, v in ev.items()
              if k not in ("id", "received_at", "received_seq", "ts", "dur",
                           "job_id")}
        args = dict(ev["args"])
        for k in ("dur_s", "collective_wait_s", "tokens_per_sec"):
            if k in args:
                assert isinstance(args.pop(k), float)
        if "loss" in args:
            assert math.isfinite(args.pop("loss"))
        ev["args"] = args
        out.append(ev)
    return out


def test_events_match_jax_and_reach_the_step_tracker(runs):
    coord = runs["coord"]
    ours = coord.list_events(job_id="torch-run")
    ref = coord.list_events(job_id="jax-run")
    assert _normalised(ours) == _normalised(ref)
    # Beats go out two at a time: step 5's waits for a batch that never
    # fills, in both launchers.
    beats = [e for e in ours if e["name"] == "step_heartbeat"]
    assert [e["args"]["step"] for e in beats] == [1, 2, 3, 4]
    meta = tllama.init_params(tllama.CONFIGS["llama_tiny"], None, "meta")
    assert beats[1]["args"]["n_params"] == sum(
        p.numel() for p in tts.tree_leaves(meta))
    assert beats[1]["args"]["device_count"] == 1
    assert beats[1]["args"]["peak_tflops"] == 989.0
    steps = [e["args"]["step"] for e in ours if e["name"] == "train_step"]
    assert steps == [1, 2, 3, 4, 5]
    for job in ("torch-run", "jax-run"):
        doc = coord.steps.job_doc(job)
        assert [h["host"] for h in doc["hosts"]] == ["s0w0"]
        assert doc["hosts"][0]["last_step"] == 4   # the last full batch
        assert doc["mfu"] is not None


def test_metrics_serves_the_five_gauges(runs):
    text = runs["ours"]["metrics"]
    values = {}
    for ln in text.splitlines():
        m = re.fullmatch(r"(tpu_train_\w+) (\S+)", ln)
        if m:
            values[m.group(1)] = float(m.group(2))
    assert set(values) == {name for name, _ in launcher.TRAIN_GAUGES}
    assert values["tpu_train_step"] == 2.0
    assert all(math.isfinite(v) and v > 0 for v in values.values())
    for name, help_text in launcher.TRAIN_GAUGES:
        assert f"# HELP {name} {help_text}" in text
        assert f"# TYPE {name} gauge" in text


def test_a_coordinator_gone_stops_the_posting_not_the_run(tmp_path,
                                                         monkeypatch, capsys):
    port = _free_port()                  # nothing listens there
    monkeypatch.setenv("TPU_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("TPU_TRAIN_METRICS_PORT", "0")
    monkeypatch.setattr(coordinator_client, "dashboard_url",
                        lambda address: f"http://127.0.0.1:{port}")
    posts = []
    real = coordinator_client.CoordinatorClient.post_events

    def post_events(self, events):
        posts.append(len(events))
        return real(self, events)

    monkeypatch.setattr(coordinator_client.CoordinatorClient, "post_events",
                        post_events)
    assert launcher.main(["--model", "llama_tiny", "--steps", "4",
                          "--batch", "1", "--seq-len", "8", "--log-every",
                          "1", "--device", "cpu"]) == 0
    assert posts == [1]                  # the first beat failed: no more
    assert len([ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("step ")]) == 4


@pytest.mark.parametrize("shuffle", [True, False])
def test_native_loader_gives_the_numpy_batches(tmp_path, shuffle):
    path = str(tmp_path / "shard.bin")
    tdata.synthetic_shard(path, 17 * 10 + 5, vocab=1000, seed=4)
    native = tdata.TokenShardLoader(path, seq_len=16, batch=4, seed=7,
                                    shuffle=shuffle)
    plain = tdata.TokenShardLoader(path, seq_len=16, batch=4, seed=7,
                                   shuffle=shuffle, prefer_native=False)
    assert native.backend == "native" and plain.backend == "numpy"
    assert native.num_windows == plain.num_windows == 10
    for _ in range(4):                   # 16 windows: crosses an epoch
        a, b = native.next(), plain.next()
        for k in ("tokens", "targets"):
            assert a[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    native.close()
    plain.close()
    with pytest.raises(RuntimeError, match="closed"):
        native.next()


class _Interrupted(Exception):
    pass


def _jax_launcher_runs() -> None:
    """The JAX package's launcher, run → interrupted → resumed → rerun:

        python tests/test_torch_train_runtime.py OUT COORD_URL -- ARGS...

    In its own process so that JAX sees one CPU device, as the port's
    launcher trains on one (the test harness gives JAX eight).  Patches,
    in this process only, the coordinator's URL (the launcher derives the
    dashboard port from ``TPU_COORDINATOR_ADDRESS``),
    ``make_sharded_train_fns``'s step function (it records the tokens fed
    at each global step and raises at step INTERRUPT_AT of the first run)
    and the checkpoint writer's ``save_async`` (it records each save).
    Writes OUT: the steps fed and saved by each run, the steps on disk."""
    from kuberay_tpu.runtime import coordinator_client as jclient
    from kuberay_tpu.train import checkpoint as jckpt
    from kuberay_tpu.train import train_step as jts

    out_path, coord_url = sys.argv[1:3]
    argv = sys.argv[sys.argv.index("--") + 1:]
    jclient.dashboard_url = lambda address: coord_url
    real = jts.make_sharded_train_fns
    real_save = jckpt.CheckpointWriter.save_async
    fed, saves = [], []
    run = {"n": 0}

    def save_async(self, state, step):
        saves.append([run["n"], step])
        return real_save(self, state, step)

    def patched(*args, **kwargs):
        init, step_fn, shardings = real(*args, **kwargs)

        def step(state, batch):
            s = int(state["step"]) + 1
            if run["n"] == 0 and s == INTERRUPT_AT:
                raise _Interrupted(f"step {s}")
            fed.append([run["n"], s, np.asarray(batch["tokens"]).tolist()])
            return step_fn(state, batch)

        step.batch_sharding = getattr(step_fn, "batch_sharding", None)
        return init, step, shardings

    jts.make_sharded_train_fns = patched
    jckpt.CheckpointWriter.save_async = save_async
    try:
        jlauncher.main(argv)
    except _Interrupted:
        pass
    for n in (1, 2):
        run["n"] = n
        rc = jlauncher.main(argv)
        if rc != 0:
            raise SystemExit(f"run {n}: launcher returned {rc}")
    ckpt_dir = argv[argv.index("--checkpoint-dir") + 1]
    on_disk = sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit())
    with open(out_path, "w") as f:
        json.dump({"fed": fed, "saves": saves, "on_disk": on_disk}, f)


if __name__ == "__main__":
    _jax_launcher_runs()
