"""PyTorch port, the server's side of the train-to-serve handoff and of
the coordinator, vs the JAX server, on ``llama_tiny``.

- ``--checkpoint-dir`` serves the checkpoint's weights: a JAX train state
  after one step, saved by the port through ``state_from_jax``, gives the
  greedy tokens that the JAX server's path (the JAX package's Orbax save,
  ``load_params_for_serving``, its engine on the XLA decode path) gives;
  not seed 0's.  A missing checkpoint is a usage error.
- With ``--coordinator`` the app reaches RUNNING on a live
  ``CoordinatorServer`` once it serves, and STOPPED after SIGTERM, before
  it reports ``drained=True``.
- ``--config-from-coordinator`` applies an app block end to end (model,
  paged pool, speculation, int8 weights, checkpoint: the JAX engine's
  int8-weight tokens on the same checkpoint); every ``_CONFIG_KEYS`` coercion
  or choice error, and the wait's and the missing coordinator's, is the
  JAX server's text; ``tp`` and the ``group_*`` keys are honoured as the
  JAX server honours them; ``decode_impl`` other than ``auto`` is refused
  (the port has one decode path).  A slice of several processes is taken
  (``tests/test_torch_multihost_serve.py`` serves one), and a tp other
  than its size is refused with the JAX server's text.
"""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.runtime.coordinator_client import CoordinatorClient
from kuberay_tpu.runtime.coordinator_server import CoordinatorServer
from kuberay_tpu.serve import server as jserver
from kuberay_tpu.serve.engine import Request as JRequest
from kuberay_tpu.serve.engine import ServeEngine as JServeEngine
from kuberay_tpu.train import checkpoint as jckpt
from kuberay_tpu.train import train_step as jts
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import state_from_jax
from kuberay_tpu_torch.serve import server
from kuberay_tpu_torch.serve.engine import Request, ServeEngine
from kuberay_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = ([5, 17, 3, 99, 42], [7, 7, 200, 1, 13, 64, 9])
MAX_TOKENS = 8


@pytest.fixture(scope="module")
def handoff(tmp_path_factory):
    """One JAX train step; its Orbax checkpoint and greedy tokens through
    the JAX server's path, and the port's checkpoint of the same state."""
    tmp = tmp_path_factory.mktemp("handoff")
    cfg = jllama.CONFIGS["llama_tiny"]
    tc = jts.TrainConfig(warmup_steps=1, decay_steps=10, learning_rate=3e-2)
    opt = jts.make_optimizer(tc)
    state = jts.init_train_state(cfg, opt, jax.random.PRNGKey(3))
    step = jts.make_train_step(cfg, tc, opt)
    tokens = jax.random.randint(jax.random.PRNGKey(4), (2, 16), 0,
                                cfg.vocab_size)
    for _ in range(2):
        state, _ = step(state, {"tokens": tokens,
                                "targets": jnp.roll(tokens, -1, 1)})
    jd, td = str(tmp / "jax"), str(tmp / "torch")
    jckpt.save(jd, state, 2)
    params = jckpt.load_params_for_serving(jd, dtype=cfg.dtype)
    tokens = {}
    for quant in ("none", "int8"):
        eng = JServeEngine(cfg, params, max_slots=2, max_len=64,
                           decode_impl="xla", weight_quant=quant)
        for i, p in enumerate(PROMPTS):
            eng.add_request(JRequest(f"r{i}", p, max_new_tokens=MAX_TOKENS))
        want = {r.request_id: r.tokens for r in eng.run()}
        tokens[quant] = [want[f"r{i}"] for i in range(len(PROMPTS))]
    ckpt.save(td, state_from_jax(tllama.CONFIGS["llama_tiny"],
                                 jax.tree.map(np.asarray, state), "cpu"), 2)
    return {"dir": td, "tokens": tokens["none"], "int8": tokens["int8"]}


@pytest.fixture(scope="module")
def coordinator(tmp_path_factory):
    coord = CoordinatorServer(
        log_dir=str(tmp_path_factory.mktemp("coord-logs")))
    srv, url = coord.serve_background()
    yield url
    srv.shutdown()
    srv.server_close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Server:
    """The port's server as a process, its output read as it comes."""

    def __init__(self, *flags):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.lines = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kuberay_tpu_torch.serve.server",
             "--device", "cpu", "--host", "127.0.0.1", "--port",
             str(self.port), *flags],
            env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for ln in self.proc.stdout:
            self.lines.append(ln.rstrip("\n"))

    def wait_for(self, prefix: str, timeout: float = 120.0) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            hit = [ln for ln in self.lines if ln.startswith(prefix)]
            if hit:
                return hit[0]
            assert self.proc.poll() is None, "\n".join(self.lines[-40:])
            time.sleep(0.05)
        raise AssertionError(f"no {prefix!r} line: {self.lines[-40:]}")

    def complete(self, prompt) -> list:
        req = urllib.request.Request(
            f"{self.url}/v1/completions",
            data=json.dumps({"prompt_tokens": prompt,
                             "max_tokens": MAX_TOKENS}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.load(resp)["tokens"]

    def stop(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=60)
        self._reader.join(timeout=10)
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def test_checkpoint_serves_the_trained_weights_and_reports_to_the_coordinator(
        handoff, coordinator):
    client = CoordinatorClient(coordinator)
    srv = _Server("--model", "llama_tiny", "--max-slots", "2", "--max-len",
                  "64", "--checkpoint-dir", handoff["dir"], "--app-name",
                  "handoff", "--coordinator", coordinator)
    try:
        srv.wait_for("serving llama_tiny")
        assert any(ln.startswith("restored params from") for ln in srv.lines)
        assert client.get_serve_apps()["handoff"]["status"] == "RUNNING"
        got = [srv.complete(p) for p in PROMPTS]
        assert srv.stop() == 0
    finally:
        srv.kill()
    assert got == handoff["tokens"]
    assert "serve: drained=True" in srv.lines
    assert client.get_serve_apps()["handoff"]["status"] == "STOPPED"
    # Seed 0's random weights would have said something else.
    cfg = tllama.CONFIGS["llama_tiny"]
    eng = ServeEngine(cfg, tllama.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), max_slots=2,
        max_len=64, device="cpu")
    for i, p in enumerate(PROMPTS):
        eng.add_request(Request(f"r{i}", p, max_new_tokens=MAX_TOKENS))
    seed0 = {r.request_id: r.tokens for r in eng.run()}
    assert [seed0[f"r{i}"] for i in range(len(PROMPTS))] != got


def test_config_from_coordinator_end_to_end(handoff, coordinator):
    """The controller's PUT of a serve config; a server started with other
    flags boots the app block's paged engine on the checkpoint, its
    leaves quantised to int8 as the JAX engine quantises them."""
    client = CoordinatorClient(coordinator)
    client.update_serve_apps({"applications": [{
        "name": "cfgapp", "model": "llama_tiny", "paged": True,
        "block_size": 8, "max_slots": 2, "max_len": 64, "speculative": 2,
        "weight_quant": "int8", "checkpoint_dir": handoff["dir"], "tp": 1,
        "host_blocks": 0, "decode_impl": "auto"}]})
    srv = _Server("--model", "llama_1b", "--app-name", "cfgapp",
                  "--coordinator", coordinator, "--config-from-coordinator")
    try:
        srv.wait_for("serving llama_tiny")
        stats = json.load(urllib.request.urlopen(f"{srv.url}/stats",
                                                 timeout=10))
        assert "free_blocks" in stats
        assert client.get_serve_apps()["cfgapp"]["status"] == "RUNNING"
        got = [srv.complete(p) for p in PROMPTS]
        assert srv.stop() == 0
    finally:
        srv.kill()
    assert got == handoff["int8"]
    assert "paged KV cache" in srv.wait_for("serving")
    assert client.get_serve_apps()["cfgapp"]["status"] == "STOPPED"


def test_missing_checkpoint_is_a_usage_error(tmp_path, handoff, capsys):
    missing = tmp_path / "none"
    with pytest.raises(SystemExit) as e:
        server.main(["--model", "llama_tiny", "--device", "cpu",
                     "--checkpoint-dir", str(missing)])
    assert e.value.code == 2
    assert f"no checkpoint found in {missing}" in capsys.readouterr().err
    assert not missing.exists()
    with pytest.raises(SystemExit):
        server.main(["--model", "llama_tiny", "--device", "cpu",
                     "--checkpoint-dir", handoff["dir"],
                     "--checkpoint-step", "7"])
    assert "at step 7" in capsys.readouterr().err


def test_server_refuses_a_slice_of_many_processes(monkeypatch, capsys):
    """A slice of two processes serves tp=2 (it is taken: the group's
    rendezvous would follow), but not a tp other than its size, which the
    JAX server refuses with the same text."""
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a,b")
    with pytest.raises(SystemExit) as e:
        server.main(["--model", "llama_tiny", "--device", "cpu",
                     "--tp", "4"])
    assert e.value.code == 2
    assert ("multi-host serving requires tp == total chips (2); got --tp "
            "4. Use --tp 0 (auto)") in capsys.readouterr().err


class _ApError(Exception):
    pass


class _Ap:
    def error(self, msg):
        raise _ApError(msg)


def _apply(fn, url, app, block, wait=5.0):
    """``fn`` (either server's ``_apply_coordinator_config``) on ``block``
    PUT as app ``app``: the parameter error's text, or the args."""
    CoordinatorClient(url).update_serve_apps(
        {"applications": [{"name": app, **block}]})
    args = argparse.Namespace(coordinator=url, config_wait=wait,
                              app_name=app)
    try:
        fn(args, _Ap())
    except _ApError as e:
        return str(e)
    return vars(args)


BAD = sorted(
    [(k, "x") for k, (c, ch) in jserver._CONFIG_KEYS.items()
     if c in (int, float)]
    + [(k, "bogus") for k, (c, ch) in jserver._CONFIG_KEYS.items() if ch])


def test_config_keys_are_the_jax_servers():
    assert server._CONFIG_KEYS == jserver._CONFIG_KEYS


@pytest.mark.parametrize("key,value", BAD)
def test_config_errors_give_the_jax_text(key, value, coordinator):
    app = f"bad-{key}"
    ours = _apply(server._apply_coordinator_config, coordinator, app,
                  {key: value})
    ref = _apply(jserver._apply_coordinator_config, coordinator, app,
                 {key: value})
    assert isinstance(ours, str) and ours == ref
    assert ours.startswith(f"serve config {key}=")


def test_wait_and_missing_coordinator_give_the_jax_text(coordinator):
    texts = []
    for fn in (server._apply_coordinator_config,
               jserver._apply_coordinator_config):
        waited = _apply(fn, coordinator, "a", {}, wait=0.0)
        args = argparse.Namespace(coordinator="", config_wait=0.0,
                                  app_name="a")
        with pytest.raises(_ApError) as e:
            fn(args, _Ap())
        texts.append((waited, str(e.value)))
    assert texts[0] == texts[1]
    assert "did not appear" in texts[0][0]
    assert "requires --coordinator" in texts[0][1]


@pytest.mark.parametrize("key,value,item", [
    ("decode_impl", "xla", "one decode path"),
    ("decode_impl", "pallas", "one decode path"),
    ("decode_impl", "pallas_interpret", "one decode path"),
])
def test_unported_keys_are_refused_naming_their_item(key, value, item,
                                                     coordinator):
    app = f"unported-{key}-{value}"
    ours = _apply(server._apply_coordinator_config, coordinator, app,
                  {key: value})
    assert isinstance(ours, str) and ours.startswith(
        f"serve config {key}={value!r}: ") and item in ours
    # The JAX server takes them.
    ref = _apply(jserver._apply_coordinator_config, coordinator, app,
                 {key: value})
    assert ref[key] == value


@pytest.mark.parametrize("key,value", [
    ("tp", 2), ("tp", 8), ("tp", 0),
    ("group_miss_timeout", 10.0), ("group_step_timeout", 60.0),
    ("group_compile_timeout", 900.0), ("group_budget_multiplier", 20.0)])
def test_tp_and_group_keys_are_honoured_as_the_jax_server_does(
        key, value, coordinator):
    """A TpuService's tensor parallelism and group-health overrides reach
    the port's args as they reach the JAX server's."""
    app = f"tp-{key}-{value}"
    ours = _apply(server._apply_coordinator_config, coordinator, app,
                  {key: value})
    ref = _apply(jserver._apply_coordinator_config, coordinator, app,
                 {key: value})
    assert ours == ref and ours[key] == value


@pytest.mark.parametrize("key,value", [("host_blocks", 64),
                                       ("spill_blocks", 1)])
def test_tier_keys_are_honoured_as_the_jax_server_does(key, value,
                                                       coordinator):
    """A kvTiers service's host_blocks / spill_blocks reach the port's
    args as they reach the JAX server's."""
    app = f"tiers-{key}-{value}"
    ours = _apply(server._apply_coordinator_config, coordinator, app,
                  {key: value})
    ref = _apply(jserver._apply_coordinator_config, coordinator, app,
                 {key: value})
    assert ours == ref and ours[key] == value


@pytest.mark.parametrize("raw,want", [("false", True), ("", False),
                                      (0, False), ("0", True)])
def test_paged_is_coerced_with_bool_as_the_jax_server_does(raw, want,
                                                           coordinator):
    """Both servers coerce the config's ``paged`` with ``bool(...)``, so
    the string "false" turns paging on: reference behaviour, pinned."""
    app = f"paged-{raw!r}"
    ours = _apply(server._apply_coordinator_config, coordinator, app,
                  {"paged": raw})
    ref = _apply(jserver._apply_coordinator_config, coordinator, app,
                 {"paged": raw})
    assert ours["paged"] is ref["paged"] is want


def test_keys_the_port_honours_are_applied(coordinator):
    block = {"model": "llama_tiny", "paged": True, "block_size": 8,
             "num_blocks": 64, "prefill_chunk": 16, "speculative": 2,
             "kv_quant": "int8", "weight_quant": "int8", "tp": 1,
             "max_slots": 2, "max_len": 64, "checkpoint_dir": "/ckpt",
             "checkpoint_step": 0, "host_blocks": 0, "spill_blocks": 0,
             "decode_impl": "auto"}
    ours = _apply(server._apply_coordinator_config, coordinator, "ok", block)
    ref = _apply(jserver._apply_coordinator_config, coordinator, "ok", block)
    assert ours == ref and {k: ours[k] for k in block} == block
