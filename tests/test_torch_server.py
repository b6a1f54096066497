"""PyTorch port, HTTP frontend: /v1/completions over a real socket, with a
CPU engine; same wire format and rejections as the JAX server."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.serve import engine as jeng
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.serve.engine import ServeEngine
from kuberay_tpu_torch.serve.server import ServeFrontend

torch.set_num_threads(2)

TCFG = tllama.CONFIGS["llama_tiny"]


@pytest.fixture(scope="module")
def served():
    jp = jllama.init_params(jllama.CONFIGS["llama_tiny"], jax.random.PRNGKey(0))
    tp = params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")
    fe = ServeFrontend(ServeEngine(TCFG, tp, max_slots=2, max_len=64,
                                   device="cpu"))
    srv, url = fe.serve_background()
    yield fe, url, jp
    srv.shutdown()
    srv.server_close()
    fe.close()
    assert not fe._thread.is_alive()


def _post(url, body, timeout=60):
    req = urllib.request.Request(
        f"{url}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), json.load(resp)


def _get(url, path):
    with urllib.request.urlopen(f"{url}{path}", timeout=30) as resp:
        return resp.status, json.load(resp)


def test_completion_round_trip_matches_jax_engine(served):
    fe, url, jp = served
    status, headers, body = _post(url, {"prompt_tokens": [5, 6, 7],
                                        "max_tokens": 4})
    assert status == 200
    assert headers["X-TPU-Queue-Depth"].isdigit()
    assert headers["X-TPU-Active-Slots"].isdigit()
    assert set(body) == {"id", "tokens", "finish_reason", "prompt_len",
                         "ttft_ms"}
    assert body["finish_reason"] == "length" and body["prompt_len"] == 3
    assert isinstance(body["ttft_ms"], float) and body["ttft_ms"] > 0
    eng = jeng.ServeEngine(jllama.CONFIGS["llama_tiny"], jp, max_slots=2,
                           max_len=64)
    eng.add_request(jeng.Request("r", [5, 6, 7], max_new_tokens=4))
    assert body["tokens"] == eng.run()[0].tokens


def test_concurrent_requests_and_stats(served):
    fe, url, _ = served
    results, errors = {}, []

    def worker(i):
        try:
            results[i] = _post(url, {"prompt_tokens": [10 + i, 20 + i],
                                     "max_tokens": 3})
        except urllib.error.URLError as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert all(r[0] == 200 and len(r[2]["tokens"]) == 3
               for r in results.values())
    status, stats = _get(url, "/stats")
    assert status == 200 and stats["completed"] >= 4
    assert stats["decode_steps"] > 0 and stats["active_slots"] == 0
    assert _get(url, "/healthz") == (200, {"status": "ok"})


@pytest.mark.parametrize("body,code", [
    ({}, 400), ({"prompt_tokens": []}, 400), ({"prompt_tokens": "abc"}, 400),
    ({"prompt_tokens": [1.5]}, 400), ({"prompt_tokens": [256]}, 400),
    ({"prompt_tokens": [-1]}, 400),
    ({"prompt_tokens": [1], "max_tokens": 0}, 400),
    ({"prompt_tokens": [1], "top_p": 0.0}, 400),
    ({"prompt_tokens": [1], "top_k": -1}, 400),
    ({"prompt_tokens": [1], "max_tokens": "x"}, 400),
    ({"prompt_tokens": [1], "stop_token_ids": "x"}, 400),
    ({"prompt_tokens": [1], "stream": True, "max_tokens": 0}, 400),
])
def test_bad_requests_rejected(served, body, code):
    _, url, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    assert e.value.code == code


def test_unknown_paths_404(served):
    _, url, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url, "/nope")
    assert e.value.code == 404
