"""PyTorch port, serving engine: greedy tokens identical to the JAX engine's
on one llama_tiny parameter tree, and the sampler's filter semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.serve import engine as jeng
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.serve import engine as teng

torch.set_num_threads(2)

JCFG = jllama.CONFIGS["llama_tiny"]
TCFG = tllama.CONFIGS["llama_tiny"]


@pytest.fixture(scope="module")
def trees():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def jax_engine(trees):
    """One JAX engine for the module (its jitted steps compile once);
    greedy outputs do not depend on what it served before."""
    return jeng.ServeEngine(JCFG, trees[0], max_slots=2, max_len=64)


def _run(eng, reqs):
    for r in reqs:
        eng.add_request(r)
    return {r.request_id: (r.tokens, r.finish_reason) for r in eng.run()}


def _both(trees, jax_engine, specs, max_slots=2, max_len=64):
    """Run the same requests through the JAX engine and a fresh port engine.
    specs: (request_id, prompt, kwargs)."""
    want = _run(jax_engine, [jeng.Request(i, p, **kw) for i, p, kw in specs])
    eng = teng.ServeEngine(TCFG, trees[1], max_slots=max_slots,
                           max_len=max_len, device="cpu")
    got = _run(eng, [teng.Request(i, p, **kw) for i, p, kw in specs])
    return want, got, eng


def test_single_request_matches_jax(trees, jax_engine):
    want, got, eng = _both(trees, jax_engine,
                           [("r", [5, 17, 42, 7], {"max_new_tokens": 8})])
    assert got == want and len(got["r"][0]) == 8
    assert eng.stats["prefills"] == 1 and eng.stats["decode_steps"] == 7


def test_continuous_batching_three_requests_two_slots(trees, jax_engine):
    specs = [(f"r{i}", [3 + i, 9, 27 + i, 1], {"max_new_tokens": 5 + i})
             for i in range(3)]
    want, got, eng = _both(trees, jax_engine, specs)
    assert got == want
    assert {k: len(v[0]) for k, v in got.items()} == {"r0": 5, "r1": 6,
                                                      "r2": 7}
    assert not eng.has_work() and eng.num_active == 0


def test_slot_isolation(trees, jax_engine):
    """A request's tokens do not depend on its neighbours, and a neighbour
    admitted mid-decode does not corrupt its cache."""
    prompt = [9, 8, 7]
    want, solo, _ = _both(trees, jax_engine,
                          [("a", prompt, {"max_new_tokens": 8})])
    assert solo == want
    eng = teng.ServeEngine(TCFG, trees[1], max_slots=2, max_len=64,
                           device="cpu")
    eng.add_request(teng.Request("a", prompt, max_new_tokens=8))
    eng.step()
    eng.step()
    eng.add_request(teng.Request("b", [40, 41, 42, 43], max_new_tokens=8))
    busy = {r.request_id: r.tokens for r in eng.run()}
    assert busy["a"] == solo["a"][0] and len(busy["b"]) == 8


def test_eos_and_stop_token_ids(trees, jax_engine):
    probe, _, _ = _both(trees, jax_engine,
                        [("p", [1, 2, 3], {"max_new_tokens": 10})])
    toks = probe["p"][0]
    specs = [("eos", [1, 2, 3], {"max_new_tokens": 10, "eos_token": toks[0]}),
             ("stop", [1, 2, 3], {"max_new_tokens": 10,
                                  "stop_token_ids": [9999, toks[2]]})]
    want, got, _ = _both(trees, jax_engine, specs)
    assert got == want
    assert got["eos"] == ([toks[0]], "eos")
    assert got["stop"][1] == "eos"
    assert got["stop"][0] == toks[:toks.index(toks[2]) + 1]


def test_oversize_prompt_and_zero_budget_cancelled(trees, jax_engine):
    specs = [("big", list(range(64)), {"max_new_tokens": 4}),
             ("zero", [1, 2], {"max_new_tokens": 0})]
    want, got, _ = _both(trees, jax_engine, specs)
    assert got == want == {"big": ([], "cancelled"),
                           "zero": ([], "cancelled")}


def test_length_cap_and_ttft(trees, jax_engine):
    """A request that reaches max_len stops with "length", as in JAX; TTFT
    rides every non-cancelled response."""
    specs = [("long", list(range(1, 58)), {"max_new_tokens": 20})]
    want, got, _ = _both(trees, jax_engine, specs)
    assert got == want and got["long"][1] == "length"
    eng = teng.ServeEngine(TCFG, trees[1], max_slots=1, max_len=64,
                           device="cpu")
    eng.add_request(teng.Request("t", [1, 2], max_new_tokens=2))
    (resp,) = eng.run()
    assert resp.ttft_s is not None and resp.ttft_s > 0
    assert resp.prompt_len == 2


@pytest.mark.parametrize("n,max_len", [(1, 2048), (5, 2048), (32, 2048),
                                       (33, 2048), (1000, 2048),
                                       (9999, 2048), (100, 64), (40, 48)])
def test_bucket_matches_jax(n, max_len):
    assert teng._bucket(n, max_len) == jeng._bucket(n, max_len)


@pytest.mark.parametrize("temp,top_p,top_k", [
    (0.0, 1.0, 0), (0.0, 0.5, 2), (1.0, 1.0, 0), (5.0, 1.0, 0),
    (1.0, 1.0, 1), (5.0, 1.0, 2), (1.0, 1e-6, 0), (1.0, 0.5, 0),
    (0.7, 0.9, 3)])
def test_sampler_matches_jax_with_shared_noise(temp, top_p, top_k):
    """jax.random.categorical is the Gumbel-max trick: feed the port the
    Gumbel noise the JAX sampler draws from each key, and the two samplers
    must pick the same token, filtered and plain."""
    logits_np = np.array([2.0, 1.0, 0.5, -1.0, -3.0, 0.25, 1.5], np.float32)
    logits = jnp.asarray(logits_np)
    samp = jnp.asarray([temp, top_p, float(top_k)], jnp.float32)
    samp_t = torch.tensor([[temp, top_p, float(top_k)]])
    for i in range(40):
        key = jax.random.PRNGKey(i)
        noise = torch.tensor(np.asarray(
            jax.random.gumbel(key, logits.shape, jnp.float32)))[None]
        want = int(jeng.ServeEngine._sample(logits, key, samp))
        got = teng.ServeEngine._sample(torch.from_numpy(logits_np)[None],
                                       samp_t, noise)
        assert int(got[0]) == want, (i, temp, top_p, top_k)
        if top_p == 1.0 and top_k == 0:
            plain = teng.ServeEngine._sample_plain(
                torch.from_numpy(logits_np)[None], samp_t, noise)
            assert int(plain[0]) == int(jeng.ServeEngine._sample_plain(
                logits, key, samp))


def test_sampled_requests_deterministic_under_seed(trees):
    def run(seed):
        eng = teng.ServeEngine(TCFG, trees[1], max_slots=2, max_len=64,
                               rng_seed=seed, device="cpu")
        return _run(eng, [
            teng.Request("s", [1, 2, 3], max_new_tokens=8, temperature=0.9,
                         top_p=0.8, top_k=12),
            teng.Request("g", [4, 5], max_new_tokens=8)])

    a, b = run(0), run(0)
    assert a == b and len(a["s"][0]) == 8 and len(a["g"][0]) == 8
