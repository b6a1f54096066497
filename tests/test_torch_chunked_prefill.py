"""PyTorch port, chunked prefill: long prompts stream into the cache in
fixed chunks with decode steps in between, without changing the tokens.
The port's chunked tokens equal the JAX engine's chunked tokens and its
own unchunked ones, dense and paged (with prefix caching, memory blocking
and cancellation).  Mirrors ``tests/test_chunked_prefill.py``.

Inputs come from numpy with a fixed seed and go to both packages; the JAX
engines run with ``decode_impl="xla"``, the port's on CPU tensors."""

import jax
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.serve import engine as jeng
from kuberay_tpu.serve import paged_engine as jpe
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.serve import engine as teng
from kuberay_tpu_torch.serve import paged_engine as tpe

torch.set_num_threads(2)

JCFG = jllama.CONFIGS["llama_tiny"]
TCFG = tllama.CONFIGS["llama_tiny"]
SHARED = list(range(1, 25))                   # 3 full 8-token blocks


def prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, JCFG.vocab_size, size=n).tolist()
            for n in (3, 17, 40, 9, 33)]


def run_all(engine, cls):
    for i, p in enumerate(prompts()):
        engine.add_request(cls(f"r{i}", p, max_new_tokens=8))
    return {r.request_id: (r.tokens, r.finish_reason) for r in engine.run()}


def dense(tp, chunk=0, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 128)
    return teng.ServeEngine(TCFG, tp, prefill_chunk=chunk, device="cpu",
                            **kw)


def paged(tp, chunk=0, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 128)
    kw.setdefault("block_size", 8)
    return tpe.PagedServeEngine(TCFG, tp, prefill_chunk=chunk, device="cpu",
                                **kw)


def prefix_repeat(make, cls):
    """A warm run then a repeat of one 3-block prompt: (repeat's tokens,
    prefix hit tokens)."""
    eng = make()
    eng.add_request(cls("warm", SHARED + [40], max_new_tokens=4))
    eng.run()
    eng.add_request(cls("again", SHARED + [40], max_new_tokens=4))
    return eng.run()[0].tokens, eng.stats["prefix_hit_tokens"]


@pytest.fixture(scope="module")
def trees():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def tp(trees):
    return trees[1]


@pytest.fixture(scope="module")
def jax_ref(trees):
    """The JAX engines' chunked results, computed once for the module."""
    jp = trees[0]
    jd = jeng.ServeEngine(JCFG, jp, max_slots=4, max_len=128,
                          prefill_chunk=8)

    def jpaged():
        return jpe.PagedServeEngine(JCFG, jp, max_slots=4, max_len=128,
                                    block_size=8, prefill_chunk=8,
                                    decode_impl="xla")
    return {"dense": run_all(jd, jeng.Request),
            "paged": run_all(jpaged(), jeng.Request),
            "prefix": prefix_repeat(jpaged, jeng.Request)}


def test_chunked_tokens_equal_jax_and_unchunked(tp, jax_ref):
    got = run_all(dense(tp, 8), teng.Request)
    assert got == jax_ref["dense"]
    assert got == run_all(dense(tp), teng.Request)


def test_chunk_equal_to_prompt_is_whole_prefill(tp):
    assert run_all(dense(tp, 64), teng.Request) == \
        run_all(dense(tp), teng.Request)


def test_every_prefill_call_has_the_chunk_shape(tp):
    """Every prefill call is one chunk-long row, whatever the prompt's
    length, and each chunk counts in ``prefills``."""
    eng = dense(tp, 8)
    shapes = []
    real = eng._prefill_forward

    def spy(tokens, *a, **kw):
        shapes.append(tuple(tokens.shape))
        return real(tokens, *a, **kw)
    eng._prefill_forward = spy
    run_all(eng, teng.Request)
    assert set(shapes) == {(1, 8)}
    assert eng.prefills == len(shapes) == \
        sum(-(-len(p) // 8) for p in prompts())


def test_decode_interleaves_with_long_prefill(tp):
    """While a long prompt streams in chunk by chunk, an active slot keeps
    generating."""
    eng = dense(tp, 8)
    eng.add_request(teng.Request("short", [5, 6, 7], max_new_tokens=30))
    eng.step()
    assert eng.num_active == 1
    eng.add_request(teng.Request("long", list(range(1, 41)),
                                 max_new_tokens=4))
    progressed = 0
    while eng._inflight is not None or eng.queue:
        before = len(eng.generated[0]) if eng.active[0] else 0
        eng.step()
        after = len(eng.generated[0]) if eng.active[0] else before
        if eng._inflight is not None and after > before:
            progressed += 1
    assert progressed >= 3            # 5 chunks of 8
    out = {r.request_id for r in eng.run()}
    assert "long" in out and ("short" in out or eng.num_active == 0)


def test_at_most_one_chunk_per_step(tp):
    """Even on the step where an admission's last chunk lands, the next
    request waits: the per-step stall is one chunk."""
    eng = dense(tp, 8, max_slots=4)
    for i in range(3):
        eng.add_request(teng.Request(f"r{i}", list(range(1, 20)),
                                     max_new_tokens=2))
    per_step = []
    while eng.has_work():
        before = eng.prefills
        eng.step()
        per_step.append(eng.prefills - before)
    assert max(per_step) == 1 and sum(per_step) == 9


def test_paged_chunked_equals_jax_and_whole_prompt(tp, jax_ref):
    got = run_all(paged(tp, 8), teng.Request)
    assert got == jax_ref["paged"]
    assert got == run_all(paged(tp), teng.Request)


def test_paged_chunked_prefix_caching(tp, jax_ref):
    """A repeat under chunked prefill reuses the cached blocks, reproduces
    the cold tokens, and hits as many prefix tokens as JAX's."""
    cold = paged(tp, 8)
    cold.add_request(teng.Request("a", SHARED + [40], max_new_tokens=4))
    expected = cold.run()[0].tokens
    tokens, hits = prefix_repeat(lambda: paged(tp, 8), teng.Request)
    assert tokens == expected
    assert (tokens, hits) == jax_ref["prefix"] and hits == len(SHARED)


def test_paged_chunked_memory_blocking_and_recovery(tp):
    """29-token prompts need 4 blocks each; in a 5-block pool "b" waits
    for "a" to release, leaks nothing, and then runs."""
    eng = paged(tp, 8, max_slots=2, num_blocks=5)
    eng.add_request(teng.Request("a", list(range(1, 30)), max_new_tokens=3))
    eng.add_request(teng.Request("b", list(range(31, 60)), max_new_tokens=3))
    out = eng.run()
    assert sorted(r.request_id for r in out) == ["a", "b"]
    assert all(r.finish_reason in ("length", "eos") for r in out)
    assert eng.stats["free_blocks"] == eng.stats["num_blocks"]


def test_paged_chunked_impossible_prompt_cancelled(tp):
    eng = paged(tp, 8, max_slots=1, num_blocks=4)
    eng.add_request(teng.Request("big", list(range(1, 100)),
                                 max_new_tokens=2))
    eng.add_request(teng.Request("ok", [2] * 6, max_new_tokens=3))
    by_id = {r.request_id: r for r in eng.run(max_steps=50)}
    assert by_id["big"].finish_reason == "cancelled"
    assert len(by_id["ok"].tokens) == 3


def test_inflight_slot_reuse(tp):
    """The chunking slot is reserved; admissions resume after its prefill,
    and nothing deadlocks with every slot taken."""
    eng = dense(tp, 8, max_slots=2)
    for i in range(4):
        eng.add_request(teng.Request(f"r{i}", list(range(1, 20)),
                                     max_new_tokens=3))
    out = eng.run()
    assert sorted(r.request_id for r in out) == ["r0", "r1", "r2", "r3"]
    assert all(len(r.tokens) == 3 for r in out)
    assert eng._inflight is None and not eng.has_work()
