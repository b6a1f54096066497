"""PyTorch port, prompt-lookup speculation: the drafts equal the JAX
package's, the speculative tokens equal sequential greedy decoding and the
JAX engine's speculative tokens (with the same ``spec_stats``), dense and
paged; the drafting-fraction gate, the paged engine's capacity cap and
headroom release, and a canary in another request's block 0 that verify
steps must not touch.  Mirrors ``tests/test_speculative.py``.

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
PAGED_PROMPTS = [[7, 8, 9] * 12, [4, 5] * 10, list(range(20))]


def repetitive_prompts():
    """Prompts with internal repeats (drafts hit) and random ones."""
    rng = np.random.default_rng(7)
    rep = ([3, 4, 5, 6] * 6)[:20]
    rnd = rng.integers(1, JCFG.vocab_size, size=15).tolist()
    return [rep, rnd, rep[::-1] + rep, [9, 9, 9, 9, 9, 9]]


def run_all(engine, cls, temp=0.0, n=24):
    for i, p in enumerate(repetitive_prompts()):
        engine.add_request(cls(f"r{i}", p, max_new_tokens=n,
                               temperature=temp))
    return {r.request_id: (r.tokens, r.finish_reason) for r in engine.run()}


def run_paged(engine, cls):
    for i, p in enumerate(PAGED_PROMPTS):
        engine.add_request(cls(f"r{i}", p, max_new_tokens=16))
    return {r.request_id: r.tokens for r in engine.run()}


@pytest.fixture(scope="module")
def trees():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def tp(trees):
    return trees[1]


def dense(tp, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 128)
    return teng.ServeEngine(TCFG, tp, device="cpu", **kw)


def paged(tp, **kw):
    return tpe.PagedServeEngine(TCFG, tp, max_slots=3, max_len=128,
                                block_size=8, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_ref(trees):
    """The JAX engines' speculative results (tokens, spec_stats), computed
    once for the module."""
    jp = trees[0]
    d = jeng.ServeEngine(JCFG, jp, max_slots=4, max_len=128, speculative=4)
    p = jpe.PagedServeEngine(JCFG, jp, max_slots=3, max_len=128,
                             block_size=8, speculative=4, decode_impl="xla")
    return {"dense": (run_all(d, jeng.Request), dict(d.spec_stats)),
            "paged": (run_paged(p, jeng.Request), dict(p.spec_stats))}


# -- drafting ----------------------------------------------------------------

@pytest.mark.parametrize("hist,want", [
    ([1, 2, 3, 9, 9, 1, 2, 3], [9, 9, 1]),
    # trigram [8, 1, 2] never occurred; the latest bigram [1, 2] wins
    ([5, 1, 2, 7, 7, 1, 2, 8, 8, 1, 2], [8, 8, 1]),
    ([1, 2, 3, 4], []),
    ([1], []),
])
def test_prompt_lookup_draft_matches_jax(hist, want):
    assert teng.prompt_lookup_draft(hist, 3) == want
    assert jeng.prompt_lookup_draft(hist, 3) == want


@pytest.mark.parametrize("seed,alphabet", [(11, 6), (3, 3), (5, 40)])
def test_ngram_index_matches_scan_and_jax(seed, alphabet):
    """The incremental index drafts what the reference scan and the JAX
    index draft, at every history length of a seeded history."""
    hist = np.random.default_rng(seed).integers(
        1, alphabet, size=200).tolist()
    idx, jidx = teng.NgramIndex(), jeng.NgramIndex()
    for upto in range(2, len(hist) + 1):
        h = hist[:upto]
        idx.extend(h)
        jidx.extend(h)
        got = idx.draft(h, 4)
        assert got == teng.prompt_lookup_draft(h, 4) == jidx.draft(h, 4), upto


def test_ngram_index_prunes_out_of_window_entries():
    """The maps are bounded by the window (plus one prune period), as the
    JAX index's, and drafting is unchanged."""
    idx = teng.NgramIndex(ngram=3, window=256)
    jidx = jeng.NgramIndex(ngram=3, window=256)
    hist = [(i * 7 + i // 5) % 50 for i in range(4096)]
    idx.extend(hist)
    jidx.extend(hist)
    for n, m in idx.maps.items():
        assert not [k for k in m.values() if k < len(hist) - 256 - 1024], n
    assert idx.maps == jidx.maps
    assert idx.draft(hist, 4) == \
        teng.prompt_lookup_draft(hist, 4, window=256)


# -- exactness ---------------------------------------------------------------

def test_speculative_equals_sequential_and_jax(tp, jax_ref):
    want, spec = jax_ref["dense"]
    eng = dense(tp, speculative=4)
    got = run_all(eng, teng.Request)
    assert got == want == run_all(dense(tp), teng.Request)
    assert eng.spec_stats == spec


def test_speculation_actually_accepts(tp):
    eng = dense(tp, speculative=4)
    run_all(eng, teng.Request)
    s = eng.spec_stats
    assert s["verify_steps"] > 0 and 0 < s["accepted"] <= s["drafted"]
    assert eng.verify_tokens > s["verify_steps"]   # runs of tokens


def test_sampling_slots_never_draft(tp):
    eng = dense(tp, speculative=4)
    run_all(eng, teng.Request, temp=0.9)
    assert eng.spec_stats["drafted"] == 0


def test_eos_respected_mid_acceptance(tp):
    """A stop token inside an accepted run ends the request there, as
    sequential decoding does."""
    prompt = [3, 4, 5, 6] * 5
    probe = dense(tp)
    probe.add_request(teng.Request("p", list(prompt), max_new_tokens=10))
    third = probe.run()[0].tokens[2]
    outs = {}
    for name, eng in (("seq", dense(tp)), ("spec", dense(tp, speculative=4))):
        eng.add_request(teng.Request("x", list(prompt), max_new_tokens=10,
                                     eos_token=int(third)))
        outs[name] = [(r.tokens, r.finish_reason) for r in eng.run()]
    assert outs["seq"] == outs["spec"]
    assert outs["spec"][0][1] == "eos"


def test_speculative_with_chunked_prefill_compose(tp, jax_ref):
    assert run_all(dense(tp, speculative=4, prefill_chunk=8),
                   teng.Request) == jax_ref["dense"][0]


def test_fewer_device_steps_with_speculation(tp):
    def count_steps(engine):
        engine.add_request(teng.Request("r", [5, 6] * 8, max_new_tokens=32))
        steps = 0
        while engine.has_work():
            engine.step()
            steps += 1
        return steps
    assert count_steps(dense(tp, speculative=4)) < count_steps(dense(tp))


def test_verify_gated_on_drafting_fraction(tp):
    """Below SPEC_MIN_DRAFT_FRACTION of drafting slots the engine decodes
    normally and drops the drafts."""
    def run_with_drafts(drafting_slots):
        eng = dense(tp, max_slots=5, speculative=4)
        for i in range(5):
            eng.add_request(teng.Request(f"r{i}", list(range(3 + i, 13 + i)),
                                         max_new_tokens=4))
        eng._build_drafts = lambda: [
            [1, 2] if i in drafting_slots else [] for i in range(5)]
        eng.run()
        return eng.spec_stats["verify_steps"]
    assert run_with_drafts({0}) == 0            # 1/5 < 0.25
    assert run_with_drafts({0, 3}) > 0          # 2/5 >= 0.25


# -- paged -------------------------------------------------------------------

def test_paged_speculative_exact_and_capacity_capped(tp, jax_ref):
    """Paged speculation equals sequential paged decoding and the JAX
    engine (tokens and spec_stats); with a pool of no spare blocks the
    capacity cap shrinks drafts and the tokens stay exact."""
    want, spec = jax_ref["paged"]
    eng = paged(tp, speculative=4)
    got = run_paged(eng, teng.Request)
    assert got == want == run_paged(paged(tp), teng.Request)
    assert eng.spec_stats == spec and spec["accepted"] > 0
    assert run_paged(paged(tp, num_blocks=18, speculative=4),
                     teng.Request) == \
        run_paged(paged(tp, num_blocks=18), teng.Request)


def test_draft_headroom_released_when_slot_backs_off(tp):
    eng = tpe.PagedServeEngine(TCFG, tp, max_slots=2, max_len=128,
                               block_size=8, speculative=4, num_blocks=32,
                               device="cpu")
    eng.add_request(teng.Request("r0", list(range(20)), max_new_tokens=32))
    eng.step()
    headroom = len(eng.owned[0]) * eng.block_size - int(eng.lens[0]) - 1
    assert headroom >= 1
    free_before = eng.allocator.num_free
    eng._spec_miss[0] = eng.SPEC_MISS_LIMIT
    eng._decode_all()
    assert len(eng.owned[0]) == eng._blocks_needed(int(eng.lens[0]) + 1)
    assert eng.allocator.num_free > free_before
    assert all(eng.tables[0, len(eng.owned[0]):] == 0)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_block_zero_canary(tp, kv_quant):
    """A request holding physical block 0 keeps its K/V while the other
    slots run verify steps whose drafts reach their capacity.  The pool is
    full (no draft headroom grows), so a verify row's padding positions
    lie past the slot's blocks and resolve through the zero-filled table
    tail into block 0: only real tokens may write."""
    bs, gamma = 8, 4
    eng = tpe.PagedServeEngine(TCFG, tp, max_slots=3, max_len=128,
                               block_size=bs, speculative=gamma,
                               num_blocks=40, device="cpu",
                               kv_quant=kv_quant)
    eng.add_request(teng.Request("canary", list(range(30, 42)),
                                 max_new_tokens=60))
    for i, p in enumerate(([4, 5] * 10, [7, 8, 9] * 8)):
        eng.add_request(teng.Request(f"o{i}", p, max_new_tokens=40))
    eng.step()                          # admits all three, one decode step
    assert eng.owned[0][0] == 0 and eng.active[0].request_id == "canary"
    pool = eng.cache["k"] if kv_quant == "none" else eng.cache["k"]["q"]
    before = pool[:, :, :bs].clone()
    # A full pool: only a slot's mandatory next-token block may grow.
    grow = eng._grow
    eng._grow = lambda slot, n: bool(
        len(eng.owned[slot]) * bs <= eng.lens[slot]) and grow(slot, n)
    # The others draft as far as their blocks reach, the canary never.
    eng._build_drafts = lambda: [
        [1] * min(gamma, eng._extra_draft_cap(i))
        if req is not None and req.request_id != "canary" else []
        for i, req in enumerate(eng.active)]
    past = []
    verify = eng._verify_call

    def spy(toks, ntok, temps, mask):
        cap = [len(o) * bs for o in eng.owned]
        past.extend(i for i in range(3) if ntok[i] and
                    eng.lens[i] + toks.shape[1] > cap[i])
        return verify(toks, ntok, temps, mask)
    eng._verify_call = spy
    for _ in range(12):
        eng.step()
    assert eng.spec_stats["verify_steps"] >= 10 and len(past) >= 10
    assert eng.active[0] is not None and eng.owned[0][0] == 0
    assert torch.equal(pool[:, :, :bs], before)
