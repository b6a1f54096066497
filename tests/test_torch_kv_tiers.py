"""PyTorch port, KV tiers and KV-block transfer of the paged engine against
the JAX package: the copied ``KvTierStore`` on one scripted call sequence,
then the engine cases of ``tests/test_kv_tiers.py`` (demotion, promotion,
adverts, export served from a tier, an importer racing the source's
eviction) run on both packages' engines and held to the same counts and
greedy tokens, and blocks handed between the two engines in both
directions.

Inputs come from the JAX package's seeded ``llama_tiny`` tree, carried
over by ``params_from_jax``; the JAX engines run with
``decode_impl="xla"``.
"""

import base64

import jax
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.obs import Tracer
from kuberay_tpu.serve import kv_tiers as jkt
from kuberay_tpu.serve import paged_engine as jpe
from kuberay_tpu.serve.engine import Request as JRequest
from kuberay_tpu.utils.metrics import MetricsRegistry as JMetricsRegistry
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.obs.trace import TraceContext
from kuberay_tpu_torch.serve import kv_tiers as tkt
from kuberay_tpu_torch.serve.engine import Request
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine
from kuberay_tpu_torch.utils.metrics import MetricsRegistry

torch.set_num_threads(2)

JCFG = jllama.CONFIGS["llama_tiny"]
TCFG = tllama.CONFIGS["llama_tiny"]
BS = 8
PROMPT = list(range(1, 25))                      # 3 full blocks, in-vocab
# The tier counters both engines report.
TIER_KEYS = ("host_blocks_used", "host_blocks_total", "spill_blocks_used",
             "spill_blocks_total", "pending_demotions", "tier_hits_host",
             "tier_hits_spill", "tier_misses", "tier_demotions",
             "tier_promotions", "tier_evictions", "tier_stale_drops",
             "advert_seq", "tier_fetch_blocks", "tier_demoted_blocks",
             "num_blocks", "free_blocks", "prefix_hit_tokens",
             "prefix_query_tokens")


@pytest.fixture(scope="module")
def trees():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")


class Recorder:
    """A port tracer that records (span name, attributes)."""

    enabled = True

    def __init__(self):
        self.spans = []

    def record_span(self, ctx, name, start, end, **attrs):
        self.spans.append((name, attrs))


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _blk(i):
    return tuple(range(i * 100, i * 100 + 4))


def _script(mod, metrics):
    """One call sequence over every method of the store; returns what
    each call gave, the advert docs and the stats."""
    st = mod.KvTierStore(host_blocks=3, spill_blocks=2, metrics=metrics,
                         advert_capacity=16)
    out = []
    st.note_device(70, True)
    st.note_device(71, True)
    st.note_device(70, True)                     # no-op re-register
    out.append(st.advert_since(0))
    for i in (1, 2, 3, 4, 5, 6):                 # host 3, spill 2, 1 gone
        out.append(st.admit(i, _blk(i), f"p{i}"))
    out.append(st.advert_since(2))
    out.append(st.checkout(2, _blk(2)))          # spill hit -> host
    out.append(st.checkout(4, _blk(9)))          # stale: dropped
    out.append(st.checkout(99, _blk(99)))        # miss
    out.append(st.checkout(6, _blk(6)))          # host hit
    st.pin(5)
    for i in (7, 8):
        out.append(st.admit(i, _blk(i), f"p{i}"))
    st.unpin(5)
    out.append(st.admit(6, _blk(6), "other"))    # resident: refresh only
    out.append([st.tier_of(h) for h in (70, 2, 3, 5, 99)])
    st.note_freed(71)
    st.note_freed(6)                             # in a tier: not queued
    st.note_freed(72)
    out.append((st.pending_count(), st.pop_pending()))
    st.note_device(72, True)                     # registered: pending dropped
    out.append(st.pop_pending())
    st.note_device(71, False)
    out.append([st.discard(h) for h in (7, 5, 99)])
    out.append(st.contains(8))
    seq = st.advert_seq
    out.append(st.advert_since(seq - 3))
    out.append(st.advert_since(seq))
    out.append(st.advert_since(1))               # fell out: reset snapshot
    out.append(st.stats())
    return out


def test_store_copy_matches_the_original():
    jm, tm = JMetricsRegistry(), MetricsRegistry()
    got, want = _script(tkt, tm), _script(jkt, jm)
    assert got == want
    assert want[-2]["reset"] and not want[-4]["reset"]
    assert tm.render() == jm.render()
    assert (tkt.TIER_DEVICE, tkt.TIER_HOST, tkt.TIER_SPILL) == \
        (jkt.TIER_DEVICE, jkt.TIER_HOST, jkt.TIER_SPILL)


# ---------------------------------------------------------------------------
# the engines through the hierarchy
# ---------------------------------------------------------------------------

def _jengine(jp, **kw):
    kw.setdefault("max_slots", 1)
    return jpe.PagedServeEngine(JCFG, jp, max_len=64, block_size=BS,
                                decode_impl="xla", **kw)


def _tengine(tp, **kw):
    kw.setdefault("max_slots", 1)
    return PagedServeEngine(TCFG, tp, max_len=64, block_size=BS,
                            device="cpu", **kw)


def _engines(trees, **kw):
    jp, tp = trees
    return (_jengine(jp, **kw), JRequest), (_tengine(tp, **kw), Request)


def _serve(eng, req_cls, rid, prompt, n, **kw):
    eng.add_request(req_cls(rid, list(prompt), max_new_tokens=n, **kw))
    return eng.run()[0].tokens


def _fill_pool(eng, req_cls):
    """Cannibalise every cached device block with disjoint slot-sized
    in-vocab prompts (as tests/test_kv_tiers.py's ``_fill_pool``)."""
    plen = (eng.max_blocks - 1) * BS
    for j in range(eng.num_blocks // (eng.max_blocks - 1) + 1):
        toks = [(30 + j * plen + i) % 231 + 25 for i in range(plen)]
        _serve(eng, req_cls, f"junk{j}", toks, 1)


def _tier_stats(eng):
    return {k: eng.stats[k] for k in TIER_KEYS}


@pytest.fixture(scope="module")
def cold(trees):
    """A cold prefill of PROMPT's 6 greedy tokens on each package."""
    jp, tp = trees
    return (_serve(_jengine(jp), JRequest, "c", PROMPT, 6),
            _serve(_tengine(tp), Request, "c", PROMPT, 6))


def test_cold_tokens_agree(cold):
    assert cold[0] == cold[1]


def test_demotes_and_resumes_without_prefill_like_jax(trees, cold):
    runs = []
    for (eng, req_cls), tracer in zip(
            _engines(trees, max_slots=2, host_blocks=64),
            (Tracer(), Recorder())):
        eng._tracer = tracer
        _serve(eng, req_cls, "p", PROMPT, 1)
        eng._pump_demotions(limit=1 << 10)
        demoted = eng.tiers.stats()["host_blocks_used"]
        _fill_pool(eng, req_cls)
        assert eng.resident_prefix_blocks(PROMPT) == 0
        if isinstance(tracer, Tracer):
            ctx = tracer.start_request("serve-request")
        else:
            ctx = TraceContext("ab" * 16, "cd" * 8)
        tokens = _serve(eng, req_cls, "r", PROMPT, 6, trace=ctx)
        if isinstance(tracer, Tracer):
            tracer.finish_request(ctx)
            spans = [(s["name"], s["attrs"])
                     for s in tracer.export(ctx.trace_id)]
        else:
            spans = tracer.spans
        fetch = [a["blocks"] for n, a in spans if n == "tier-fetch"]
        runs.append((tokens, demoted, fetch, _tier_stats(eng)))
    (jt, jd, jf, js), (tt, td, tf, ts) = runs
    assert tt == jt == cold[0]
    assert td == jd >= 3
    assert tf == jf and tf[0] >= 2
    assert ts == js
    assert ts["tier_fetch_blocks"] >= 2 and ts["prefix_hit_tokens"] >= 2 * BS


def test_step_pump_demotes_at_most_four_blocks_a_step(trees):
    """The pump runs inside step(): the same pending and host counts after
    every step as the JAX engine's."""
    counts = []
    prompt = list(range(1, 49))                  # 6 full blocks
    for eng, req_cls in _engines(trees, host_blocks=64):
        eng.add_request(req_cls("p", prompt, max_new_tokens=2))
        seen = []
        while eng.has_work():
            eng.step()
            st = eng.tiers.stats()
            seen.append((st["pending_demotions"], st["host_blocks_used"]))
        for _ in range(3):
            eng.step()
            st = eng.tiers.stats()
            seen.append((st["pending_demotions"], st["host_blocks_used"]))
        counts.append(seen)
    assert counts[0] == counts[1]
    assert (2, 4) in counts[1] and counts[1][-1] == (0, 6)


def test_demotion_reads_the_block_at_copy_time(trees):
    """A queued block whose pool slot was cannibalised before the pump
    got to it demotes nothing under its hash (JAX's rule)."""
    out = []
    for eng, req_cls in _engines(trees, host_blocks=64):
        _serve(eng, req_cls, "p", PROMPT, 1)
        pending = eng.tiers.pending_count()
        _fill_pool(eng, req_cls)                 # the pump runs in steps
        out.append((pending, eng.stats["tier_demoted_blocks"],
                     eng.tiers.contains(eng.allocator.block_hashes(
                         PROMPT)[0])))
    assert out[0] == out[1]


def test_advert_covers_tiers_and_eviction_like_jax(trees):
    docs = []
    for eng, req_cls in _engines(trees, host_blocks=16):
        _serve(eng, req_cls, "p", PROMPT[:16], 1)
        eng._pump_demotions(limit=1 << 10)
        doc = eng.kv_advert(0)
        victim = eng.allocator.block_hashes(PROMPT[:16])[0]
        eng.tiers.discard(victim)
        docs.append((doc, eng.kv_advert(doc["seq"]), victim))
    assert docs[0] == docs[1]
    doc, delta, victim = docs[1]
    assert set(eng.allocator.block_hashes(PROMPT[:16])) <= \
        {h for h, _ in doc["add"]}
    assert victim in delta["del"] and not delta["reset"]
    assert _tengine(trees[1]).kv_advert(0) == \
        {"seq": 0, "reset": False, "add": [], "del": []}


def _payloads(blocks):
    shape = (TCFG.n_layers, TCFG.n_kv_heads, BS, TCFG.head_dim)
    return [(b["index"], b["hash"],
             np.frombuffer(base64.b64decode(b["k"]), "<f4").reshape(shape),
             np.frombuffer(base64.b64decode(b["v"]), "<f4").reshape(shape))
            for b in blocks]


def _assert_same_blocks(got, want):
    got, want = _payloads(got), _payloads(want)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g[3], w[3], rtol=0, atol=1e-5)


def test_export_serves_from_tier_after_device_eviction_like_jax(trees,
                                                                cold):
    exported = []
    for eng, req_cls in _engines(trees, max_slots=2, host_blocks=64):
        _serve(eng, req_cls, "p", PROMPT, 1)
        eng._pump_demotions(limit=1 << 10)
        _fill_pool(eng, req_cls)
        assert eng.resident_prefix_blocks(PROMPT) == 0
        exported.append(eng.export_kv_blocks(PROMPT))
    _assert_same_blocks(exported[1], exported[0])
    assert [b["index"] for b in exported[1]] == [0, 1, 2]
    dst = _tengine(trees[1])
    assert dst.import_kv_blocks(PROMPT, exported[1]) == \
        {"imported": 3, "skipped": 0}
    assert _serve(dst, Request, "d", PROMPT, 6) == cold[0]


def test_import_racing_source_eviction_keeps_a_contiguous_prefix(trees,
                                                                 cold):
    results = []
    for eng, req_cls in _engines(trees):
        _serve(eng, req_cls, "p", PROMPT, 1)
        first = eng.export_kv_blocks(PROMPT, max_blocks=2)
        _fill_pool(eng, req_cls)                 # the race: source evicts
        results.append((first, eng.export_kv_blocks(PROMPT, skip_blocks=2)))
    _assert_same_blocks(results[1][0], results[0][0])
    assert [b["index"] for b in results[1][0]] == [0, 1]
    assert results[1][1] == results[0][1] == []
    dst = _tengine(trees[1])
    assert dst.import_kv_blocks(PROMPT, results[1][0]) == \
        {"imported": 2, "skipped": 0}
    assert _serve(dst, Request, "d", PROMPT, 6) == cold[0]
    assert dst.stats["prefix_hit_tokens"] == 2 * BS


def test_export_skip_and_cap_like_jax(trees):
    out = []
    for eng, req_cls in _engines(trees):
        _serve(eng, req_cls, "p", PROMPT, 1)
        out.append([[b["index"] for b in eng.export_kv_blocks(
            PROMPT, skip_blocks=s, max_blocks=m)]
            for s, m in ((0, 0), (1, 0), (1, 1), (3, 0), (0, 2))])
    assert out[0] == out[1] == [[0, 1, 2], [1, 2], [1], [], [0, 1]]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_blocks_cross_between_the_packages(trees, cold, direction):
    """The wire payload is byte-compatible: blocks exported by one
    package's engine import into the other's and serve the cold tokens."""
    (je, jr), (te, tr) = _engines(trees)
    src, src_req, dst, dst_req = (je, jr, te, tr) \
        if direction == "jax_to_torch" else (te, tr, je, jr)
    _serve(src, src_req, "p", PROMPT, 1)
    blocks = src.export_kv_blocks(PROMPT)
    assert dst.import_kv_blocks(PROMPT, blocks) == \
        {"imported": 3, "skipped": 0}
    assert dst.import_kv_blocks(PROMPT, blocks) == \
        {"imported": 0, "skipped": 3}
    assert _serve(dst, dst_req, "d", PROMPT, 6) == cold[0]
    assert dst.stats["prefix_hit_tokens"] == 2 * BS
    # And the importer's own export gives the same bytes back.
    _assert_same_blocks(dst.export_kv_blocks(PROMPT), blocks)


@pytest.mark.parametrize("case", ["gap", "bad_hash", "malformed", "full"])
def test_import_stops_clean_like_jax(trees, case):
    (je, jr), (te, tr) = _engines(trees)
    _serve(je, jr, "p", PROMPT, 1)
    blocks = je.export_kv_blocks(PROMPT)
    if case == "gap":
        blocks = [blocks[0], blocks[2]]
    elif case == "bad_hash":
        blocks[1] = {**blocks[1], "hash": blocks[1]["hash"] + 1}
    elif case == "malformed":
        blocks[1] = {**blocks[1], "k": blocks[1]["k"][:-8]}
    kw = {"num_blocks": 10} if case == "full" else {}
    got = []
    for eng in (_jengine(trees[0], **kw), _tengine(trees[1], **kw)):
        if case == "full":
            for _ in range(9):                   # leave one free block
                eng.allocator.allocate()
        got.append((eng.import_kv_blocks(PROMPT, blocks),
                    eng.resident_prefix_blocks(PROMPT)))
    assert got[0] == got[1]
    assert got[1][0]["imported"] == 1


def test_engine_stats_surface_tier_counters(trees):
    (je, _), (te, _) = _engines(trees, host_blocks=16, spill_blocks=4)
    assert _tier_stats(te) == _tier_stats(je)
    assert te.stats["host_blocks_total"] == 16
    assert te.stats["spill_blocks_total"] == 4
    plain = _tengine(trees[1]).stats
    assert "advert_seq" not in plain and "num_blocks" in plain


def test_tier_metrics_reach_the_registry_like_jax(trees):
    regs = []
    jp, tp = trees
    for eng, req_cls in (
            (_jengine(jp, max_slots=2, host_blocks=64,
                      metrics=JMetricsRegistry()), JRequest),
            (_tengine(tp, max_slots=2, host_blocks=64,
                      metrics=MetricsRegistry()), Request)):
        _serve(eng, req_cls, "p", PROMPT, 1)
        eng._pump_demotions(limit=1 << 10)
        _fill_pool(eng, req_cls)
        _serve(eng, req_cls, "r", PROMPT, 2)
        regs.append([ln for ln in eng.metrics.render().splitlines()
                     if "tpu_kv_tier" in ln])
    assert regs[0] == regs[1]
    assert any("tpu_kv_tier_promotions_total" in ln for ln in regs[1])


@pytest.mark.parametrize("kw", [{"host_blocks": 8}, {"spill_blocks": 2}])
def test_tiers_refuse_an_int8_pool_like_jax(trees, kw):
    with pytest.raises(ValueError) as ours:
        _tengine(trees[1], kv_quant="int8", **kw)
    with pytest.raises(ValueError) as ref:
        _jengine(trees[0], kv_quant="int8", **kw)
    assert str(ours.value) == str(ref.value)


def test_transfer_refuses_an_int8_pool_like_jax(trees):
    te = _tengine(trees[1], kv_quant="int8")
    je = _jengine(trees[0], kv_quant="int8")
    for name, args in (("export_kv_blocks", (PROMPT,)),
                       ("import_kv_blocks", (PROMPT, []))):
        with pytest.raises(NotImplementedError) as ours:
            getattr(te, name)(*args)
        with pytest.raises(NotImplementedError) as ref:
            getattr(je, name)(*args)
        assert str(ours.value) == str(ref.value)
