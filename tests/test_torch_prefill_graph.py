"""PyTorch port: the paged engine's prefill from cache position 0 as a CUDA
graph replay, one graph a prompt bucket (``serve/forward_graphs.py``).

On the CPU there are no CUDA graphs, so the capture's two device steps
(the eager warm-up on a side stream, the recording) are stood in for by a
recording whose replay runs the captured forward again into the captured
output, counting no launches, as a replay skips the wrappers' Python.
Around them everything is the module's own: the graphs keyed on the
forward and its inputs' shapes and on the storages of the params and the
pool, the static inputs, the launch counts a replay adds, and the engine's
choice of route.  Held here: a graphed engine's tokens and pool are an
eager engine's bit for bit, with prefills past a cached prefix and later
chunks run eagerly; one capture a bucket, again after a rebind; the
engine's settings decide whether it has graphs.  On the card the graph's
logits, sampled tokens and pool are held to the eager prefill's at every
bucket from 32 to 4096.  No JAX here, so the card can run the gpu test
from this file."""

import dataclasses

import numpy as np
import pytest
import torch

from kuberay_tpu_torch.models import llama, mixtral
from kuberay_tpu_torch.ops import launches
from kuberay_tpu_torch.serve import forward_graphs as fg
from kuberay_tpu_torch.serve import kv_cache as kc
from kuberay_tpu_torch.serve import paged_kv as pk
from kuberay_tpu_torch.serve.engine import Request
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine

torch.set_num_threads(2)

CFG = dataclasses.replace(llama.CONFIGS["llama_tiny"], dtype=torch.bfloat16)
M, BS = 128, 8
SHARED = list(range(3, 3 + 3 * BS))            # three full blocks


class _Recorded:
    """A captured call on the CPU: ``replay`` runs the forward again into
    the captured output and counts no launches."""

    def __init__(self, forward, inputs, out, pool):
        self.forward, self.inputs, self.out = forward, inputs, out
        self._pool = pool

    def replay(self):
        saved = launches.snapshot()
        with torch.no_grad():
            res = self.forward(*self.inputs)
        launches.clear()
        launches.add(saved)
        self.out.copy_(res)

    def pool(self):
        return self._pool


@pytest.fixture
def recorded(monkeypatch):
    """The capture's device steps on the CPU; returns the memory pool each
    recording was asked for and the warm-ups' count."""
    log = {"pools": [], "warm_ups": 0}

    def warm_up(forward, inputs, device):
        log["warm_ups"] += 1
        forward(*inputs)

    def record(forward, inputs, pool):
        log["pools"].append(pool)
        out = forward(*inputs)
        return _Recorded(forward, inputs, out,
                         pool if pool is not None else object()), out

    monkeypatch.setattr(fg, "_warm_up", warm_up)
    monkeypatch.setattr(fg, "_record", record)
    return log


@pytest.fixture(scope="module")
def params():
    return llama.init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _engine(params, graphed: bool, **kw):
    eng = PagedServeEngine(CFG, params, max_slots=2, max_len=M,
                           block_size=BS, device="cpu", **kw)
    if graphed:
        eng._graph = fg.ForwardGraphs("cpu")
    return eng


def _watch(eng):
    """Every prefill's (bucket, start) at the engine's funnel, and the
    eager prefill forwards' count."""
    seen = {"calls": [], "eager": 0}
    funnel, eager = eng._prefill_logits, eng._prefill_forward

    def prefill_logits(padded, slot, real_len, start_pos=0):
        seen["calls"].append((len(padded), start_pos))
        return funnel(padded, slot, real_len, start_pos)

    def prefill_forward(*a):
        seen["eager"] += 1
        return eager(*a)

    eng._prefill_logits = prefill_logits
    eng._prefill_forward = prefill_forward
    return seen


def _serve(eng, prompts, n=5):
    base = eng.stats["prefills"]
    for i, p in enumerate(prompts):
        eng.add_request(Request(f"r{base}-{i}", p, max_new_tokens=n))
    return sorted((r.request_id, r.tokens) for r in eng.run())


def _prompts():
    rng = np.random.default_rng(4)
    rnd = [rng.integers(1, CFG.vocab_size, n).tolist()
           for n in (5, 20, 40, 70)]
    return rnd + [SHARED + [90, 91, 92], SHARED + [93] * 9]


def _same_pool(a, b) -> bool:
    return all(torch.equal(a.cache[n], b.cache[n]) for n in ("k", "v"))


@pytest.mark.parametrize("chunk", [0, 16])
def test_graph_prefills_match_eager(recorded, params, chunk):
    """A graphed engine's tokens and pool are an eager engine's bit for
    bit; every prefill from position 0 (a whole prompt, or a chunked
    admission's first chunk) is a replay, every one past a cached prefix
    and every later chunk runs the eager forward; one capture a bucket."""
    graphed = _engine(params, True, prefill_chunk=chunk)
    eager = _engine(params, False, prefill_chunk=chunk)
    seen = _watch(graphed)
    assert _serve(graphed, _prompts()) == _serve(eager, _prompts())
    assert _same_pool(graphed, eager)
    st = graphed.stats
    fresh = [b for b, s in seen["calls"] if s == 0]
    assert len(seen["calls"]) == st["prefills"] == eager.stats["prefills"]
    assert len(fresh) == st["prefill_graph_steps"] == 5
    assert seen["eager"] == st["prefills"] - len(fresh) > 0
    assert st["prefill_graph_captures"] == len(set(fresh))
    assert st["decode_graph_steps"] == st["decode_steps"] > 0
    assert st["decode_graph_captures"] == 1
    assert eager.stats["prefill_graph_steps"] == 0


def test_one_capture_a_bucket_and_again_after_a_rebind(recorded, params):
    """A second prefill in a bucket replays its graph; rebinding the
    params, then the pool, drops every graph, and each forward captures
    again at its next call into a fresh memory pool; the graphs of one set
    of storages share the first one's pool."""
    eng = _engine(params, True)
    ref = _engine(params, False)

    def both(prompt):
        assert _serve(eng, [prompt]) == _serve(ref, [prompt])
        st = eng.stats
        return st["prefill_graph_captures"], st["decode_graph_captures"]

    assert both([5, 6, 7]) == (1, 1)
    assert both(list(range(9, 29))) == (1, 1)          # bucket 32 again
    assert both(list(range(60, 100))) == (2, 1)        # bucket 64
    eng.params = kc.tree_map(torch.clone, eng.params)
    assert both([8, 9]) == (3, 2)
    moved = pk.init_paged_cache(CFG, eng.num_blocks, BS, device="cpu")
    for n in ("k", "v"):
        moved[n].copy_(eng.cache[n])
    eng.cache = moved
    assert both([10, 11, 12]) == (4, 3)
    assert _same_pool(eng, ref)
    assert eng.stats["prefill_graph_steps"] == 5
    pools = recorded["pools"]
    assert [p is None for p in pools] == [True, False, False, True, False,
                                          True, False]
    assert pools[1] is pools[2] and pools[1] is not pools[4]
    assert recorded["warm_ups"] == len(pools)


def test_replays_add_their_captures_launches(recorded):
    """Each replay adds what its capture counted; the warm-up and the
    capture count nothing; a replay reads the inputs of its own call into
    the same static output; another shape is another graph."""
    saved = launches.snapshot()
    launches.clear()
    graphs = fg.ForwardGraphs("cpu")
    trees = {"w": torch.zeros(3)}

    def fwd(x, n):
        launches.bump("flash_fwd")
        launches.bump("rmsnorm")
        launches.bump("rmsnorm")
        return (2 * x + n).sum(-1, keepdim=True)

    try:
        got = [graphs.replay(fwd, trees, np.full((1, 4), i, np.int64),
                             np.array([i], np.int64)) for i in range(3)]
        assert [c for _, c in got] == [True, False, False]
        assert got[0][0] is got[2][0]
        assert int(got[2][0][0, 0]) == 4 * (2 * 2 + 2)
        assert launches.snapshot("flash_fwd", "rmsnorm") == {
            "flash_fwd": 3, "rmsnorm": 6}
        out, captured = graphs.replay(fwd, trees, np.ones((1, 8), np.int64),
                                      np.array([1], np.int64))
        assert captured and out is not got[0][0]
        assert launches.snapshot("flash_fwd", "rmsnorm") == {
            "flash_fwd": 4, "rmsnorm": 8}
    finally:
        launches.clear()
        launches.add(saved)


def _settings():
    mcfg = dataclasses.replace(mixtral.CONFIGS["mixtral_tiny"],
                               dtype=torch.bfloat16)
    return {"bf16": (CFG, {}, True),
            "int8_pool": (CFG, {"kv_quant": "int8"}, False),
            "w8a16": (CFG, {"weight_quant": "int8"}, False),
            "mixtral": (mcfg, {}, False)}


@pytest.mark.parametrize("case", ["bf16", "int8_pool", "w8a16", "mixtral"])
def test_engine_settings_decide_the_graphs(monkeypatch, recorded, case):
    """As if on a CUDA device, the engine's settings decide whether its
    prefills and decode steps replay graphs: the bf16 pool with the dense
    FFN and bf16 weights does, the int8 pool, int8 weights and Mixtral run
    eagerly and count no replay (a tp layout: ``eligible``'s own test in
    ``test_torch_decode_graph.py``)."""
    real = fg.eligible
    monkeypatch.setattr(fg, "eligible", lambda device, *a: real(
        torch.device("cuda"), *a))
    cfg, kw, want = _settings()[case]
    family = mixtral if cfg is not CFG else llama
    p = family.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    eng = PagedServeEngine(cfg, p, max_slots=2, max_len=64, block_size=BS,
                           device="cpu", **kw)
    assert (eng._graph is not None) is want
    _serve(eng, [[5, 6, 7], list(range(9, 29)), SHARED + [1, 2]], n=3)
    st = eng.stats
    assert st["prefills"] == 3 and st["decode_steps"] > 0
    assert st["prefill_graph_steps"] == (3 if want else 0)
    assert st["prefill_graph_captures"] == (1 if want else 0)
    assert st["decode_graph_steps"] == (st["decode_steps"] if want else 0)


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_prefill_graph_matches_eager_on_card():
    """On the card, at 128-wide heads: at every bucket from 32 to 4096 and
    real lengths 1, bucket / 2 + 1 and bucket, the graph's logits, its
    greedy and sampled tokens and the pool (every block; the sink, which
    many gated-out rows write at once and nothing reads, may differ) are
    the eager prefill's bit for bit; one capture a bucket; each replay
    launches the flash forward once a layer and RMSNorm 2 L + 1 times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(CFG, d_model=512, n_heads=4, n_kv_heads=2,
                              d_ff=1024, vocab_size=1024, max_seq_len=4096)
    params = llama.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), "cuda")
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=4096,
                           block_size=16, device="cuda")
    graphs, L = eng._graph, cfg.n_layers
    assert graphs is not None
    samps = (np.array([0.0, 1.0, 0.0], np.float32),
             np.array([0.8, 0.9, 0.0], np.float32))
    rng = np.random.default_rng(0)

    def prefill(graph, cache, padded, n):
        eng._graph, eng.cache = graph, cache
        logits = eng._prefill_logits(padded, 1, n).clone()
        toks = []
        for samp in samps:
            eng.generator.manual_seed(11)
            toks.append(eng._prefill(padded, 1, n, samp))
        return logits, toks

    pool = eng.cache
    buckets = [32 << i for i in range(8)]
    for b in buckets:
        for n in (1, b // 2 + 1, b):
            assert eng._grow(1, eng._blocks_needed(n))
            padded = np.zeros(b, np.int64)
            padded[:n] = rng.integers(0, cfg.vocab_size, n)
            ref = pk.init_paged_cache(cfg, eng.num_blocks, 16, device="cuda")
            for a, c in zip(pk._pool_leaves(ref), pk._pool_leaves(pool)):
                a.copy_(c)
            want = prefill(None, ref, padded, n)
            before = launches.snapshot("flash_fwd", "rmsnorm")
            got = prefill(graphs, pool, padded, n)
            after = launches.snapshot("flash_fwd", "rmsnorm")
            assert torch.equal(got[0], want[0]) and got[1] == want[1], (b, n)
            assert all(torch.equal(a, c) for a, c in zip(
                pk._pool_leaves(ref), pk._pool_leaves(pool))), (b, n)
            assert after["flash_fwd"] - before["flash_fwd"] == 3 * L
            assert after["rmsnorm"] - before["rmsnorm"] == 3 * (2 * L + 1)
            eng._release(1)
    st = eng.stats
    assert st["prefill_graph_captures"] == len(buckets)
    assert st["prefill_graph_steps"] == 3 * 3 * len(buckets)
