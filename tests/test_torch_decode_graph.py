"""PyTorch port: the paged forwards' sync-free write plan, and the paged
engine's decode step as a CUDA graph replay (``serve/forward_graphs.py``).

The write plan sends every new K/V row somewhere: a real token of a
writable row to its position through its table, every other row to the
sink past the pool.  It is held to the plan it replaced, kept here as the
reference (select the gated rows with ``torch.nonzero``, a host sync, and
scatter only those): over a decode step with idle slots, a bucket-padded
prefill, a prefill past a cached prefix, chunks, a verify step with
partial drafts and the int8 pool, the logits and the pool are the
reference's bit for bit, and only the sink differs.  Engagement of the
graph is a pure function of the engine's settings, tested here for each
case; on the CPU the engine runs the eager forward.  On the card the graph's
logits and pool are held to the eager forward's at every step of a run
where slots join and leave, tables grow, a tier promotion writes the pool,
and the params and the pool are rebound.  No JAX here, so the card can run
the gpu test from this file."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from kuberay_tpu_torch.models import llama, mixtral
from kuberay_tpu_torch.ops import launches
from kuberay_tpu_torch.serve import forward_graphs as dg
from kuberay_tpu_torch.serve import kv_cache as kc
from kuberay_tpu_torch.serve import paged_kv as pk
from kuberay_tpu_torch.serve.engine import Request
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine

torch.set_num_threads(2)

BASE = llama.CONFIGS["llama_tiny"]           # float32, 2 layers, 4 / 2 heads
BS, NUM_BLOCKS, MAX_BLOCKS = 8, 40, 8


# -- the reference: the parent's plan ----------------------------------------

def _ref_plan(tokens, block_tables, start, write_mask, token_mask,
              block_size, pool):
    """The gated (row, token) pairs, selected on the host, and their pool
    positions."""
    B, T = tokens.shape
    dev = tokens.device
    positions = start[:, None] + torch.arange(T, device=dev)[None, :]
    if write_mask is None:
        write_mask = torch.ones(B, device=dev)
    gate = token_mask if token_mask is not None \
        else write_mask[:, None].expand(B, T)
    b, t = torch.nonzero(gate > 0, as_tuple=True)
    phys = pk._physical_positions(block_tables, positions, block_size)
    return b * T + t, phys[b, t]


def _ref_rows(layer, rows, plan):
    sel, phys = plan
    layer[:, phys] = rows[sel].transpose(0, 1).to(layer.dtype)


def _storage(t: torch.Tensor) -> torch.Tensor:
    """A pool leaf's whole storage, the sink included, flat."""
    n = t.untyped_storage().nbytes() // t.element_size()
    return t.as_strided((n,), (1,), 0)


def _random_pool(cfg, quant, seed):
    """A pool whose every element, the sink's too, holds a random value."""
    cache = pk.init_paged_cache(cfg, NUM_BLOCKS, BS, quant=quant,
                                device="cpu")
    g = torch.Generator().manual_seed(seed)
    for leaf in pk._pool_leaves(cache):
        flat = _storage(leaf)
        if flat.dtype == torch.int8:
            flat.copy_(torch.randint(-127, 128, flat.shape, generator=g))
        else:
            flat.copy_(torch.rand(flat.shape, generator=g) + 0.01)
    return cache


def _copy_pool(cache, cfg, quant):
    out = pk.init_paged_cache(cfg, NUM_BLOCKS, BS, quant=quant, device="cpu")
    for a, b in zip(pk._pool_leaves(out), pk._pool_leaves(cache)):
        _storage(a).copy_(_storage(b))
    return out


def _tables(slots, idle=()):
    """Disjoint scrambled tables, slot 0's first block block 0; idle
    slots' rows are zero (block 0 again, which slot 0 owns)."""
    perm = np.random.default_rng(3).permutation(NUM_BLOCKS)
    perm = np.concatenate([[0], perm[perm != 0]])
    t = perm[:slots * MAX_BLOCKS].reshape(slots, MAX_BLOCKS).copy()
    for i in idle:
        t[i] = 0
    return torch.from_numpy(t.astype(np.int32))


def _call(kind):
    """(tokens [B, T], start [B], write_mask, token_mask) of one engine
    call."""
    rng = np.random.default_rng(5)
    if kind == "decode_idle_slots":
        mask = torch.tensor([1.0, 0.0, 1.0, 0.0])
        return (torch.from_numpy(rng.integers(1, 200, (4, 1))),
                torch.tensor([5, 0, 17, 0]), mask, mask[:, None])
    if kind == "verify_partial":
        mask = torch.tensor([1.0, 1.0, 0.0, 1.0])
        ntok = torch.tensor([4, 2, 0, 1])
        tm = mask[:, None] * (torch.arange(4)[None] < ntok[:, None]).float()
        return (torch.from_numpy(rng.integers(1, 200, (4, 4))),
                torch.tensor([9, 30, 0, 15]), mask, tm)
    start, T, real = {"prefill_padding": (0, 32, 20),
                      "prefill_cached_prefix": (16, 16, 11),
                      "chunk_full": (24, 16, 16),
                      "chunk_last": (40, 16, 7)}[kind]
    return (torch.from_numpy(rng.integers(1, 200, (1, T))),
            torch.tensor([start]), torch.ones(1),
            (torch.arange(T) < real)[None].float())


CALLS = ("decode_idle_slots", "prefill_padding", "prefill_cached_prefix",
         "chunk_full", "chunk_last", "verify_partial")


def _forward(quant):
    return pk.make_paged_quant_forward(BS) if quant == "int8" \
        else pk.make_paged_forward(BS)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(BASE, dtype=dtype)
        out[dtype] = (cfg, llama.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
    return out


@pytest.mark.parametrize("quant,dtype", [("none", torch.float32),
                                         ("none", torch.bfloat16),
                                         ("int8", torch.float32)])
@pytest.mark.parametrize("kind", CALLS)
def test_write_plan_matches_the_nonzero_plan(monkeypatch, trees, kind, quant,
                                             dtype):
    """The paged forward's logits and pool, bit for bit the nonzero plan's
    everywhere but the sink; the rows the gate keeps out reach the sink
    and nothing else."""
    cfg, params = trees[dtype]
    tokens, start, wmask, tmask = _call(kind)
    idle = [i for i in range(tokens.shape[0]) if wmask[i] == 0]
    tables = _tables(tokens.shape[0], idle)
    got_pool = _random_pool(cfg, quant, 1)
    want_pool = _copy_pool(got_pool, cfg, quant)
    sinks = [_storage(t)[t.numel():].clone()
             for t in pk._pool_leaves(got_pool)]
    got, _ = _forward(quant)(cfg, params, tokens, got_pool, tables, start,
                             wmask, token_mask=tmask)
    with monkeypatch.context() as m:
        m.setattr(pk, "_write_plan", _ref_plan)
        m.setattr(pk, "_write_rows", _ref_rows)
        want, _ = _forward(quant)(cfg, params, tokens, want_pool, tables,
                                  start, wmask, token_mask=tmask)
    assert torch.equal(got, want)
    gated_out = bool((tmask == 0).any())
    for g, w, s in zip(pk._pool_leaves(got_pool),
                       pk._pool_leaves(want_pool), sinks):
        assert torch.equal(g, w)
        assert torch.equal(_storage(w)[w.numel():], s)    # the parent's
        assert (not torch.equal(_storage(g)[g.numel():], s)) == gated_out


def test_idle_slot_never_writes_block_zero(trees):
    """An idle slot's zero table names block 0, which slot 0 owns: after a
    decode step block 0 holds exactly what slot 0 wrote."""
    cfg, params = trees[torch.float32]
    tokens, start, wmask, tmask = _call("decode_idle_slots")
    tables = _tables(4, idle=(1, 3))
    pool = _random_pool(cfg, "none", 2)
    before = pool["k"][:, :, :BS].clone()
    pk.make_paged_forward(BS)(cfg, params, tokens, pool, tables, start,
                              wmask, token_mask=tmask)
    # slot 0 (length 5) writes position 5 of its first block, block 0.
    changed = (pool["k"][:, :, :BS] != before).any(-1).any(1).any(0)
    assert changed.nonzero().flatten().tolist() == [5]


def test_sink_is_no_block_of_the_allocator():
    """Every block id the allocator hands out addresses rows inside the
    pool, before its sink; a pool without a sink is refused."""
    cfg = dataclasses.replace(BASE, dtype=torch.bfloat16)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=64,
                           block_size=BS, num_blocks=NUM_BLOCKS,
                           device="cpu")
    ids = [eng.allocator.allocate() for _ in range(NUM_BLOCKS)]
    assert sorted(ids) == list(range(NUM_BLOCKS))
    assert eng.allocator.allocate() is None
    k = eng.cache["k"]
    L, H, P, D = k.shape
    assert int(eng._block_rows(ids).max()) == P - 1
    assert _storage(k).numel() == (L * H * P + H * BS) * D
    bare = {n: torch.zeros(L, H, P, D, dtype=cfg.dtype) for n in ("k", "v")}
    with pytest.raises(ValueError, match="sink"):
        pk.make_paged_forward(BS)(cfg, params, torch.ones(1, 1).long(),
                                  bare, torch.zeros(1, 8, dtype=torch.int32),
                                  torch.zeros(1))


# -- engagement --------------------------------------------------------------

def _eligibility_cases():
    """(device, kv_quant, weight_quant, layout, cfg) and the verdict."""
    cfg = dataclasses.replace(BASE, dtype=torch.bfloat16)
    cuda = torch.device("cuda")
    mcfg = dataclasses.replace(mixtral.CONFIGS["mixtral_tiny"],
                               dtype=torch.bfloat16)
    return {
        "bf16_paged_cuda": ((cuda, "none", "none", None, cfg), True),
        "cpu": ((torch.device("cpu"), "none", "none", None, cfg), False),
        "int8_pool": ((cuda, "int8", "none", None, cfg), False),
        "float32_pool": ((cuda, "none", "none", None, BASE), False),
        "tp_layout": ((cuda, "none", "none", object(), cfg), False),
        "mixtral": ((cuda, "none", "none", None, mcfg), False),
        "w8a16": ((cuda, "none", "int8", None, cfg), False),
    }


@pytest.mark.parametrize("case", ["bf16_paged_cuda", "cpu", "int8_pool",
                                  "float32_pool", "tp_layout", "mixtral",
                                  "w8a16"])
def test_eligibility(case):
    args, want = _eligibility_cases()[case]
    assert dg.eligible(*args) is want


def test_graph_key_follows_the_storages(trees):
    """The capture's key changes when the params or the pool are rebound,
    not when they are written in place."""
    cfg, params = trees[torch.bfloat16]
    cache = pk.init_paged_cache(cfg, 4, BS, device="cpu")
    key = dg._storage_key((params, cache))
    assert len(key) == len(list(dg._tensors(params))) + 2
    cache["k"].add_(1)
    params["embed"].mul_(1)
    assert dg._storage_key((params, cache)) == key
    assert dg._storage_key((kc.tree_map(torch.clone, params), cache)) != key
    moved = pk.init_paged_cache(cfg, 4, BS, device="cpu")
    assert dg._storage_key((params, moved)) != key


def test_cpu_engine_runs_the_eager_forward(trees):
    """On the CPU every decode step calls the eager forward; no graph, and
    the counters stay 0."""
    cfg, params = trees[torch.bfloat16]
    eng = PagedServeEngine(cfg, params, max_slots=2, max_len=64,
                           block_size=BS, device="cpu")
    calls = []
    real = eng._decode_forward
    eng._decode_forward = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    for i, p in enumerate(([5, 17, 42, 7], [9, 9, 1, 30, 2], [3])):
        eng.add_request(Request(f"r{i}", p, max_new_tokens=5))
    assert len(eng.run()) == 3
    st = eng.stats
    assert st["decode_steps"] > 0 and len(calls) == st["decode_steps"]
    assert st["decode_graph_steps"] == st["decode_graph_captures"] == 0
    assert eng._graph is None


# -- on the card -------------------------------------------------------------

def _counters():
    return tuple(launches.snapshot("rmsnorm", "paged_decode_attention",
                                   "flash_fwd").values())


@pytest.mark.gpu
def test_graph_replays_match_eager_on_card():
    """On the card, a bf16 paged engine over a run where slots join and
    leave, tables grow, a tier promotion writes the pool between steps and
    the params, then the pool, are rebound: at every decode step the
    graph's logits and pool are the eager forward's bit for bit; each
    rebinding captures again; every decode step is a replay; RMSNorm ran
    2 L + 1 times a forward and the paged kernel L times a decode step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(BASE, d_model=256, n_heads=4, n_kv_heads=2,
                              d_ff=512, dtype=torch.bfloat16)
    params = llama.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), "cuda")
    eng = PagedServeEngine(cfg, params, max_slots=4, max_len=128,
                           block_size=BS, num_blocks=40, device="cuda",
                           host_blocks=64)
    L = cfg.n_layers
    real = eng._decode_logits
    steps = []

    def checked(last, mask):
        ref = pk.init_paged_cache(cfg, eng.num_blocks, BS, device="cuda")
        for n in ("k", "v"):
            ref[n].copy_(eng.cache[n])
        saved = launches.snapshot()
        dev = eng.device
        want, _ = eng._forward(
            cfg, eng.params, torch.from_numpy(last).to(dev)[:, None], ref,
            torch.from_numpy(eng.tables).to(dev),
            torch.from_numpy(eng.lens).to(dev), torch.from_numpy(mask).to(dev),
            token_mask=torch.from_numpy(mask).to(dev)[:, None])
        launches.clear()
        launches.add(saved)
        got = real(last, mask)
        steps.append(torch.equal(got, want) and all(
            torch.equal(eng.cache[n], ref[n]) for n in ("k", "v")))
        return got

    eng._decode_logits = checked
    launches.clear()
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab_size, 3 * BS).tolist()

    ids = itertools.count()

    def serve(reqs):
        for p, n in reqs:
            eng.add_request(Request(f"q{next(ids)}", p, max_new_tokens=n))
        return eng.run()

    # Slots join and leave at different steps; lengths cross blocks.
    serve([(prompt, 12)] + [(rng.integers(1, cfg.vocab_size, n).tolist(), m)
                            for n, m in ((5, 20), (30, 9), (11, 17),
                                         (19, 4), (7, 25))])
    eng._pump_demotions(limit=1 << 10)
    # Cannibalise the cached blocks, then ask for the prompt again: its
    # blocks come back from the host tier into the pool.
    for j in range(4):
        serve([(rng.integers(1, cfg.vocab_size, 14 * BS - 1).tolist(), 2)])
    assert eng.resident_prefix_blocks(prompt) == 0
    serve([(prompt, 10), (rng.integers(1, cfg.vocab_size, 9).tolist(), 14)])
    assert eng.stats["tier_fetch_blocks"] > 0
    assert eng.stats["decode_graph_captures"] == 1
    eng.params = kc.tree_map(torch.clone, eng.params)
    serve([(rng.integers(1, cfg.vocab_size, 13).tolist(), 6)])
    assert eng.stats["decode_graph_captures"] == 2
    moved = pk.init_paged_cache(cfg, eng.num_blocks, BS, device="cuda")
    for n in ("k", "v"):
        moved[n].copy_(eng.cache[n])
    eng.cache = moved
    serve([(rng.integers(1, cfg.vocab_size, 21).tolist(), 6)])
    st = eng.stats
    assert st["decode_graph_captures"] == 3
    assert all(steps) and len(steps) == st["decode_steps"] > 0
    assert st["decode_graph_steps"] == st["decode_steps"]
    forwards = st["prefills"] + st["decode_steps"]
    assert _counters() == ((2 * L + 1) * forwards, L * st["decode_steps"],
                           L * st["prefills"])
