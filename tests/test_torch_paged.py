"""PyTorch port, paged serving: prefix hashes, the block allocator, the
paged decode attention's plain version, the paged forwards and the paged
engine against the JAX package.

Inputs come from numpy with a fixed seed and go to both packages.  On CPU
tensors the port's wrappers take their plain versions; the CUDA kernel is
checked by the ``gpu`` test below and by chip_smoke.py.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.ops.paged_attention import (
    flat_indices as jax_flat_indices,
    gather_view as jax_gather_view,
    paged_decode_attention_pallas,
    paged_decode_attention_xla,
)
from kuberay_tpu.serve import paged_engine as jpe
from kuberay_tpu.serve import paged_kv as jpk
from kuberay_tpu.serve import prefix as jprefix
from kuberay_tpu.serve.engine import Request as JRequest
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.ops import paged_attention as tpa
from kuberay_tpu_torch.serve import paged_kv as tpk
from kuberay_tpu_torch.serve import prefix as tprefix
from kuberay_tpu_torch.serve.engine import Request
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine
from tests.test_torch_attention import _within_local

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JCFG = jllama.CONFIGS["llama_tiny"]
TCFG = tllama.CONFIGS["llama_tiny"]
BS = 8      # block size, as the JAX package's paged tests


@pytest.fixture(scope="module")
def trees():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# prefix hashes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bs", [(0, 8), (7, 8), (8, 8), (37, 8), (64, 16),
                                  (100, 32)])
def test_block_hashes_match_jax(n, bs):
    toks = np.random.default_rng(n).integers(0, 128256, n).tolist()
    got = tprefix.block_hashes(toks, bs)
    assert got == jprefix.block_hashes(toks, bs)
    assert len(got) == n // bs
    assert tprefix.chain_hash(got[-1] if got else 0, toks[:3]) == \
        jprefix.chain_hash(got[-1] if got else 0, toks[:3])


def test_block_hashes_do_not_depend_on_hash_seed():
    """Tuple-of-int hashes are not salted by PYTHONHASHSEED: another
    process with another seed gives the same chain (the gateway and the
    replicas hash in different processes)."""
    toks = list(range(40))
    code = ("from kuberay_tpu_torch.serve.prefix import block_hashes; "
            f"print(block_hashes({toks}, 8))")
    env = {**os.environ, "PYTHONHASHSEED": "12345"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    assert json.loads(out) == tprefix.block_hashes(toks, 8)


# ---------------------------------------------------------------------------
# allocator (ports of tests/test_paged_kv.py's)
# ---------------------------------------------------------------------------

def test_allocator_refcount_and_free():
    a = tpk.BlockAllocator(num_blocks=4, block_size=BS)
    b1, b2 = a.allocate(), a.allocate()
    assert a.num_free == 2 and {b1, b2} == {0, 1}
    a.free(b1)
    assert a.num_free == 3
    with pytest.raises(AssertionError):
        a.free(b1)                      # double free


def test_allocator_exhaustion():
    a = tpk.BlockAllocator(num_blocks=2, block_size=BS)
    assert a.allocate() is not None and a.allocate() is not None
    assert a.allocate() is None


def test_prefix_match_and_cannibalize():
    a = tpk.BlockAllocator(num_blocks=3, block_size=4)
    toks = [1, 2, 3, 4, 5, 6, 7, 8]
    ids = [a.allocate(), a.allocate()]
    a.register_prefix(toks, ids)
    for b in ids:
        a.free(b)                       # refcount 0, still cached
    assert a.resident_prefix_blocks(toks + [9]) == 2
    got = a.match_prefix(toks + [9])    # both full blocks hit
    assert got == ids
    for b in got:
        a.free(b)
    # Demanding all 3 blocks cannibalises the cached ones (LRU first);
    # after that the prefix no longer matches.
    taken = [a.allocate() for _ in range(3)]
    assert None not in taken
    for b in taken:
        a.free(b)
    assert a.match_prefix(toks) == [] and a.registered_hashes() == []


def test_hash_collision_degrades_to_miss():
    """Every block hashing alike must MISS on other tokens (the stored
    block tokens are compared), never serve another prompt's blocks."""
    a = tpk.BlockAllocator(num_blocks=4, block_size=4)
    a.block_hashes = lambda tokens: [42] * (len(tokens) // 4)
    toks1, toks2 = [1, 2, 3, 4], [5, 6, 7, 8]
    b1 = a.allocate()
    a.register_prefix(toks1, [b1])
    assert a.match_prefix(toks2) == []          # collision -> miss
    assert a.resident_prefix_blocks(toks2) == 0
    assert a.match_prefix(toks1) == [b1]        # exact tokens still hit


def test_allocator_hooks_and_import():
    """Register/evict hooks fire as blocks enter and leave the hash table;
    an imported block is published and comes back refcount 1."""
    seen = []
    a = tpk.BlockAllocator(num_blocks=2, block_size=2,
                           on_register=lambda h: seen.append(("reg", h)),
                           on_evict=lambda h: seen.append(("evict", h)))
    h = tprefix.block_hashes([3, 4], 2)[0]
    bid = a.import_block(h, [3, 4])
    assert a.refcount[bid] == 1 and a.lookup_block(h) == (bid, (3, 4))
    assert a.hash_of(bid) == h and a.import_block(h, [3, 4]) is None
    a.free(bid)
    a.allocate()
    a.allocate()                                # cannibalises the cached one
    assert seen == [("reg", h), ("evict", h)]


# ---------------------------------------------------------------------------
# paged decode attention (plain version) and the views
# ---------------------------------------------------------------------------

def _paged_inputs(S, Hq, Hkv, D, nblk, maxb, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, Hq, D)).astype(np.float32)
    pk = rng.normal(size=(Hkv, nblk * BS, D)).astype(np.float32)
    pv = rng.normal(size=(Hkv, nblk * BS, D)).astype(np.float32)
    tables = np.stack([rng.permutation(nblk)[:maxb] for _ in range(S)]
                      ).astype(np.int32)
    tables[1, :2] = tables[0, :2]           # a page shared by two slots
    return q, pk, pv, tables


def test_flat_indices_and_gather_view_match_jax():
    _, pk, _, tables = _paged_inputs(3, 4, 2, 16, 12, 4, seed=1)
    np.testing.assert_array_equal(
        tpa.flat_indices(_t(tables), BS).numpy(),
        np.asarray(jax_flat_indices(jnp.asarray(tables), BS)))
    np.testing.assert_array_equal(
        tpa.gather_view(_t(pk), _t(tables), BS).numpy(),
        np.asarray(jax_gather_view(jnp.asarray(pk), jnp.asarray(tables), BS)))
    spool = np.random.default_rng(2).uniform(size=(2, 12 * BS)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tpk.gather_scales(_t(spool), _t(tables), BS).numpy(),
        np.asarray(jpk.gather_scales(jnp.asarray(spool), jnp.asarray(tables),
                                     BS)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv", [(8, 4), (4, 4), (8, 2)])
def test_paged_decode_ref_matches_pallas_interpret(dtype, Hq, Hkv):
    """The plain version vs the TPU kernel in interpret mode (block size
    8): scrambled tables with a shared page, lengths that end mid-page and
    one that fills the table.  float32 to 1e-5; bf16 to 2e-2 (the kernel
    rounds probabilities to bf16 before P @ V, the port keeps them f32)."""
    S, D, nblk, maxb = 4, 16, 20, 6
    q, pk, pv, tables = _paged_inputs(S, Hq, Hkv, D, nblk, maxb,
                                      seed=Hq + Hkv)
    lens = np.array([1, 17, 40, 48], np.int32)
    jd = getattr(jnp, dtype)
    want = paged_decode_attention_pallas(
        jnp.asarray(q, jd), jnp.asarray(pk, jd), jnp.asarray(pv, jd),
        jnp.asarray(lens), jnp.asarray(tables), BS, interpret=True)
    td = getattr(torch, dtype)
    got = tpa.paged_decode_attention(_t(q).to(td), _t(pk).to(td),
                                     _t(pv).to(td), _t(lens), _t(tables), BS)
    assert got.dtype == td and got.shape == (S, Hq, D)
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0,
                               atol=atol)


def test_paged_decode_ref_zero_length_and_xla():
    """An idle slot gives 0 (the TPU kernel's l == 0 guard) where the XLA
    reference averages V; live slots match the XLA reference."""
    q, pk, pv, tables = _paged_inputs(3, 4, 2, 16, 10, 4, seed=9)
    lens = np.array([0, 9, 32], np.int32)
    got = tpa.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(lens),
                                     _t(tables), BS).numpy()
    want = np.asarray(paged_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(lens),
        jnp.asarray(tables), BS))
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-5)
    assert not got[0].any() and np.abs(want[0]).max() > 0


# ---------------------------------------------------------------------------
# paged forwards
# ---------------------------------------------------------------------------

def test_init_paged_cache_matches_jax():
    for quant in ("none", "int8"):
        want = jax.tree.leaves(jpk.init_paged_cache(JCFG, 8, BS, quant=quant))
        got = jax.tree.leaves(tpk.init_paged_cache(TCFG, 8, BS, quant=quant,
                                                   device="cpu"))
        assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    with pytest.raises(ValueError, match="unknown kv quant"):
        tpk.init_paged_cache(TCFG, 8, BS, quant="fp8", device="cpu")


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_paged_forward_matches_jax(trees, quant):
    """Prefill of 8 tokens then 4 decode steps through the pool with the
    scrambled table [[5, 2, 7, 0]]: logits within 2e-3 of the JAX paged
    forward's, and the pool written where the JAX one is."""
    jp, tp = trees
    if quant == "int8":
        jfwd = jpk.make_paged_quant_forward(BS, decode_impl="xla")
        tfwd = tpk.make_paged_quant_forward(BS)
    else:
        jfwd = jpk.make_paged_forward(BS, decode_impl="xla")
        tfwd = tpk.make_paged_forward(BS)
    toks = np.random.default_rng(1).integers(0, JCFG.vocab_size, (1, 12))
    table = np.array([[5, 2, 7, 0]], np.int32)
    jc = jpk.init_paged_cache(JCFG, 8, BS, quant=quant)
    tc = tpk.init_paged_cache(TCFG, 8, BS, quant=quant, device="cpu")
    jl, jc = jfwd(JCFG, jp, jnp.asarray(toks[:, :8]), jc, jnp.asarray(table),
                  jnp.zeros(1, jnp.int32))
    tl, _ = tfwd(TCFG, tp, _t(toks[:, :8]), tc, _t(table), torch.zeros(1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                               atol=2e-3)
    for t in range(8, 12):
        start = np.array([t], np.int32)
        jl, jc = jfwd(JCFG, jp, jnp.asarray(toks[:, t:t + 1]), jc,
                      jnp.asarray(table), jnp.asarray(start))
        tl, _ = tfwd(TCFG, tp, _t(toks[:, t:t + 1]), tc, _t(table),
                     _t(start))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                                   atol=2e-3)
    # Same positions written: blocks 5 and 2 (prefill), 7 (decode).
    jk = np.asarray(jax.tree.leaves(jc["k"])[-1])
    tk = jax.tree.leaves(tc["k"])[-1].float().numpy()
    np.testing.assert_array_equal(tk != 0, jk != 0)


def test_paged_prefill_gates_padding_per_token(trees):
    """A bucket-padded prefill writes only its real tokens: positions past
    them resolve through the table to block 0, another request's, which
    must stay as it was."""
    _, tp = trees
    fwd = tpk.make_paged_forward(BS)
    cache = tpk.init_paged_cache(TCFG, 4, BS, device="cpu")
    cache["k"][:, :, :BS] = 7.0          # block 0: someone else's
    table = torch.tensor([[2, 0, 0, 0]], dtype=torch.int32)
    toks = torch.arange(1, 17)[None]     # 16 tokens, 5 real
    mask = (torch.arange(16) < 5)[None].float()
    fwd(TCFG, tp, toks, cache, table, torch.zeros(1), torch.ones(1),
        token_mask=mask, logits_index=torch.tensor([4]))
    assert (cache["k"][:, :, :BS] == 7.0).all()
    assert cache["k"][:, :, 2 * BS:2 * BS + 5].abs().sum() > 0
    assert not cache["k"][:, :, 2 * BS + 5:3 * BS].any()


# ---------------------------------------------------------------------------
# paged engine (ports of tests/test_paged_kv.py's)
# ---------------------------------------------------------------------------

# The prompts of the JAX package's engine-parity and prefix-reuse tests.
SHARED = list(range(1, 17))                      # 16 tokens = 2 full blocks
PROMPTS = [[5, 17, 42, 7], [9, 9, 1, 30, 2, 8, 4], [3],
           SHARED + [21, 22], SHARED + [31]]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_paged_engine_matches_jax(trees, quant):
    """Greedy tokens of the paged engine equal the JAX paged engine's
    (decode_impl="xla", the plain reads) on 5 requests over 2 slots, two
    of them sharing a 2-block prefix; the prefix counters agree and every
    block returns to the pool."""
    jp, tp = trees
    jeng = jpe.PagedServeEngine(JCFG, jp, max_slots=2, max_len=64,
                                block_size=BS, decode_impl="xla",
                                kv_quant=quant)
    teng = PagedServeEngine(TCFG, tp, max_slots=2, max_len=64, block_size=BS,
                            device="cpu", kv_quant=quant)
    for i, p in enumerate(PROMPTS):
        jeng.add_request(JRequest(f"r{i}", list(p), max_new_tokens=6))
        teng.add_request(Request(f"r{i}", list(p), max_new_tokens=6))
    want = {r.request_id: (r.tokens, r.finish_reason) for r in jeng.run()}
    got = {r.request_id: (r.tokens, r.finish_reason) for r in teng.run()}
    assert got == want
    keys = ("num_blocks", "free_blocks", "prefix_hit_tokens",
            "prefix_query_tokens")
    assert {k: teng.stats[k] for k in keys} == \
        {k: jeng.stats[k] for k in keys}
    assert teng.stats["prefix_hit_tokens"] == 2 * BS
    assert teng.allocator.num_free == teng.num_blocks


def test_prefix_cache_reuse_changes_nothing(trees):
    """A second request sharing a 2-block prefix hits both blocks and gives
    the tokens a cold engine gives (float32 tiny model)."""
    _, tp = trees
    p1, p2 = SHARED + [21, 22], SHARED + [31]
    cold = PagedServeEngine(TCFG, tp, max_slots=1, max_len=64,
                            block_size=BS, device="cpu")
    cold.add_request(Request("x", list(p2), max_new_tokens=4))
    expected = cold.run()[0].tokens
    eng = PagedServeEngine(TCFG, tp, max_slots=1, max_len=64, block_size=BS,
                           device="cpu")
    eng.add_request(Request("a", list(p1), max_new_tokens=4))
    eng.run()
    assert eng.stats["prefix_hit_tokens"] == 0
    eng.add_request(Request("b", list(p2), max_new_tokens=4))
    assert eng.run()[0].tokens == expected
    assert eng.stats["prefix_hit_tokens"] == 2 * BS


def test_admission_waits_for_memory(trees):
    """A pool too small for two prompts admits them one after the other."""
    _, tp = trees
    eng = PagedServeEngine(TCFG, tp, max_slots=2, max_len=64, block_size=BS,
                           num_blocks=3, device="cpu")   # 24-token budget
    eng.add_request(Request("a", [1] * 10, max_new_tokens=3))
    eng.add_request(Request("b", [2] * 10, max_new_tokens=3))
    assert eng.step() == [] and eng.num_active == 1
    assert [r.request_id for r in eng.queue] == ["b"]
    out = eng.run()
    assert sorted(r.request_id for r in out) == ["a", "b"]
    assert all(r.finish_reason == "length" and len(r.tokens) == 3
               for r in out)


def test_preemption_on_pool_exhaustion(trees):
    """Decode that outgrows the pool finishes "preempted" and returns its
    blocks, rather than writing into blocks it does not own."""
    _, tp = trees
    eng = PagedServeEngine(TCFG, tp, max_slots=1, max_len=128,
                           block_size=BS, num_blocks=2, device="cpu")
    eng.add_request(Request("a", [1] * 12, max_new_tokens=50))
    (out,) = eng.run()
    assert out.finish_reason == "preempted"
    assert 0 < len(out.tokens) < 50
    assert eng.allocator.num_free == eng.num_blocks


def test_unservable_prompt_cancelled_not_livelocked(trees):
    """A prompt larger than the whole pool is cancelled at once; the
    request behind it still runs."""
    _, tp = trees
    eng = PagedServeEngine(TCFG, tp, max_slots=1, max_len=128,
                           block_size=BS, num_blocks=2, device="cpu")
    eng.add_request(Request("big", [1] * 40, max_new_tokens=4))
    eng.add_request(Request("ok", [2] * 6, max_new_tokens=3))
    by_id = {r.request_id: r for r in eng.run(max_steps=50)}
    assert by_id["big"].finish_reason == "cancelled"
    assert by_id["ok"].finish_reason == "length"
    assert len(by_id["ok"].tokens) == 3


def test_headroom_reserved_no_instant_preemption(trees):
    """Block-aligned prompts admitted in one step do not take each other's
    first decode block."""
    _, tp = trees
    eng = PagedServeEngine(TCFG, tp, max_slots=2, max_len=64, block_size=BS,
                           num_blocks=5, device="cpu")
    eng.add_request(Request("a", list(range(1, 17)), max_new_tokens=3))
    eng.add_request(Request("b", list(range(21, 37)), max_new_tokens=3))
    out = eng.run(max_steps=200)
    assert sorted(r.request_id for r in out) == ["a", "b"]
    assert all(r.finish_reason == "length" and len(r.tokens) == 3
               for r in out)


# ---------------------------------------------------------------------------
# server entry point
# ---------------------------------------------------------------------------

def _post(url, body, timeout=60):
    req = urllib.request.Request(
        f"{url}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.load(resp)


def test_server_main_paged_int8_answers_over_http():
    """``python -m kuberay_tpu_torch.serve.server --paged --kv-quant int8
    --device cpu`` serves completions; SIGTERM drains and exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "kuberay_tpu_torch.serve.server", "--model",
         "llama_tiny", "--paged", "--kv-quant", "int8", "--block-size", "8",
         "--max-slots", "2", "--max-len", "64", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        deadline = time.monotonic() + 120
        line = ""
        while "serving" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "server exited early"
        assert "paged KV cache, kv quant int8" in line
        url = "http://" + line.split(" on ")[1].split(" ")[0]
        status, body = _post(url, {"prompt_tokens": SHARED + [3],
                                   "max_tokens": 4})
        assert status == 200 and len(body["tokens"]) == 4
        assert body["finish_reason"] == "length"
        status, again = _post(url, {"prompt_tokens": SHARED + [3],
                                    "max_tokens": 4})
        assert again["tokens"] == body["tokens"]
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as resp:
            stats = json.load(resp)
        assert stats["prefix_hit_tokens"] == 2 * BS
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.gpu
def test_paged_kernel_matches_plain_on_card():
    """On the card: the CUDA paged kernel vs its plain version at the
    Llama-3-8B decode shape (block size 16, scrambled tables with shared
    pages, ragged lengths) and at block sizes 8 and 32, and vs the
    split-and-merge model, under chip_smoke.py's element-wise limits; also
    on lens at split boundaries, every slot full and lens 1 beside full
    slots; two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    C = tpa.CHUNK
    for S, Hq, Hkv, D, bs, nblk, maxb, lens in (
            (8, 32, 8, 128, 16, 1024, 128, [0, 1, 17, 1000, 2048, 2047, 64,
                                            65]),
            (4, 8, 8, 64, 8, 256, 64, [0, 5, 300, 512]),
            (3, 16, 4, 128, 32, 40, 8, [33, 256, 7]),
            # split boundaries, every slot full, 1 beside full
            (8, 32, 8, 128, 16, 1024, 128, [0, 1, C - 1, C, C + 1, 2 * C,
                                            2 * C + 1, 2048]),
            (8, 32, 8, 128, 16, 1024, 128, [2048] * 8),
            (8, 32, 8, 128, 16, 1024, 128, [1, 2048] * 4)):
        q = torch.randn(S, Hq, D, generator=g, device="cuda").bfloat16()
        pk, pv = (torch.randn(Hkv, nblk * bs, D, generator=g,
                              device="cuda").bfloat16() for _ in range(2))
        perm = torch.randperm(nblk, generator=g, device="cuda")
        tables = perm[:S * maxb].reshape(S, maxb).clone()
        tables[1, :2] = tables[0, :2]
        tables = tables.int().contiguous()
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        before = tpa.launches
        got = tpa.paged_decode_attention(q, pk, pv, lt, tables, bs)
        assert tpa.launches == before + 1
        want = tpa.paged_decode_attention_ref(q, pk, pv, lt, tables, bs)
        assert _within_local(got, want)
        assert _within_local(got, tpa.paged_decode_attention_split_ref(
            q, pk, pv, lt, tables, bs))
        assert torch.equal(
            got, tpa.paged_decode_attention(q, pk, pv, lt, tables, bs))
        if lens[0] == 0:
            assert not got[0].any()


def test_paged_cache_is_shared_not_copied(trees):
    """The engine's prefill and decode write the one pool in place."""
    _, tp = trees
    eng = PagedServeEngine(TCFG, tp, max_slots=2, max_len=64, block_size=BS,
                           device="cpu")
    ptr = eng.cache["k"].data_ptr()
    eng.add_request(Request("a", [1, 2, 3], max_new_tokens=3))
    eng.run()
    assert eng.cache["k"].data_ptr() == ptr and eng.cache["k"].any()
