"""PyTorch port: one-row multi-token attention (prefill, prefill chunks)
on the flash forward kernel over the row's live columns.

``serve/kv_cache.py::_live_attention`` against ``_cached_attention``, the
float32 attention over the whole cache it replaces there, and against the
JAX package's dense and paged forwards, through the port's dense
``forward_with_cache`` and paged forward: from an empty cache, past a
block-aligned and an unaligned prefix, a bucket with padding, a chunk at an
offset, a bucket running past ``max_len``; GQA groups 1 and 4.  Then the
engines' ``prefill_kernel`` counter and the calls that keep the old
attention (verify steps over several slots, the int8 cache), and on the
card the kernel at Mistral-7B's heads.

In float32 (``llama_tiny``'s dtype) the path is forced on, and its logits
are held to the old path's and to the JAX forwards' at the paged-forward
tests' 2e-3.  In bf16 the path is taken by itself; one bf16 ulp there is
larger than 2e-3, so each path is held to the float32 forward instead, the
new one no further than 1.5 times the old.  Both hold the written cache or
pool bit for bit where its contents do not depend on attention (layer 0's
K/V) and the written positions alike in every layer.  JAX is imported
inside the JAX test only, so the card's run of the gpu test (on a machine
without JAX) can import this module."""

import dataclasses

import numpy as np
import pytest
import torch

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.serve import engine as teng
from kuberay_tpu_torch.serve import kv_cache as kc
from kuberay_tpu_torch.serve import paged_engine as tpe
from kuberay_tpu_torch.serve import paged_kv as pk

torch.set_num_threads(2)

BASE = llama.CONFIGS["llama_tiny"]           # float32, 2 layers, 4 heads
M = 128                                      # max_len
BLOCK, NUM_BLOCKS = 8, 24

# (name, prefix forwards' lengths before the call, T, real tokens of T)
CASES = (("start0", (), 32, 32),
         ("aligned_prefix", (16,), 32, 32),
         ("unaligned_prefix", (13,), 32, 32),
         ("bucket_padding", (), 64, 41),
         ("chunk_at_offset", (16, 16, 16), 16, 11),
         ("past_max_len", (100,), 64, 20))


def _cfg(group: int, dtype) -> llama.LlamaConfig:
    return dataclasses.replace(BASE, n_kv_heads=BASE.n_heads // group,
                               dtype=dtype)


@pytest.fixture(scope="module")
def trees():
    """bf16 params for each group, and their float32 widening."""
    out = {}
    for group in (1, 4):
        cfg = _cfg(group, torch.bfloat16)
        pb = llama.init_params(cfg, torch.Generator().manual_seed(group),
                               "cpu")
        out[group] = (pb, kc.tree_map(lambda t: t.float(), pb))
    return out


class _Count:
    """Counts calls of a function a module looks up at call time."""

    def __init__(self, monkeypatch, module, name, when=None):
        self.n, real = 0, getattr(module, name)

        def wrapped(*args, **kw):
            if when is None or when(*args):
                self.n += 1
            return real(*args, **kw)
        monkeypatch.setattr(module, name, wrapped)


def _route(monkeypatch, route: str) -> None:
    """``attention_route`` where the dense and the paged forwards look it
    up.  "off": never "live" (the parent's attention); "force": "live" for
    one row of T > 1 whatever the cache's dtype."""
    def forced(B, T, cache):
        if T == 1:
            return "decode"
        return "live" if B == 1 and route == "force" else "masked"
    for module in (kc, pk):
        monkeypatch.setattr(module, "attention_route", forced)


def _inputs(prefix, T):
    """The prefix's and the call's tokens [1, start + T] and a scrambled
    block table [M // BLOCK], as numpy arrays."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, BASE.vocab_size, (1, sum(prefix) + T))
    return toks, rng.permutation(NUM_BLOCKS)[:M // BLOCK]


def _run(layout, cfg, params, prefix, T, real):
    """The prefix's forwards from an empty cache, then the call under
    test; (its logits at the real rows, the cache or pool)."""
    start = sum(prefix)
    toks, table = (torch.from_numpy(a) for a in _inputs(prefix, T))
    if layout == "paged":
        cache = pk.init_paged_cache(cfg, NUM_BLOCKS, BLOCK, device="cpu")
        fwd = pk.make_paged_forward(BLOCK)

        def call(t, s, n):
            mask = (torch.arange(t.shape[1]) < n)[None].float()
            return fwd(cfg, params, t, cache, table[None], torch.tensor([s]),
                       torch.ones(1), token_mask=mask)[0]
    else:
        cache = kc.init_kv_cache(cfg, 1, M, "cpu")

        def call(t, s, n):
            return kc.forward_with_cache(cfg, params, t, cache,
                                         torch.tensor([s]))[0]
    s = 0
    for n in prefix:
        call(toks[:, s:s + n], s, n)
        s += n
    logits = call(toks[:, start:], start, real)
    return logits[:, :real], cache


def _layer0_and_written(a, b) -> bool:
    """Layer 0's K/V bit for bit, and the same positions written in every
    layer (unwritten ones stay 0)."""
    return all(torch.equal(a[n][0], b[n][0]) and
               torch.equal(a[n] != 0, b[n] != 0) for n in ("k", "v"))


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_live_attention_matches_cached_attention(monkeypatch, trees, layout,
                                                 case, group):
    """float32, the path forced on: logits within 2e-3 of the old path's,
    the cache's writes alike, and one flash forward a layer a call."""
    _, prefix, T, real = case
    cfg = _cfg(group, torch.float32)
    p32 = trees[group][1]
    with monkeypatch.context() as m:
        _route(m, "off")
        want, wcache = _run(layout, cfg, p32, prefix, T, real)
    _route(monkeypatch, "force")
    calls = _Count(monkeypatch, kc, "flash_fwd")
    got, gcache = _run(layout, cfg, p32, prefix, T, real)
    assert calls.n == cfg.n_layers * (len(prefix) + 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)
    assert _layer0_and_written(gcache, wcache)
    for n in ("k", "v"):
        np.testing.assert_allclose(gcache[n].numpy(), wcache[n].numpy(),
                                   rtol=2e-3, atol=2e-3)


def _run_jax(layout, group, prefix, T, real):
    """``_run`` through the JAX package's forwards (float32): the dense
    cache written unmasked, as its engine does, the paged pool gated to
    the real tokens; (logits at the real rows, the params, the cache's
    K/V leaves).  A dense call running past ``max_len`` gets its real
    tokens only, and the cache comes back up to them: past
    ``max_seq_len`` the JAX rope lookup fills NaN, and its one-hot insert
    spreads those over the whole cache.  The causal mask keeps padding
    out of the real rows, so their logits are the same either way."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp

    from kuberay_tpu.models import llama as jllama
    from kuberay_tpu.serve import kv_cache as jkc
    from kuberay_tpu.serve import paged_kv as jpk

    base = jllama.CONFIGS["llama_tiny"]
    cfg = dc.replace(base, n_kv_heads=base.n_heads // group)
    params = jllama.init_params(cfg, jax.random.PRNGKey(group))
    toks, table = _inputs(prefix, T)
    if layout == "paged":
        cache = jpk.init_paged_cache(cfg, NUM_BLOCKS, BLOCK)
        fwd = jpk.make_paged_forward(BLOCK, decode_impl="xla")

        def call(cache, t, s, n):
            mask = (np.arange(t.shape[1]) < n)[None].astype(np.float32)
            return fwd(cfg, params, jnp.asarray(t), cache,
                       jnp.asarray(table[None].astype(np.int32)),
                       jnp.array([s], jnp.int32), jnp.ones(1),
                       token_mask=jnp.asarray(mask))
    else:
        cache = jkc.init_kv_cache(cfg, 1, M)

        def call(cache, t, s, n):
            return jkc.forward_with_cache(cfg, params, jnp.asarray(t), cache,
                                          jnp.array([s], jnp.int32))
    s = 0
    for n in prefix:
        _, cache = call(cache, toks[:, s:s + n], s, n)
        s += n
    clip = layout == "dense" and s + T > M
    logits, cache = call(cache, toks[:, s:s + real] if clip else toks[:, s:],
                         s, real)
    upto = s + real if clip else None
    return (np.asarray(logits)[:, :real], jax.tree.map(np.asarray, params),
            {n: np.asarray(cache[n])[:, :, :upto] for n in ("k", "v")})


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_live_attention_matches_jax(monkeypatch, layout, case, group):
    """float32, the path forced on, against the JAX forward of the same
    layout on the same tokens and weights: logits at the real rows within
    2e-3, and the cache or pool written at the same positions and within
    2e-3; one flash forward a layer a call."""
    from kuberay_tpu_torch.models.convert import params_from_jax

    _, prefix, T, real = case
    want, jparams, jcache = _run_jax(layout, group, prefix, T, real)
    cfg = _cfg(group, torch.float32)
    _route(monkeypatch, "force")
    calls = _Count(monkeypatch, kc, "flash_fwd")
    got, cache = _run(layout, cfg, params_from_jax(cfg, jparams, "cpu"),
                      prefix, T, real)
    assert calls.n == cfg.n_layers * (len(prefix) + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    for n in ("k", "v"):
        c = cache[n][:, :, :jcache[n].shape[2]].numpy()
        np.testing.assert_array_equal(c != 0, jcache[n] != 0)
        np.testing.assert_allclose(c, jcache[n], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_bf16_path_as_close_to_float32_as_the_old(monkeypatch, trees, layout,
                                                  case, group):
    """bf16, the path taken by itself (one flash forward a layer a call):
    the logits no further from the float32 forward's than the old path's
    by more than 1.5 times, and the cache's writes alike."""
    _, prefix, T, real = case
    pb, p32 = trees[group]
    cfg = _cfg(group, torch.bfloat16)
    exact, _ = _run(layout, _cfg(group, torch.float32), p32, prefix, T, real)
    with monkeypatch.context() as m:
        _route(m, "off")
        old, ocache = _run(layout, cfg, pb, prefix, T, real)
    calls = _Count(monkeypatch, kc, "flash_fwd")
    new, ncache = _run(layout, cfg, pb, prefix, T, real)
    assert calls.n == cfg.n_layers * (len(prefix) + 1)

    def dist(x):
        return ((x - exact).norm() / exact.norm()).item()
    assert dist(new) <= 1.5 * dist(old)
    assert _layer0_and_written(ncache, ocache)


def test_route_reads_shape_and_cache_dtype():
    """``attention_route``: "live" for one row of T > 1 over a bf16 cache,
    "decode" for one token a row over any cache, "masked" otherwise."""
    bf16 = {"k": torch.zeros(2, 1, 8, 1, 4, dtype=torch.bfloat16)}
    f32 = {"k": torch.zeros(2, 1, 8, 1, 4)}
    int8 = {"k": {"q": torch.zeros(2, 1, 8, 1, 4, dtype=torch.int8)}}
    route = kc.attention_route
    assert route(1, 32, bf16) == "live" and route(1, 2, bf16) == "live"
    assert route(1, 1, bf16) == "decode"           # a decode step
    assert route(4, 5, bf16) == "masked"           # a verify over 4 slots
    assert route(1, 32, f32) == "masked"
    assert route(1, 32, int8) == "masked"
    assert route(4, 1, f32) == route(4, 1, int8) == "decode"


# -- engines -----------------------------------------------------------------

CFG16 = dataclasses.replace(BASE, dtype=torch.bfloat16)
SHARED = list(range(3, 27))                  # 24 tokens: 3 blocks of 8


def _prompts():
    rng = np.random.default_rng(3)
    rnd = [rng.integers(1, BASE.vocab_size, n).tolist() for n in (5, 40, 70)]
    return rnd + [SHARED + [90, 91, 92], SHARED + [93] * 9]


@pytest.fixture(scope="module")
def params16():
    return llama.init_params(CFG16, torch.Generator().manual_seed(0), "cpu")


def _engine(kind, params, **kw):
    if kind == "paged":
        return tpe.PagedServeEngine(CFG16, params, max_slots=2, max_len=M,
                                    block_size=BLOCK, device="cpu", **kw)
    return teng.ServeEngine(CFG16, params, max_slots=2, max_len=M,
                            device="cpu", **kw)


def _serve(engine, prompts, n=6):
    for i, p in enumerate(prompts):
        engine.add_request(teng.Request(f"r{i}", p, max_new_tokens=n))
    return engine.run()


def _multi(q, *rest):
    return q.shape[1] > 1


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_engine_counts_flash_prefills(monkeypatch, params16, kind, chunk):
    """Every prefill (each chunk counted; in the paged engine some past a
    cached prefix) takes the flash path: ``prefill_kernel`` equals
    ``prefills`` and the flash forwards a layer each; no multi-token call
    reaches ``_cached_attention``."""
    flash = _Count(monkeypatch, kc, "flash_fwd")
    cached = _Count(monkeypatch, pk if kind == "paged" else kc,
                    "_cached_attention", _multi)
    engine = _engine(kind, params16, prefill_chunk=chunk)
    done = _serve(engine, _prompts())
    st = engine.stats
    assert len(done) == 5 and st["prefills"] > 5 * (chunk > 0)
    assert st["prefill_kernel"] == st["prefills"]
    assert flash.n == CFG16.n_layers * st["prefills"] and cached.n == 0
    if kind == "paged":
        assert st["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_verify_steps_keep_cached_attention(monkeypatch, params16, kind):
    """A speculative engine's verify steps run every slot in one forward
    (rows at different offsets): ``_cached_attention`` as before, and
    ``prefill_kernel`` counts the prefills only."""
    flash = _Count(monkeypatch, kc, "flash_fwd")
    cached = _Count(monkeypatch, pk if kind == "paged" else kc,
                    "_cached_attention", _multi)
    engine = _engine(kind, params16, speculative=4)
    rep = [3, 4, 5, 6] * 6
    _serve(engine, [rep, rep[::-1] + rep, [9] * 12], n=16)
    st = engine.stats
    verify = engine.spec_stats["verify_steps"]
    assert verify > 0 and st["prefill_kernel"] == st["prefills"] == 3
    assert flash.n == CFG16.n_layers * 3
    assert cached.n == CFG16.n_layers * verify


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_int8_cache_keeps_its_attention(monkeypatch, params16, kind):
    """The int8 cache's prefills read it natively, as before: no flash
    forward, ``prefill_kernel`` 0."""
    flash = _Count(monkeypatch, kc, "flash_fwd")
    quant = _Count(monkeypatch, pk if kind == "paged" else kc,
                   "_cached_attention_quant_multi")
    engine = _engine(kind, params16, kv_quant="int8")
    _serve(engine, _prompts())
    st = engine.stats
    assert st["prefills"] == 5 and st["prefill_kernel"] == 0
    assert flash.n == 0 and quant.n == CFG16.n_layers * 5


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_flash_prefill_on_card():
    """On the card, at Mistral-7B's heads (32 / 8 of 128): the flash path
    against ``_cached_attention`` over a 4096-column cache under
    chip_smoke.py's element-wise limits, at T 512, 1024 and 4096 from an
    empty cache and T 512 past a 1024-token prefix; and one prefill
    forward of a 32-layer model at those heads launches 32 flash
    forwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from kuberay_tpu_torch.ops import launches
    g = torch.Generator(device="cuda").manual_seed(0)
    Hq, Hkv, D, Mx = 32, 8, 128, 4096
    for start, T in ((0, 512), (0, 1024), (0, 4096), (1024, 512)):
        ck, cv = (torch.randn(1, Mx, Hkv, D, generator=g, device="cuda"
                              ).bfloat16() for _ in range(2))
        q = torch.randn(1, T, Hq, D, generator=g, device="cuda").bfloat16()
        pos = start + torch.arange(T, device="cuda")[None]
        lens = torch.full((1,), start + T, dtype=torch.int32, device="cuda")
        want = kc._cached_attention(q, ck, cv, lens, pos)
        n = launches.snapshot()["flash_fwd"]
        got = kc._live_attention(q, ck[:, :start + T].contiguous(),
                                 cv[:, :start + T].contiguous(), lens, pos)
        assert launches.snapshot()["flash_fwd"] == n + 1
        rec = chip_smoke.local_err(got, want)
        assert chip_smoke.within_local(rec), (start, T, rec)
    cfg = dataclasses.replace(llama.CONFIGS["llama3_8b"], d_ff=1024,
                              vocab_size=1024)
    params = llama.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), "cuda")
    cache = kc.init_kv_cache(cfg, 1, 1024, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, 1024), generator=g,
                         device="cuda")
    n = launches.snapshot()["flash_fwd"]
    with torch.no_grad():
        kc.forward_with_cache(cfg, params, toks, cache,
                              torch.zeros(1, dtype=torch.long, device="cuda"))
    assert cfg.n_layers == 32 and launches.snapshot()["flash_fwd"] == n + 32
