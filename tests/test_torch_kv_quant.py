"""PyTorch port, int8 KV cache: quantisation, the int8 decode attention's
plain version, the int8 cache forward and the dense engine with
``kv_quant="int8"`` against the JAX package.

Inputs come from numpy with a fixed seed and go to both packages.  On CPU
tensors the port's wrappers take their plain versions; the CUDA kernel is
checked by the ``gpu`` test below and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.ops.decode_attention import (
    decode_attention_quant_pallas,
    decode_attention_quant_xla,
    dequant_lanes as jax_dequant_lanes,
)
from kuberay_tpu.serve import engine as jeng
from kuberay_tpu.serve import kv_cache as jkv
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.ops import decode_attention as tda
from kuberay_tpu_torch.serve import engine as teng
from kuberay_tpu_torch.serve import kv_cache as tkv
from tests.test_torch_attention import _within_local

torch.set_num_threads(2)

JCFG = jllama.CONFIGS["llama_tiny"]
TCFG = tllama.CONFIGS["llama_tiny"]


@pytest.fixture(scope="module")
def trees():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _quant_inputs(S, M, Hkv, D, seed):
    """K/V quantised by the JAX package into the cache layout (scales
    [S, Hkv, M]), as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x8, s = jkv.quantize_kv(jnp.asarray(rng.normal(size=(S, M, Hkv, D)),
                                            jnp.float32))
        out += [np.asarray(x8), np.asarray(jnp.moveaxis(s[..., 0], -1, 1))]
    return out                              # kq, ks, vq, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 7, 2, 16), (3, 64), (2, 5, 8, 128)])
def test_quantize_kv_matches_jax(dtype, shape):
    """int8 values exactly equal, scales to 1e-7 (both: f32 absmax / 127,
    floored at 1e-8; round half to even; clip to +-127).  A zero vector
    takes the floor."""
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape) * rng.uniform(0.1, 10, shape[:-1] + (1,))
    x[(0,) * (len(shape) - 1)] = 0.0
    jx = jnp.asarray(x, jnp.float32).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    jq, js = jkv.quantize_kv(jx)
    tq, ts = tkv.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        tkv.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jkv.dequantize_kv(jq, js, jnp.float32)), rtol=0,
        atol=1e-6)


def test_round_half_to_even_like_jax():
    """Values that land exactly on .5 steps of the scale."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    jq, _ = jkv.quantize_kv(jnp.asarray(x))
    tq, _ = tkv.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]


def test_init_kv_cache_int8_layout_matches_jax():
    want = jkv.init_kv_cache(JCFG, slots=4, max_len=64, quant="int8")
    got = tkv.init_kv_cache(TCFG, 4, 64, "cpu", quant="int8")
    for n in ("k", "v"):
        for leaf in ("q", "s"):
            assert tuple(got[n][leaf].shape) == want[n][leaf].shape
            assert str(got[n][leaf].dtype).split(".")[-1] == \
                str(want[n][leaf].dtype)
    dense = tkv.init_kv_cache(TCFG, 4, 64, "cpu")
    nbytes = lambda c: sum(t.numel() * t.element_size()        # noqa: E731
                           for v in c.values()
                           for t in (v.values() if isinstance(v, dict)
                                     else [v]))
    assert nbytes(got) < 0.6 * nbytes(dense)
    with pytest.raises(ValueError, match="unknown kv quant"):
        tkv.init_kv_cache(TCFG, 1, 8, "cpu", quant="fp4")


def test_dequant_lanes_matches_jax():
    kq, ks, _, _ = _quant_inputs(3, 10, 2, 16, seed=3)
    np.testing.assert_allclose(
        tda.dequant_lanes(_t(kq), _t(ks), torch.float32).numpy(),
        np.asarray(jax_dequant_lanes(kq, ks, jnp.float32)), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("lens", [[64, 17, 1, 33], [64, 64, 64, 64]])
def test_decode_quant_ref_matches_pallas_interpret(lens):
    """The plain version vs the TPU kernel in interpret mode (bkv 16), with
    lengths that skip blocks; float32 (2e-4, as the JAX package's own
    kernel-vs-XLA test)."""
    S, M, Hq, Hkv, D = 4, 64, 8, 4, 16
    q = np.random.default_rng(5).normal(size=(S, Hq, D)).astype(np.float32)
    kq, ks, vq, vs = _quant_inputs(S, M, Hkv, D, seed=5)
    lens = np.array(lens, np.int32)
    want = decode_attention_quant_pallas(q, kq, ks, vq, vs, jnp.asarray(lens),
                                         bkv=16, interpret=True)
    got = tda.decode_attention_quant(_t(q), _t(kq), _t(ks), _t(vq), _t(vs),
                                     _t(lens))
    assert got.dtype == torch.float32 and got.shape == (S, Hq, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("Hq,Hkv,M", [(4, 2, 40), (4, 4, 50)])
def test_decode_quant_ref_matches_xla_on_live_slots(Hq, Hkv, M):
    """vs the XLA reference at cache lengths no block divides; an idle
    slot gives 0 where the XLA reference averages V (as for bf16)."""
    S, D = 4, 16
    q = np.random.default_rng(M).normal(size=(S, Hq, D)).astype(np.float32)
    kq, ks, vq, vs = _quant_inputs(S, M, Hkv, D, seed=M)
    lens = np.array([0, 3, M // 2, M], np.int32)
    want = np.asarray(decode_attention_quant_xla(q, kq, ks, vq, vs,
                                                 jnp.asarray(lens)))
    got = tda.decode_attention_quant(_t(q), _t(kq), _t(ks), _t(vq), _t(vs),
                                     _t(lens)).numpy()
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-5)
    assert not got[0].any()


@pytest.mark.parametrize("T", [1, 5])
def test_insert_scales_matches_jax(T):
    """Scale writes into the [S, Hkv, M] layout, one-token and multi-token,
    with a write-masked row."""
    S, H, M = 3, 2, 16
    rng = np.random.default_rng(T)
    cs = rng.uniform(size=(S, H, M)).astype(np.float32)
    new = rng.uniform(size=(S, T, H)).astype(np.float32)
    start = np.array([0, 4, 9], np.int32)
    wm = np.array([1.0, 0.0, 1.0], np.float32)
    pos = start[:, None] + np.arange(T)[None, :]
    want = jkv._insert_scales(jnp.asarray(cs), jnp.asarray(new),
                              jnp.asarray(pos), jnp.asarray(start),
                              jnp.asarray(wm), T)
    got = _t(cs)
    tkv._insert(got.transpose(1, 2), _t(new), _t(pos).long(), _t(start),
                _t(wm), T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)


def test_cached_attention_quant_multi_matches_jax():
    """Multi-token attention straight off the int8 cache."""
    B, T, Hq, Hkv, D, M = 2, 6, 4, 2, 16, 24
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    kq, ks, vq, vs = _quant_inputs(B, M, Hkv, D, seed=7)
    start = np.array([0, 10], np.int32)
    pos = start[:, None] + np.arange(T)[None, :]
    lens = start + T
    want = jkv._cached_attention_quant_multi(
        jnp.asarray(q), {"q": kq, "s": ks}, {"q": vq, "s": vs},
        jnp.asarray(lens), jnp.asarray(pos))
    got = tkv._cached_attention_quant_multi(
        _t(q), {"q": _t(kq), "s": _t(ks)}, {"q": _t(vq), "s": _t(vs)},
        _t(lens), _t(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_make_quantized_forward_matches_jax(trees):
    """Prefill of 8 tokens then 4 decode steps through the int8 cache, two
    rows: logits within 2e-3 of the JAX forward's (float32 tiny model; a
    K/V element that rounds to the other int8 on one side moves logits by
    far less)."""
    jp, tp = trees
    B, max_len = 2, 32
    toks = np.random.default_rng(1).integers(0, JCFG.vocab_size, (B, 12))
    jfwd = jkv.make_quantized_forward(decode_impl="xla")
    tfwd = tkv.make_quantized_forward()
    jc = jkv.init_kv_cache(JCFG, B, max_len, quant="int8")
    tc = tkv.init_kv_cache(TCFG, B, max_len, "cpu", quant="int8")
    jl, jc = jfwd(JCFG, jp, jnp.asarray(toks[:, :8]), jc,
                  jnp.zeros(B, jnp.int32))
    tl, _ = tfwd(TCFG, tp, _t(toks[:, :8]), tc, torch.zeros(B))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                               atol=2e-3)
    for t in range(8, 12):
        start = np.full(B, t, np.int32)
        jl, jc = jfwd(JCFG, jp, jnp.asarray(toks[:, t:t + 1]), jc,
                      jnp.asarray(start))
        tl, _ = tfwd(TCFG, tp, _t(toks[:, t:t + 1]), tc, _t(start))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                                   atol=2e-3)
    np.testing.assert_allclose(tc["k"]["s"].numpy(), np.asarray(jc["k"]["s"]),
                               rtol=1e-5, atol=1e-7)


def _run(eng, reqs):
    for r in reqs:
        eng.add_request(r)
    return {r.request_id: (r.tokens, r.finish_reason) for r in eng.run()}


def test_int8_dense_engine_matches_jax(trees):
    """Greedy tokens of the dense engine over the int8 cache equal the JAX
    engine's (decode_impl="xla", the plain int8 read), three requests on
    two slots."""
    jp, tp = trees
    prompts = [[5, 17, 42, 7], [9, 9, 1, 30, 2, 8, 4], [3]]
    want = _run(jeng.ServeEngine(JCFG, jp, max_slots=2, max_len=64,
                                 kv_quant="int8", decode_impl="xla"),
                [jeng.Request(f"r{i}", p, max_new_tokens=6)
                 for i, p in enumerate(prompts)])
    eng = teng.ServeEngine(TCFG, tp, max_slots=2, max_len=64, device="cpu",
                           kv_quant="int8")
    got = _run(eng, [teng.Request(f"r{i}", p, max_new_tokens=6)
                     for i, p in enumerate(prompts)])
    assert got == want and all(len(v[0]) == 6 for v in got.values())
    with pytest.raises(ValueError, match="unknown kv quant"):
        teng.ServeEngine(TCFG, tp, max_slots=1, max_len=16, device="cpu",
                         kv_quant="int4")


@pytest.mark.gpu
def test_int8_kernel_matches_plain_on_card():
    """On the card: the CUDA int8 decode kernel vs its plain version at the
    Llama-3-8B decode shape, a cache length no tile divides, and D 64, and
    vs the same attention with the cache dequantised in float32 (only the
    output rounded), and vs the split-and-merge model, under
    chip_smoke.py's element-wise limits; also on lens at split boundaries,
    every slot full and lens 1 beside full slots; two calls give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    C = tda.CHUNK
    for S, M, Hq, Hkv, D, lens in (
            (8, 2048, 32, 8, 128, [0, 1, 17, 1000, 2048, 2047, 64, 65]),
            (8, 1000, 32, 8, 128, [0, 1, 63, 64, 65, 500, 999, 1000]),
            (4, 512, 8, 8, 64, [0, 5, 300, 512]),
            # split boundaries, every slot full, 1 beside full
            (8, 2048, 32, 8, 128, [0, 1, C - 1, C, C + 1, 2 * C, 2 * C + 1,
                                   2048]),
            (8, 2048, 32, 8, 128, [2048] * 8),
            (8, 2048, 32, 8, 128, [1, 2048] * 4)):
        q = torch.randn(S, Hq, D, generator=g, device="cuda").bfloat16()
        cache = []
        for _ in range(2):
            x8, s = tkv.quantize_kv(torch.randn(S, M, Hkv, D, generator=g,
                                                device="cuda"))
            cache += [x8, s[..., 0].transpose(1, 2).contiguous()]
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        before = tda.launches_quant
        got = tda.decode_attention_quant(q, *cache, lt)
        assert tda.launches_quant == before + 1
        want = tda.decode_attention_quant_ref(q, *cache, lt)
        assert _within_local(got, want)
        kq, ks, vq, vs = cache
        want32 = tda.decode_attention_ref(
            q, tda.dequant_lanes(kq, ks, torch.float32),
            tda.dequant_lanes(vq, vs, torch.float32), lt)
        assert _within_local(got, want32)
        assert _within_local(got, tda.decode_attention_quant_split_ref(
            q, *cache, lt))
        assert torch.equal(got, tda.decode_attention_quant(q, *cache, lt))
        if lens[0] == 0:
            assert not got[0].any()
