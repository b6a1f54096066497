"""PyTorch port, int8 weights (W8A16): quantisation bit for bit against the
JAX package, the dequantised tree, the round-trip error, per-layer scales,
the layer-at-a-time forward, and the engines with ``weight_quant="int8"``
(alone, and paged with the int8 cache, chunked prefill and speculation)
against the JAX engines.  Mirrors ``tests/test_weight_quant.py``.

Inputs come from numpy with a fixed seed and go to both packages; the JAX
engines run with ``decode_impl="xla"``, the port's on CPU tensors (plain
versions of its kernels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.serve import engine as jeng
from kuberay_tpu.serve import kv_cache as jkv
from kuberay_tpu.serve import paged_engine as jpe
from kuberay_tpu.serve import weight_quant as jwq
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.serve import engine as teng
from kuberay_tpu_torch.serve import kv_cache as tkv
from kuberay_tpu_torch.serve import paged_engine as tpe
from kuberay_tpu_torch.serve import weight_quant as twq

torch.set_num_threads(2)

JCFG = jllama.CONFIGS["llama_tiny"]
TCFG = tllama.CONFIGS["llama_tiny"]
LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")
PROMPTS = ([1, 2, 3, 4, 5], [9, 8, 7], [3, 4, 5, 6] * 5, [11] * 12)
# (engine kind, port/JAX engine options) of the engine comparisons.
MODES = {
    "dense": ("dense", {}),
    "paged": ("paged", {}),
    "combo": ("paged", {"prefill_chunk": 8, "speculative": 2,
                        "kv_quant": "int8"}),
}


@pytest.fixture(scope="module")
def trees():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")


def _run(eng, cls):
    for i, p in enumerate(PROMPTS):
        eng.add_request(cls(f"r{i}", list(p), max_new_tokens=8))
    return {r.request_id: (r.tokens, r.finish_reason) for r in eng.run()}


def _engine(pkg, kind, params, **kw):
    if pkg == "jax":
        cls = jpe.PagedServeEngine if kind == "paged" else jeng.ServeEngine
        kw = {**kw, "decode_impl": "xla"}
    else:
        cls = tpe.PagedServeEngine if kind == "paged" else teng.ServeEngine
        kw = {**kw, "device": "cpu"}
    if kind == "paged":
        kw["block_size"] = 8
    return cls(JCFG if pkg == "jax" else TCFG, params, max_slots=2,
               max_len=64, weight_quant="int8", **kw)


@pytest.fixture(scope="module")
def jax_ref(trees):
    """The JAX engines' greedy tokens, spec_stats and prefix hits in every
    mode, computed once for the module."""
    out = {}
    for name, (kind, kw) in MODES.items():
        eng = _engine("jax", kind, trees[0], **kw)
        out[name] = (_run(eng, jeng.Request), dict(eng.spec_stats),
                     eng.stats.get("prefix_hit_tokens"))
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("leaf", LEAVES)
def test_quantized_leaves_equal_jax_bit_for_bit(trees, leaf):
    """int8 values and float32 scales equal the JAX package's, bit for
    bit: f32 amax over the contraction axis, max(amax, 1e-8) / 127, round
    half to even, clip to +-127."""
    jp, tp = trees
    jq, tq = jwq.quantize_weights(jp), twq.quantize_weights(tp)
    j = jq[leaf] if leaf == "lm_head" else jq["layers"][leaf]
    t = tq[leaf] if leaf == "lm_head" else tq["layers"][leaf]
    assert t["q8"].dtype == torch.int8 and t["s8"].dtype == torch.float32
    assert tuple(t["s8"].shape) == tuple(j["s8"].shape)
    np.testing.assert_array_equal(t["q8"].numpy(), np.asarray(j["q8"]))
    np.testing.assert_array_equal(_bits(t["s8"].numpy()),
                                  _bits(np.asarray(j["s8"])))


def test_roundtrip_error_bounded_and_structure(trees):
    jp, tp = trees
    q = twq.quantize_weights(tp)
    assert q["layers"]["wq"]["q8"].dtype == torch.int8
    assert q["layers"]["w_down"]["s8"].dtype == torch.float32
    assert q["embed"] is tp["embed"] and q["final_norm"] is tp["final_norm"]
    err = twq.quantization_error(tp)
    assert err < 0.02
    assert err == pytest.approx(jwq.quantization_error(jp), rel=0, abs=1e-9)
    d = twq.dequantize_weights(q)
    jd = jwq.dequantize_weights(jwq.quantize_weights(jp))
    for leaf in LEAVES:
        got = d[leaf] if leaf == "lm_head" else d["layers"][leaf]
        want = jd[leaf] if leaf == "lm_head" else jd["layers"][leaf]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    d32 = twq.dequantize_weights(q, dtype=torch.float32)
    jd32 = jwq.dequantize_weights(jwq.quantize_weights(jp), jnp.float32)
    np.testing.assert_array_equal(d32["layers"]["wo"].numpy(),
                                  np.asarray(jd32["layers"]["wo"]))


def test_footprint_roughly_halved(trees):
    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()
    _, tp = trees
    bf16 = {k: v.bfloat16() for k, v in tp["layers"].items()}
    assert nbytes(twq.quantize_weights({"layers": bf16})) < \
        0.6 * nbytes(bf16)


def test_per_layer_scales_survive_loud_layer(trees):
    """A 10x louder layer 0 does not crush layer 1's resolution: scales
    reduce over the contraction axis only, [L, 1, out], as JAX's."""
    jp, tp = trees
    wq = np.array(jp["layers"]["wq"], np.float32)
    wq[0] *= 10.0
    jq = jwq.quantize_weights({"layers": {"wq": jnp.asarray(wq)}})
    tq = twq.quantize_weights({"layers": {"wq": torch.from_numpy(wq)}})
    assert tq["layers"]["wq"]["s8"].shape[0] == wq.shape[0]
    np.testing.assert_array_equal(tq["layers"]["wq"]["q8"].numpy(),
                                  np.asarray(jq["layers"]["wq"]["q8"]))
    d = twq.dequantize_weights(tq, torch.float32)["layers"]["wq"].numpy()
    rel = np.max(np.abs(d[1] - wq[1])) / np.max(np.abs(wq[1]))
    assert rel < 0.02, rel


def test_logits_equal_jax_dequant_forward(trees):
    """The cache forward through the dequantising wrapper gives the JAX
    wrapper's logits, and stays close to the bf16-free dense forward."""
    jp, tp = trees
    toks = np.array([[1, 2, 3, 4, 5, 6, 7, 8]])
    jfwd = jwq.make_weight_dequant_forward(jkv.forward_with_cache)
    jlogits, _ = jfwd(JCFG, jwq.quantize_weights(jp), jnp.asarray(toks),
                      jkv.init_kv_cache(JCFG, 1, 16),
                      jnp.zeros((1,), jnp.int32))
    tfwd = twq.make_weight_dequant_forward(tkv.forward_with_cache)
    start = torch.zeros(1, dtype=torch.long)
    with torch.no_grad():
        got, _ = tfwd(TCFG, twq.quantize_weights(tp), torch.from_numpy(toks),
                      tkv.init_kv_cache(TCFG, 1, 16, "cpu"), start)
        ref, _ = tkv.forward_with_cache(TCFG, tp, torch.from_numpy(toks),
                                        tkv.init_kv_cache(TCFG, 1, 16, "cpu"),
                                        start)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), rtol=0,
                               atol=2e-5)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() < 0.1 * max(scale, 1.0)


def test_forward_dequantises_one_layer_at_a_time(trees, monkeypatch):
    """No whole bf16 tree is built: every dequantisation in a forward is
    of one layer's matrix (or lm_head, read last, for the logits)."""
    _, tp = trees
    q = twq.quantize_weights(tp)
    seen = []
    real = twq._dequant

    def spy(leaf, *a, **kw):
        seen.append(tuple(leaf["q8"].shape))
        return real(leaf, *a, **kw)

    monkeypatch.setattr(twq, "_dequant", spy)
    fwd = twq.make_weight_dequant_forward(tkv.forward_with_cache)
    with torch.no_grad():
        fwd(TCFG, q, torch.tensor([[1, 2, 3]]),
            tkv.init_kv_cache(TCFG, 1, 8, "cpu"), torch.zeros(1))
    per_layer = 7                     # wq wk wv wo w_gate w_up w_down
    assert len(seen) == TCFG.n_layers * per_layer + 1
    assert all(len(s) == 2 for s in seen)
    assert seen[-1] == tuple(tp["lm_head"].shape)


def test_donated_tree_gives_up_its_leaves(trees):
    _, tp = trees
    tree = {"embed": tp["embed"], "layers": dict(tp["layers"]),
            "lm_head": tp["lm_head"]}
    q = twq.quantize_weights(tree, donate=True)
    assert set(tree) == {"embed", "layers"}
    assert set(tree["layers"]) == {"attn_norm", "mlp_norm"}
    assert twq._is_quant_leaf(q["lm_head"]) and q["embed"] is tp["embed"]


def test_unknown_weight_quant_rejected(trees):
    _, tp = trees
    for cls in (teng.ServeEngine, tpe.PagedServeEngine):
        with pytest.raises(ValueError, match="weight_quant"):
            cls(TCFG, tp, max_slots=2, max_len=64, device="cpu",
                weight_quant="int4")


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_tokens_equal_jax_int8_weights(trees, jax_ref, mode):
    """Greedy tokens of the port's engines with int8 weights equal the JAX
    engines': dense, paged, and paged with the int8 cache, chunked
    prefill and speculation together (spec_stats and prefix hits too);
    a second run gives the same tokens."""
    kind, kw = MODES[mode]
    eng = _engine("torch", kind, trees[1], **kw)
    got = _run(eng, teng.Request)
    want, spec, hits = jax_ref[mode]
    assert got == want and all(len(v[0]) == 8 for v in got.values())
    assert eng.spec_stats == spec
    assert eng.stats.get("prefix_hit_tokens") == hits
    assert _run(_engine("torch", kind, trees[1], **kw), teng.Request) == got
    if mode == "combo":
        assert spec["verify_steps"] > 0 and eng.prefills > len(PROMPTS)
