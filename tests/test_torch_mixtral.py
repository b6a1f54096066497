"""PyTorch port, Mixtral and the MoE FFN against the JAX package: the
grouped expert FFN against its all-experts reference and against JAX
(skewed and masked routing), capacity dispatch with overflow and a token
mask (outputs and aux losses), routing ties, the loss and every gradient
leaf with the chunked CE off and on, and greedy tokens of both serving
engines (prefix hits, chunked prefill, int8 weights and pools,
speculation) against the JAX engines built with ``decode_impl="xla"``.

Inputs come from numpy with a fixed seed; JAX params are carried over by
``params_from_jax``.  mixtral_tiny computes in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import mixtral as jmx
from kuberay_tpu.ops import moe_matmul as jmm
from kuberay_tpu.serve import engine as jeng
from kuberay_tpu.serve import paged_engine as jpe
from kuberay_tpu_torch.models import mixtral as tmx
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.ops import launches
from kuberay_tpu_torch.ops import moe_matmul as tmm
from kuberay_tpu_torch.serve import engine as teng
from kuberay_tpu_torch.serve.kv_cache import (
    base_forward_for,
    forward_with_cache_mixtral,
)
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine
from kuberay_tpu_torch.serve.weight_quant import DequantView, quantize_weights

torch.set_num_threads(2)

JCFG = jmx.CONFIGS["mixtral_tiny"]
TCFG = tmx.CONFIGS["mixtral_tiny"]
ATOL = 1e-5                 # float32 parity, as tests/test_torch_train.py


@pytest.fixture(scope="module")
def trees():
    jp = jmx.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _layer0(trees):
    jp, tp = trees
    return (jax.tree.map(lambda a: a[0], jp["layers"]),
            {k: v[0] for k, v in tp["layers"].items()})


# ---------------------------------------------------------------------------
# config and tree
# ---------------------------------------------------------------------------

def test_configs_and_axes_match_jax():
    assert set(tmx.CONFIGS) == set(jmx.CONFIGS)
    for name, jc in jmx.CONFIGS.items():
        tc = tmx.CONFIGS[name]
        for f in dataclasses.fields(jc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tmx.param_axes(tc) == jmx.param_axes(jc)
    big = tmx.CONFIGS["mixtral_8x7b"]
    assert (big.d_model, big.n_heads, big.n_kv_heads, big.head_dim,
            big.d_ff, big.n_experts, big.top_k, big.vocab_size,
            big.rope_theta, big.xent_chunk) == \
        (4096, 32, 8, 128, 14336, 8, 2, 32000, 1e6, 8192)


def test_init_params_tree_and_count_match_jax(trees):
    jp, tp = trees
    meta = tmx.init_params(tmx.CONFIGS["mixtral_8x7b"], device="meta")
    ours = tmx.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == shapes
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == shapes
    assert all(bool(torch.equal(a, _t(b))) for a, b in zip(
        jax.tree.leaves(tp), jax.tree.leaves(jax.tree.map(np.asarray, jp))))
    n = sum(t.numel() for t in jax.tree.leaves(meta))
    assert n == tmx.CONFIGS["mixtral_8x7b"].num_params()
    assert 46.6e9 < n < 46.8e9               # Mixtral-8x7B's 46.7 B


# ---------------------------------------------------------------------------
# the grouped FFN
# ---------------------------------------------------------------------------

def _routing(case, T=24, E=4, K=2, seed=0):
    rng = np.random.default_rng(seed)
    if case == "skewed":                     # 3 of 4 experts nearly idle
        topi = np.stack([np.zeros(T, int),
                         np.where(rng.random(T) < 0.9, 1, 3)], 1)
    else:
        topi = np.stack([rng.permutation(E)[:K] for _ in range(T)])
    topw = rng.random((T, K)).astype(np.float32)
    if case == "masked":
        topw[T // 2:] = 0.0
    return topi.astype(np.int32), topw


@pytest.mark.parametrize("case", ["uniform", "skewed", "masked"])
def test_grouped_ffn_matches_reference_and_jax(trees, case):
    jlp, tlp = _layer0(trees)
    topi, topw = _routing(case)
    x = np.random.default_rng(1).standard_normal(
        (len(topi), TCFG.d_model)).astype(np.float32)
    args = (tlp["w_gate"], tlp["w_up"], tlp["w_down"], _t(topi), _t(topw))
    syncs = launches.snapshot()["moe_host_syncs"]
    got = tmm.grouped_moe_ffn(_t(x), *args)
    assert launches.snapshot()["moe_host_syncs"] == syncs + 1
    ref = tmm.dropless_reference(_t(x), *args)
    jgot = jmm.grouped_moe_ffn(jnp.asarray(x), jlp["w_gate"], jlp["w_up"],
                               jlp["w_down"], jnp.asarray(topi),
                               jnp.asarray(topw))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=0,
                               atol=ATOL)
    if case == "masked":
        assert not got[len(topi) // 2:].any()


def test_flops_accounting_matches_jax():
    assert tmm.moe_ffn_flops(64, 128, 256, 8, 2) == \
        jmm.moe_ffn_flops(64, 128, 256, 8, 2)


@pytest.mark.parametrize("impl", ["grouped", "dense"])
def test_dropless_layer_matches_jax(trees, impl):
    jlp, tlp = _layer0(trees)
    x = np.random.default_rng(2).standard_normal(
        (2, 8, TCFG.d_model)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0
    got = tmx.moe_ffn_dropless(TCFG, _t(x), tlp, token_mask=_t(mask),
                               impl=impl)
    want = jmx.moe_ffn_dropless(JCFG, jnp.asarray(x), jlp,
                                token_mask=jnp.asarray(mask), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# routing and capacity dispatch
# ---------------------------------------------------------------------------

def test_routing_tie_goes_to_the_lower_expert():
    """Two router columns equal: the tied experts' probabilities are equal
    bit for bit, and top-k takes the lower index first, as lax.top_k."""
    cfg = dataclasses.replace(TCFG, n_experts=4, top_k=2)
    rng = np.random.default_rng(3)
    router = rng.standard_normal((cfg.d_model, 4)).astype(np.float32)
    router[:, 3] = router[:, 2]
    router[:, 0] = router[:, 2] + 1.0          # expert 0 leads where x > 0
    x = np.abs(rng.standard_normal((16, cfg.d_model))).astype(np.float32)
    _, probs, _, topi = tmx.route(cfg, _t(x), _t(router))
    jp = jax.nn.softmax((jnp.asarray(x) @ jnp.asarray(router)
                         ).astype(jnp.float32), axis=-1)
    _, jtopi = jax.lax.top_k(jp, cfg.top_k)
    assert bool((probs[:, 2] == probs[:, 3]).all())
    assert topi.tolist() == np.asarray(jtopi).tolist()
    assert 2 in topi[:, 1].tolist() and 3 not in topi.tolist()


def test_bf16_routing_keeps_the_working_dtype_product():
    """At bf16 the router product rounds to bf16 before the float32 cast,
    which makes ties; the port picks JAX's experts for every token, and
    upcasting the operands first would not."""
    cfg = dataclasses.replace(TCFG, dtype=torch.bfloat16, n_experts=8)
    rng = np.random.default_rng(4)
    # Router columns close to one direction and tokens along it: logits
    # near 24, where bf16's spacing is 0.125, so many tie.
    base = rng.standard_normal(cfg.d_model).astype(np.float32)
    router = (base[:, None] + 0.05 * rng.standard_normal(
        (cfg.d_model, 8))).astype(np.float32) * 0.2
    x = (rng.standard_normal((512, cfg.d_model)) + 2 * base
         ).astype(np.float32)
    xb, rb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, router))
    _, probs, topw, topi = tmx.route(cfg, xb, rb)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jr = jnp.asarray(router).astype(jnp.bfloat16)
    jprobs = jax.nn.softmax((jx @ jr).astype(jnp.float32), axis=-1)
    jtopw, jtopi = jax.lax.top_k(jprobs, cfg.top_k)
    assert topi.tolist() == np.asarray(jtopi).tolist()
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0,
                               atol=1e-6)
    srt = torch.sort(probs, -1, descending=True).values
    assert bool((srt[:, 1] == srt[:, 2]).any())        # ties happen
    up = torch.topk(torch.softmax(xb.float() @ rb.float(), -1), 2).indices
    assert not torch.equal(up, topi)


def _capacity_case(trees, factor, masked):
    jlp, tlp = _layer0(trees)
    cfg_t = dataclasses.replace(TCFG, capacity_factor=factor)
    cfg_j = dataclasses.replace(JCFG, capacity_factor=factor)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, TCFG.d_model)).astype(np.float32)
    mask = np.ones((2, 12), np.float32)
    if masked:
        mask[0, 7:] = 0
        mask[1, :3] = 0
    tm = _t(mask) if masked else None
    jm = jnp.asarray(mask) if masked else None
    return (tmx.moe_ffn(cfg_t, _t(x), tlp, token_mask=tm),
            jmx.moe_ffn(cfg_j, jnp.asarray(x), jlp, token_mask=jm))


@pytest.mark.parametrize("factor", [0.25, 1.25, 4.0])
@pytest.mark.parametrize("masked", [False, True])
def test_capacity_dispatch_matches_jax(trees, factor, masked):
    (out, aux), (jout, jaux) = _capacity_case(trees, factor, masked)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=0,
                                   atol=1e-7)


def test_capacity_overflow_drops_assignments(trees):
    """At factor 0.25 some (token, k) rows find their expert full: the
    output differs from the dropless one; at 4.0 none do."""
    jlp, tlp = _layer0(trees)
    (low, _), _ = _capacity_case(trees, 0.25, False)
    (high, _), _ = _capacity_case(trees, 4.0, False)
    x = _t(np.random.default_rng(5).standard_normal(
        (2, 12, TCFG.d_model)).astype(np.float32))
    free = tmx.moe_ffn_dropless(TCFG, x, tlp, impl="dense")
    np.testing.assert_allclose(high.numpy(), free.numpy(), rtol=0, atol=ATOL)
    assert (low - free).abs().max() > 1e-3


def test_aux_losses_count_masked_tokens_as_the_reference(trees):
    """me and ce average over every token, masked ones included (the
    reference's choice, pinned): the mask changes no aux loss."""
    (_, aux_m), (_, jaux_m) = _capacity_case(trees, 1.25, True)
    (_, aux), _ = _capacity_case(trees, 1.25, False)
    assert float(aux_m["load_balance"]) == float(aux["load_balance"])
    np.testing.assert_allclose(float(aux_m["load_balance"]),
                               float(jaux_m["load_balance"]), atol=1e-7)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _grads(cfg_j, cfg_t, trees, toks, tg, mask):
    jp, tp = trees
    jm = None if mask is None else jnp.asarray(mask)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jmx.loss_fn(cfg_j, p, jnp.asarray(toks), jnp.asarray(tg),
                              mask=jm), has_aux=True)(jp)
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    tl, tmet = tmx.loss_fn(cfg_t, tp, _t(toks), _t(tg),
                           mask=None if mask is None else _t(mask))
    tl.backward()
    return (jl, jmet, jg), (tl, tmet, jax.tree.map(lambda t: t.grad, tp))


@pytest.mark.parametrize("chunk", [0, 96])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_every_gradient_match_jax(trees, chunk, masked):
    cfg_j = dataclasses.replace(JCFG, xent_chunk=chunk)
    cfg_t = dataclasses.replace(TCFG, xent_chunk=chunk)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, TCFG.vocab_size, (2, 16)).astype(np.int32)
    tg = rng.integers(0, TCFG.vocab_size, (2, 16)).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones((2, 16), np.float32)
        mask[1, 10:] = 0
    (jl, jmet, jg), (tl, tmet, tg_) = _grads(cfg_j, cfg_t, trees, toks, tg,
                                             mask)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=ATOL)
    for (path, g), t in zip(jax.tree_util.tree_leaves_with_path(jg),
                            jax.tree.leaves(tg_)):
        np.testing.assert_allclose(t.numpy(), np.asarray(g), rtol=0,
                                   atol=ATOL, err_msg=str(path))


def test_remat_gives_the_same_loss_and_gradients(trees):
    cfg_r = dataclasses.replace(TCFG, remat=True)
    rng = np.random.default_rng(7)
    toks = _t(rng.integers(0, TCFG.vocab_size, (2, 16)))
    tg = _t(rng.integers(0, TCFG.vocab_size, (2, 16)))
    out = []
    for cfg in (TCFG, cfg_r):
        tp = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                          trees[1])
        loss, m = tmx.loss_fn(cfg, tp, toks, tg)
        loss.backward()
        out.append((loss.item(), m["aux_load_balance"].item(),
                    [t.grad for t in jax.tree.leaves(tp)]))
    assert out[0][:2] == out[1][:2]
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)


def test_forward_logits_match_jax(trees):
    jp, tp = trees
    toks = np.random.default_rng(8).integers(0, TCFG.vocab_size, (2, 12))
    logits, aux = tmx.forward(TCFG, tp, _t(toks))
    jlogits, jaux = jmx.forward(JCFG, jp, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=ATOL)
    assert logits.dtype == torch.float32 and logits.shape == (2, 12, 256)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_cache_forward_matches_jax(trees):
    """One prefill of forward_with_cache_mixtral against JAX's (dense
    cache, a padded row masked out of routing)."""
    from kuberay_tpu.serve import kv_cache as jkc
    from kuberay_tpu_torch.serve import kv_cache as tkc
    jp, tp = trees
    toks = np.random.default_rng(9).integers(0, 256, (2, 10))
    mask = np.ones((2, 10), np.float32)
    mask[1, 6:] = 0
    jl, _ = jkc.forward_with_cache_mixtral(
        JCFG, jp, jnp.asarray(toks, jnp.int32), jkc.init_kv_cache(JCFG, 2, 16),
        jnp.zeros(2, jnp.int32), token_mask=jnp.asarray(mask))
    tl, _ = forward_with_cache_mixtral(
        TCFG, tp, _t(toks), tkc.init_kv_cache(TCFG, 2, 16, "cpu"),
        torch.zeros(2, dtype=torch.long), token_mask=_t(mask))
    np.testing.assert_allclose(tl.numpy()[mask > 0],
                               np.asarray(jl)[mask > 0], rtol=0, atol=ATOL)
    assert base_forward_for(TCFG) is forward_with_cache_mixtral
    assert base_forward_for(
        __import__("kuberay_tpu_torch.models.llama", fromlist=["x"])
        .CONFIGS["llama_tiny"]) is None


def test_dequant_view_yields_expert_stacks(trees):
    q = quantize_weights(trees[1])
    view = DequantView(q, TCFG.dtype)
    layers = view["layers"]
    assert tuple(layers["w_gate"][1].shape) == (4, 64, 128)
    assert tuple(layers["w_down"][0].shape) == (4, 128, 64)
    assert layers["router"] is q["layers"]["router"]      # not quantised
    assert set(q["layers"]["w_up"]) == {"q8", "s8"}


PREFIX = list(range(40, 56))                  # two blocks of 8


def _prompts():
    rng = np.random.default_rng(10)
    return ([PREFIX + rng.integers(0, 256, n).tolist() for n in (3, 9, 17)]
            + [rng.integers(0, 256, n).tolist() for n in (5, 12, 30)])


SERVE_CASES = {
    "dense": dict(),
    "dense_chunked": dict(prefill_chunk=8),
    "dense_int8_weights": dict(weight_quant="int8"),
    "dense_int8_cache": dict(kv_quant="int8"),
    "dense_speculative": dict(speculative=3),
    "paged": dict(paged=True),
    "paged_chunked": dict(paged=True, prefill_chunk=8),
    "paged_int8_weights": dict(paged=True, weight_quant="int8"),
    "paged_int8_pool": dict(paged=True, kv_quant="int8"),
}


def _serve(pkg, trees, opts, prompts, max_slots=2):
    jp, tp = trees
    opts = dict(opts)
    paged = opts.pop("paged", False)
    kw = dict(max_slots=max_slots, max_len=64, **opts)
    if paged:
        kw["block_size"] = 8
    if pkg == "jax":
        cls = jpe.PagedServeEngine if paged else jeng.ServeEngine
        eng = cls(JCFG, jp, decode_impl="xla", **kw)
        req = jeng.Request
    else:
        cls = PagedServeEngine if paged else teng.ServeEngine
        eng = cls(TCFG, tp, device="cpu", **kw)
        req = teng.Request
    for i, p in enumerate(prompts):
        eng.add_request(req(f"r{i}", list(p), max_new_tokens=6))
    out = {r.request_id: r.tokens for r in eng.run()}
    return out, eng.stats


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_engines_serve_the_jax_engines_tokens(trees, case):
    opts = SERVE_CASES[case]
    ours, st = _serve("torch", trees, opts, _prompts())
    ref, jst = _serve("jax", trees, opts, _prompts())
    assert ours == ref
    assert len(ours) == 6 and all(len(t) == 6 for t in ours.values())
    if opts.get("paged"):
        assert st["prefix_hit_tokens"] == jst["prefix_hit_tokens"] > 0


def test_paged_prefix_hits_give_the_unshared_tokens(trees):
    """Dropless routing makes prefix reuse exact: a repeat served past its
    cached blocks gives the tokens of a cold engine."""
    prompt = PREFIX + [7, 8, 9, 10, 11]
    cold, _ = _serve("torch", trees, {"paged": True}, [prompt])
    warm, st = _serve("torch", trees, {"paged": True}, [prompt, prompt],
                      max_slots=1)
    assert warm["r0"] == warm["r1"] == cold["r0"]
    assert st["prefix_hit_tokens"] == 16
