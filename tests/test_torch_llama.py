"""PyTorch port, model: parameter tree, conversion and the cached forward
vs the JAX package, on one parameter tree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.serve import kv_cache as jkv
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.serve import kv_cache as tkv

torch.set_num_threads(2)

JCFG = jllama.CONFIGS["llama_tiny"]
TCFG = tllama.CONFIGS["llama_tiny"]
# float32 end to end; the two packages sum in different orders.
ATOL = 1e-4


@pytest.fixture(scope="module")
def trees():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_jax(TCFG, jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_configs_mirror_jax():
    assert set(tllama.CONFIGS) == set(jllama.CONFIGS)
    for name, jc in jllama.CONFIGS.items():
        tc = tllama.CONFIGS[name]
        for f in dataclasses.fields(jc):
            if f.name == "dtype":
                assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
            else:
                assert getattr(tc, f.name) == getattr(jc, f.name), (name, f)
        assert tc.num_params() == jc.num_params()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    jc = dataclasses.replace(JCFG, dtype=getattr(jnp, dtype))
    tc = dataclasses.replace(TCFG, dtype=getattr(torch, dtype))
    jp = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.PRNGKey(3)))
    tp = params_from_jax(tc, jp, "cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for name, a in jl.items():
        t = tl[name]
        assert t.dtype == getattr(torch, dtype), name
        assert tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("name", ["llama_tiny", "llama3_8b"])
def test_init_params_tree_matches_jax(name):
    """Same tree, shapes and dtypes; the 8B tree is built on the meta
    device (shapes only) on the JAX side through eval_shape."""
    jc, tc = jllama.CONFIGS[name], tllama.CONFIGS[name]
    want = jax.eval_shape(lambda: jllama.init_params(jc, jax.random.PRNGKey(0)))
    device = "cpu" if name == "llama_tiny" else "meta"
    got = tllama.init_params(tc, torch.Generator().manual_seed(0)
                             if device == "cpu" else None, device)
    wl, gl = dict(_leaves(want)), dict(_leaves(got))
    assert wl.keys() == gl.keys()
    for k, w in wl.items():
        assert tuple(gl[k].shape) == w.shape, k
        assert str(gl[k].dtype).split(".")[-1] == jnp.dtype(w.dtype).name, k
    if device == "cpu":
        # Scaled-normal init: norms are ones, projections have the
        # reference's scales (1/sqrt(d), out-projections / sqrt(2L)).
        std = 1 / np.sqrt(tc.d_model)
        assert torch.all(got["final_norm"] == 1)
        assert abs(got["embed"].std().item() - std) < 0.1 * std
        out_std = std / np.sqrt(2 * tc.n_layers)
        assert abs(got["layers"]["wo"].std().item() - out_std) < 0.1 * out_std


def test_forward_with_cache_prefill_then_decode_matches_jax(trees):
    """Prefill logits vs the JAX full forward, then 8 decode steps vs the
    JAX cached forward, logits and cache contents, two slots."""
    jp, tp = trees
    B, P, steps, M = 2, 8, 8, 32
    toks = np.random.default_rng(0).integers(0, JCFG.vocab_size, (B, P + steps))
    full = np.asarray(jllama.forward(JCFG, jp, jnp.asarray(toks)))

    tcache = tkv.init_kv_cache(TCFG, B, M, "cpu")
    logits, _ = tkv.forward_with_cache(
        TCFG, tp, torch.from_numpy(toks[:, :P]), tcache,
        torch.zeros(B, dtype=torch.long))
    assert logits.dtype == torch.float32 and logits.shape == (B, P, 256)
    np.testing.assert_allclose(logits.numpy(), full[:, :P], rtol=0, atol=ATOL)

    jfwd = jax.jit(lambda *a: jkv.forward_with_cache(JCFG, *a))
    jcache = jkv.init_kv_cache(JCFG, B, M)
    _, jcache = jfwd(jp, jnp.asarray(toks[:, :P]), jcache,
                     jnp.zeros(B, jnp.int32))
    for t in range(P, P + steps):
        start = np.full(B, t, np.int32)
        jl, jcache = jfwd(
            jp, jnp.asarray(toks[:, t:t + 1]), jcache,
            jnp.asarray(start))
        tl, _ = tkv.forward_with_cache(
            TCFG, tp, torch.from_numpy(toks[:, t:t + 1]), tcache,
            torch.from_numpy(start))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, t], rtol=0,
                                   atol=ATOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=0, atol=1e-5)


def test_write_mask_and_logits_index(trees):
    """A write-masked row leaves its cache untouched, as in JAX; with
    logits_index only the named positions' logits are computed."""
    jp, tp = trees
    toks = np.random.default_rng(1).integers(0, JCFG.vocab_size, (2, 6))
    mask = np.array([1.0, 0.0], np.float32)
    jl, jcache = jkv.forward_with_cache(
        JCFG, jp, jnp.asarray(toks), jkv.init_kv_cache(JCFG, 2, 16),
        jnp.zeros(2, jnp.int32), jnp.asarray(mask))
    tcache = tkv.init_kv_cache(TCFG, 2, 16, "cpu")
    tl, _ = tkv.forward_with_cache(
        TCFG, tp, torch.from_numpy(toks), tcache, torch.zeros(2),
        torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert not tcache["k"][:, 1].any() and not tcache["v"][:, 1].any()
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=1e-5)

    idx = torch.tensor([5, 2])
    last, _ = tkv.forward_with_cache(
        TCFG, tp, torch.from_numpy(toks), tkv.init_kv_cache(TCFG, 2, 16, "cpu"),
        torch.zeros(2), logits_index=idx)
    assert last.shape == (2, 1, 256)
    full = np.asarray(jllama.forward(JCFG, jp, jnp.asarray(toks)))
    np.testing.assert_allclose(last[:, 0].numpy(), full[[0, 1], [5, 2]],
                               rtol=0, atol=ATOL)
