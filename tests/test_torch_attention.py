"""PyTorch port, flash attention vs the JAX package's Pallas kernels.

The plain versions (``flash_fwd_ref``, and ``flash_bwd`` on CPU tensors,
which runs ``flash_bwd_dkv_ref`` and ``flash_bwd_dq_ref``) are the port's
CPU path and the reference its CUDA kernels are held to on the card; here
they are held to ``_flash_fwd`` / ``_flash_bwd`` run in interpret mode with
16-row blocks at S 64 (several blocks, so the kernels' causal block skip
and online softmax are exercised), and ``flash_attention``'s autograd rule
to ``jax.grad`` through the JAX ``flash_attention``.

Tolerances: float32 1e-5 (summation order only); bfloat16 2e-2 (P and dS
are rounded to bf16 at the same places on both sides, but from f32 values
that differ in the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.ops import attention as ja
from kuberay_tpu_torch.ops import attention as ta

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in (
        (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D), (B, Sq, Hq, D))]


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bhsd(x):
    return x.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,causal", [
    (64, 64, 4, 2, True),       # GQA group 2, causal
    (64, 64, 2, 2, True),       # MHA
    (32, 64, 4, 2, True),       # Skv > Sq: bottom-right offset 32
    (64, 64, 4, 1, False),      # not causal, group 4
])
def test_flash_refs_match_pallas_interpret(dtype, Sq, Skv, Hq, Hkv, causal):
    D = 16
    q, k, v, do = _inputs(2, Sq, Skv, Hq, Hkv, D, seed=Sq + Hq * 7 + Hkv)
    jq, jk, jv, jdo = (_bhsd(_jax(a, dtype)) for a in (q, k, v, do))
    scale = 1.0 / np.sqrt(D)
    jo, jlse = ja._flash_fwd(jq, jk, jv, scale, causal, 16, 16, True)
    jdq, jdk, jdv = ja._flash_bwd(jq, jk, jv, jo, jlse, jdo, scale, causal,
                                  16, 16, True)
    tq, tk, tv, tdo = (_torch(a, dtype) for a in (q, k, v, do))
    to, tlse = ta.flash_fwd(tq, tk, tv, causal)
    assert to.dtype == tq.dtype and tlse.dtype == torch.float32
    assert tlse.shape == (2, Hq, Sq)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(to), _np(_bhsd(jo)), rtol=0, atol=tol)
    np.testing.assert_allclose(_np(tlse), _np(jlse)[..., 0], rtol=0,
                               atol=1e-5 if dtype == "float32" else 1e-3)
    # Backward from the same (out, lse), so the comparison is of the
    # backward alone.
    jo_t = _torch(_np(_bhsd(jo)), dtype)
    jlse_t = torch.tensor(_np(jlse)[..., 0])
    got = ta.flash_bwd(tq, tk, tv, jo_t, jlse_t, tdo, causal)
    for g, w, t in zip(got, (jdq, jdk, jdv), (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        w = _np(_bhsd(w))
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_autograd_matches_jax_grad(dtype):
    """forward + torch.autograd grads vs jax.grad through the Pallas
    custom_vjp (interpret mode), with a seeded cotangent."""
    B, S, Hq, Hkv, D = 1, 64, 4, 2, 16
    q, k, v, do = _inputs(B, S, S, Hq, Hkv, D, seed=11)
    jargs = [_jax(a, dtype) for a in (q, k, v)]
    jdo = _jax(do, dtype)

    def jloss(q_, k_, v_):
        out = ja.flash_attention(q_, k_, v_, causal=True,
                                 impl="pallas_interpret")
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(*jargs)
    targs = [_torch(a, dtype).requires_grad_() for a in (q, k, v)]
    tout = ta.flash_attention(*targs, causal=True)
    tout.backward(_torch(do, dtype))
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(tout.detach()), _np(jout), rtol=0,
                               atol=tol)
    for t, j in zip(targs, jgrads):
        w = _np(j)
        np.testing.assert_allclose(_np(t.grad), w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("Sq,Skv", [(40, 40), (24, 40)])
def test_flash_attention_ragged_matches_xla(Sq, Skv):
    """A length no block divides: the JAX package falls back to
    attention_xla there; the port's flash path (masking, no fallback)
    gives the same numbers, and so does its attention_ref."""
    B, Hq, Hkv, D = 2, 4, 2, 16
    q, k, v, do = _inputs(B, Sq, Skv, Hq, Hkv, D, seed=Sq)
    jargs = [jnp.asarray(a) for a in (q, k, v)]

    def jloss(q_, k_, v_):
        return jnp.sum(ja.attention_xla(q_, k_, v_, True) * do)

    jout = ja.attention_xla(*jargs, True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tout = ta.flash_attention(*targs, causal=True)
    tout.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_np(tout.detach()), _np(jout), rtol=0,
                               atol=1e-5)
    for t, j in zip(targs, jgrads):
        np.testing.assert_allclose(_np(t.grad), _np(j), rtol=0, atol=1e-5)
    ref = ta.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), True)
    np.testing.assert_allclose(_np(ref), _np(jout), rtol=0, atol=1e-5)


def test_row_that_sees_nothing_gives_zero():
    """Skv < Sq, causal: the first rows see no key; the kernels' plain
    version gives out 0 and lse -1e30 (the TPU kernel's l == 0 guard)."""
    q, k, v, _ = _inputs(1, 8, 4, 2, 1, 16, seed=3)
    out, lse = ta.flash_fwd_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    assert not out[:, :4].any()
    assert (lse[:, :, :4] == -1e30).all() and (lse[:, :, 4:] > -1e3).all()


def _within_local(got, want, rtol=2 ** -7, row_tol=2 ** -5,
                  floor=2 ** -12, norm_tol=2 ** -7):
    """chip_smoke.py's flash check, with its reasons there: each element
    within one bf16 ulp of its own value plus 2^-5 of its row's RMS plus
    2^-12 of the tensor's, and the whole tensor within 2^-7 in norm."""
    g, r = got.float(), want.float()
    diff = (g - r).abs()
    rms = r.square().mean(-1, keepdim=True).sqrt()
    limit = rtol * r.abs() + row_tol * rms + floor * r.square().mean().sqrt()
    return bool((diff <= limit).all()) and \
        diff.norm().item() <= norm_tol * r.norm().item()


@pytest.mark.gpu
def test_flash_kernels_match_plain_on_card():
    """On the card: the three CUDA kernels vs their plain versions (bf16),
    at a ragged length, an offset (Skv > Sq), D 64, a length the forward's
    128-row q tile does not divide (960), D 64 with group 1 there, rows
    that see no key (Sq > Skv; forward only, as such rows have no
    gradient), no mask, groups 4 and 8, and the ring's past block (B 2,
    shards of 1024, not causal), with their launch counts; a second
    backward on the same inputs is bit for bit the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, Sq, Skv, Hq, Hkv, D, causal in ((2, 1000, 1000, 8, 2, 128, True),
                                           (1, 200, 333, 4, 1, 128, True),
                                           (1, 256, 256, 4, 4, 64, True),
                                           (1, 960, 960, 16, 8, 128, True),
                                           (2, 960, 960, 12, 12, 64, True),
                                           (1, 333, 200, 8, 1, 64, True),
                                           (1, 700, 900, 8, 2, 128, False),
                                           (1, 512, 512, 16, 4, 128, True),
                                           (1, 512, 512, 16, 2, 64, True),
                                           (2, 1024, 1024, 16, 8, 128,
                                            False)):
        q, k, v, do = (torch.randn(*s, generator=g, device="cuda").bfloat16()
                       for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                 (B, Skv, Hkv, D), (B, Sq, Hq, D)))
        n = (ta.fwd_launches, ta.bwd_dkv_launches, ta.bwd_dq_launches)
        out, lse = ta.flash_fwd(q, k, v, causal)
        rout, rlse = ta.flash_fwd_ref(q, k, v, causal)
        assert _within_local(out, rout)
        assert (lse - rlse).abs().max().item() <= 1e-4
        if causal and Sq > Skv:
            assert ta.fwd_launches == n[0] + 1
            continue
        grads = ta.flash_bwd(q, k, v, out, lse, do, causal)
        assert (ta.fwd_launches, ta.bwd_dkv_launches,
                ta.bwd_dq_launches) == tuple(c + 1 for c in n)
        again = ta.flash_bwd(q, k, v, out, lse, do, causal)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
        # The plain backward: flash_bwd on CPU copies of the same inputs.
        want = ta.flash_bwd(*(t.cpu() for t in (q, k, v, out, lse, do)),
                            causal)
        for got, ref in zip(grads, want):
            assert _within_local(got.cpu(), ref)
