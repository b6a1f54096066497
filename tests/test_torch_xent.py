"""PyTorch port, chunked cross entropy vs the JAX package's ``ops/xent.py``.

V 256 at chunk 96 is two full chunks and a 64-wide tail.  float32: 1e-5
(the online logsumexp sums in another order); bfloat16 inputs: 2e-2 on
the loss side (f32 math on bf16 operands on both sides) and relative to
the largest gradient on the backward side (dlog is rounded to bf16 before
its two products on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.ops import xent as jx
from kuberay_tpu_torch.ops import xent as tx

torch.set_num_threads(2)

T, D, V, CHUNK = 48, 32, 256, 96


def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D)).astype(np.float32)
    head = (rng.normal(size=(D, V)) / np.sqrt(D)).astype(np.float32)
    tgt = rng.integers(0, V, T).astype(np.int32)
    tgt[:3] = [0, 95, V - 1]          # first column, a chunk edge, the tail
    return ((jnp.asarray(x).astype(dtype), jnp.asarray(head).astype(dtype),
             jnp.asarray(tgt)),
            (torch.tensor(x).to(getattr(torch, dtype)),
             torch.tensor(head).to(getattr(torch, dtype)),
             torch.tensor(tgt)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_xent_matches_jax(dtype):
    """nll, logz, pred and the gradients of a z-loss-weighted sum (so the
    softmax coefficient is g_nll + g_logz)."""
    (jxx, jh, jt), (tx_, th, tt) = _inputs(0, dtype)
    rng = np.random.default_rng(1)
    w_nll = rng.uniform(0.5, 1.5, T).astype(np.float32)
    w_logz = rng.uniform(0.0, 0.2, T).astype(np.float32)

    def jloss(x, h):
        nll, logz, _ = jx.chunked_xent(x, h, jt, CHUNK)
        return jnp.sum(nll * w_nll) + jnp.sum(jnp.square(logz) * w_logz)

    jnll, jlogz, jpred = jx.chunked_xent(jxx, jh, jt, CHUNK)
    jgx, jgh = jax.grad(jloss, argnums=(0, 1))(jxx, jh)
    tx_.requires_grad_()
    th.requires_grad_()
    nll, logz, pred = tx.chunked_xent(tx_, th, tt, CHUNK)
    assert pred.dtype == torch.int32 and not pred.requires_grad
    (torch.sum(nll * torch.from_numpy(w_nll)) +
     torch.sum(torch.square(logz) * torch.from_numpy(w_logz))).backward()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(nll), _np(jnll), rtol=0, atol=tol)
    np.testing.assert_allclose(_np(logz), _np(jlogz), rtol=0, atol=tol)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    for got, want, t in ((tx_.grad, jgx, tx_), (th.grad, jgh, th)):
        assert got.dtype == t.dtype
        w = _np(want)
        np.testing.assert_allclose(_np(got), w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_loss_equals_dense_loss(masked):
    """chunked_softmax_xent_loss (and its gradients) vs the same loss from
    dense f32 logits, and vs the JAX chunked loss."""
    (jxx, jh, jt), (tx_, th, tt) = _inputs(2, "float32")
    mask = (np.arange(T) % 3 != 0).astype(np.float32) if masked else None
    tmask = None if mask is None else torch.from_numpy(mask)
    tx_.requires_grad_()
    th.requires_grad_()
    loss, metrics = tx.chunked_softmax_xent_loss(tx_, th, tt, tmask,
                                                 z_loss=1e-2, chunk=CHUNK)
    gx, gh = torch.autograd.grad(loss, (tx_, th))
    logits = tx_ @ th
    logz = torch.logsumexp(logits, -1)
    nll = logz - logits.gather(1, tt.long()[:, None])[:, 0]
    m = torch.ones(T) if tmask is None else tmask
    dense = ((nll + 1e-2 * logz ** 2) * m).sum() / m.sum()
    dgx, dgh = torch.autograd.grad(dense, (tx_, th))
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(gx), _np(dgx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(gh), _np(dgh), rtol=0, atol=1e-6)
    acc = ((logits.argmax(-1) == tt) * m).sum() / m.sum()
    assert metrics["accuracy"].item() == pytest.approx(acc.item(), abs=1e-7)
    jloss, jmetrics = jx.chunked_softmax_xent_loss(
        jxx, jh, jt, None if mask is None else jnp.asarray(mask),
        z_loss=1e-2, chunk=CHUNK)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-5)
    for k in ("loss", "z_loss", "accuracy"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=0, atol=1e-5)


def test_argmax_ties_take_the_first_index():
    """Equal maxima within a chunk and across chunks: the first index wins,
    as in the JAX package (argmax in a chunk, strict > across chunks)."""
    x = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    head = torch.zeros(2, V)
    head[0, [5, 7]] = 2.0           # row 1: a tie inside chunk 0
    head[1, [100, 200]] = 3.0       # row 2: chunk 1 ties with the tail
    nll, logz, pred = tx.chunked_xent(x, head,
                                      torch.zeros(3, dtype=torch.int32), CHUNK)
    jn, jl, jp = jx.chunked_xent(jnp.asarray(x.numpy()),
                                 jnp.asarray(head.numpy()),
                                 jnp.zeros(3, jnp.int32), CHUNK)
    assert pred.tolist() == [0, 5, 100]      # row 0: all equal
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jp))
