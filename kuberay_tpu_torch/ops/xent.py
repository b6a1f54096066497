"""Chunked softmax cross entropy: the loss without the [T, V] logits.

Port of ``kuberay_tpu/ops/xent.py``.  The forward keeps an online
logsumexp over vocab chunks (one running (m, l) pair per token), the
target's logit and a running argmax; the backward (a
``torch.autograd.Function``) recomputes each chunk's logits from the saved
(x, head) and contracts them at once into dx and dhead.  A vocab the chunk
does not divide gets one tail chunk of the remainder (Llama-3's 128256 at
chunk 16384 is 7 full chunks and a 13568-wide tail).

Plain torch: the JAX package has no Pallas kernel here.  The products take
the working dtype's operands with f32 output (on the card
``torch.mm(..., out_dtype=torch.float32)``; on the CPU through f32, which
holds every bf16 product exactly), as ``preferred_element_type=f32`` does.

Over a vocabulary split over tp (``layout``: ``parallel/spmd.py``), each
rank runs the chunks of its own columns; the forward then reduces the
running max, the sum of exponentials and the target logit over tp and
takes the argmax across ranks, so every tp rank holds the whole
vocabulary's (nll, logz, pred).  The backward is each rank's own columns'
(dhead, and its share of dx, which the caller sums over tp).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from kuberay_tpu_torch.parallel.spmd import global_argmax

_NEG = -1e30


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[m, k] @ [k, n] with the operands' dtype and an f32 result."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _LogitsF32(torch.autograd.Function):
    """``dot_f32`` with a gradient: the f32 cotangent is rounded to the
    working dtype before its two products, as the chunked backward rounds
    ``dlog`` (``xent.py:111`` in the JAX package)."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        return dot_f32(x, head)

    @staticmethod
    def backward(ctx, g):
        x, head = ctx.saved_tensors
        g = g.to(x.dtype)
        return (dot_f32(g, head.t()).to(x.dtype),
                dot_f32(x.t(), g).to(head.dtype))


def logits_f32(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Dense f32 logits [T, V] from x [T, d] and head [d, V]."""
    return _LogitsF32.apply(x, head)


def _chunks(V: int, chunk: int):
    C = min(chunk, V)
    nc, tail = V // C, V % C
    bounds = [(i * C, C) for i in range(nc)]
    if tail:
        bounds.append((nc * C, tail))
    return bounds


class _ChunkedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, head, targets, chunk, layout):
        T = x.shape[0]
        v0 = 0 if layout is None else layout.index("tp") * head.shape[1]
        f32 = dict(dtype=torch.float32, device=x.device)
        m = torch.full((T,), _NEG, **f32)
        l = torch.zeros(T, **f32)
        tl = torch.zeros(T, **f32)
        bv = torch.full((T,), _NEG, **f32)
        bi = torch.zeros(T, dtype=torch.long, device=x.device)
        tgt = targets.long()
        for c0, n in _chunks(head.shape[1], chunk):
            logits = dot_f32(x, head[:, c0:c0 + n])               # [T, n]
            cv, ca = logits.max(dim=-1)
            m_new = torch.maximum(m, cv)
            l = l * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(-1)
            m = m_new
            idx = tgt - v0 - c0
            inside = (idx >= 0) & (idx < n)
            tl = tl + torch.where(
                inside, logits.gather(1, idx.clamp(0, n - 1)[:, None])[:, 0],
                0.0)
            take = cv > bv                        # ties keep the first index
            bv = torch.where(take, cv, bv)
            bi = torch.where(take, ca + c0, bi)
        if layout is not None:
            m_all = layout.all_reduce(m.clone(), ("tp",),
                                      op=dist.ReduceOp.MAX)
            l = layout.all_reduce(l * torch.exp(m - m_all), ("tp",))
            tl = layout.all_reduce(tl, ("tp",))
            bi = global_argmax(bv, bi + v0, layout)
            m = m_all
        logz = m + torch.log(l)
        ctx.save_for_backward(x, head, targets, logz)
        ctx.chunk, ctx.v0 = chunk, v0
        pred = bi.to(torch.int32)
        ctx.mark_non_differentiable(pred)
        return logz - tl, logz, pred

    @staticmethod
    def backward(ctx, g_nll, g_logz, _g_pred):
        x, head, targets, logz = ctx.saved_tensors
        # d(nll)/dlogits = softmax - onehot; d(logz)/dlogits = softmax.
        gp = (g_nll + g_logz).float()
        g_nll = g_nll.float()
        tgt = targets.long()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dhead = torch.empty_like(head)
        for c0, n in _chunks(head.shape[1], ctx.chunk):
            hc = head[:, c0:c0 + n]
            p = torch.exp(dot_f32(x, hc) - logz[:, None])
            dlog = gp[:, None] * p
            idx = tgt - ctx.v0 - c0
            inside = (idx >= 0) & (idx < n)
            dlog.scatter_add_(1, idx.clamp(0, n - 1)[:, None],
                              -torch.where(inside, g_nll, 0.0)[:, None])
            dlog = dlog.to(x.dtype)               # working-dtype operands
            dx += dot_f32(dlog, hc.t())
            dhead[:, c0:c0 + n] = dot_f32(x.t(), dlog).to(head.dtype)
        return dx.to(x.dtype), dhead, None, None, None


def chunked_xent(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                 chunk: int = 8192, layout=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [T, d] hidden states; head: [d, V] (with ``layout``, this tp
    rank's [d, V / tp] columns); targets: [T] integer (global ids).
    Returns (nll [T], logz [T], pred [T] int32); pred is the argmax and
    carries no gradient."""
    return _ChunkedXent.apply(x, head, targets, chunk, layout)


def chunked_softmax_xent_loss(x: torch.Tensor, head: torch.Tensor,
                              targets: torch.Tensor,
                              mask: Optional[torch.Tensor] = None,
                              z_loss: float = 1e-4, chunk: int = 8192
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Hidden states + head -> masked mean loss (with z-loss) and metrics,
    without a [T, V] intermediate."""
    T = x.shape[0]
    nll, logz, pred = chunked_xent(x, head, targets, chunk)
    zl = z_loss * torch.square(logz)
    if mask is None:
        mask = torch.ones(T, dtype=torch.float32, device=x.device)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = ((nll + zl) * mask).sum() / denom
    metrics = {
        "loss": (nll * mask).sum() / denom,
        "z_loss": (zl * mask).sum() / denom,
        "accuracy": ((pred == targets) * mask).sum() / denom,
    }
    return loss, metrics
