"""Ring attention: sequence parallelism over the ``sp`` axis of a mesh.

Port of ``kuberay_tpu/parallel/ring.py``.  The sequence is cut into n equal
shards, one per sp rank; each rank keeps its queries and passes its K/V
block around the ring, merging one block a step into an online softmax
(f32 accumulators, GQA expanded after the exchange, so the wire carries
Hkv-sized blocks).  No rank ever forms the whole sequence's scores.

``impl``:

- ``"ppermute"``, the plain ring: ``_block_attention`` and the merge in
  torch ops, with the exchange a ``torch.autograd.Function`` (``_Rotate``:
  forward sends right and receives left, backward the reverse, as JAX
  transposes ``ppermute``), so autograd differentiates it as JAX does.  Runs
  on any device.
- ``"rdma"``: ``parallel/ring_kernel.py``, the persistent CUDA ring
  kernel (one launch a ring forward; across processes the blocks rotate
  into an n-slot buffer on a side stream while it runs) and a ring
  backward through the flash backward kernels.  On CUDA tensors it launches the kernels or
  raises; it never falls back to the plain ring (the JAX package's VMEM,
  unroll and interpreter fallbacks have no counterpart: the kernel streams
  K/V tiles from device memory).  On CPU tensors every launch takes its
  plain version.

Layout as in the JAX package: q [B, S, Hq, D], k/v [B, S, Hkv, D].  On a
``DeviceMesh`` they are this rank's shard (as inside ``shard_map``); on a
``LocalRing`` they are the whole sequence, cut into shards inside.  The
output has q's layout and dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kuberay_tpu_torch.parallel import ring_kernel
from kuberay_tpu_torch.parallel.mesh import ring_of

_NEG_INF = -1e30


class _Rotate(torch.autograd.Function):
    """The neighbour exchange: every rank's block moves one rank right."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.rotate(x, shift=1)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.rotate(g.contiguous(), shift=-1), None


def _block_attention(q, k, v, scale, q_off, k_off, causal):
    """Partial attention of each rank's q shard against one K/V block.

    q [R, B, Sq, Hq, D], k/v [R, B, Skv, Hkv, D] (R ranks held here);
    q_off/k_off [R] global offsets.  Returns (pv [R, B, Sq, Hq, D] f32,
    m and l [R, B, Sq, Hq, 1]): the unnormalised numerator, block max and
    block sum."""
    group = q.shape[3] // k.shape[3]
    if group > 1:
        k = k.repeat_interleave(group, dim=3)
        v = v.repeat_interleave(group, dim=3)
    s = torch.einsum("rbqhd,rbkhd->rbhqk", q.float(), k.float()) * scale
    if causal:
        rows = q_off[:, None, None] + torch.arange(
            q.shape[2], device=q.device)[None, :, None]
        cols = k_off[:, None, None] + torch.arange(
            k.shape[2], device=q.device)[None, None, :]
        s = torch.where((cols <= rows)[:, None, None], s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                         # [R,B,H,Sq,1]
    # Fully masked rows: exp(-1e30 - -1e30) = 1, zeroed here.
    p = torch.where(m <= _NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("rbhqk,rbkhd->rbqhd", p.to(v.dtype).float(), v.float())
    return pv, m.transpose(2, 3), l.transpose(2, 3)


def _plain_ring(q, k, v, ring, causal, scale):
    """q/k/v [R, B, S_local, H, D] -> [R, B, S_local, Hq, D]."""
    R, B, Sl, Hq, D = q.shape
    n = ring.n
    # The ranks held here are consecutive; arange keeps this capturable in
    # a CUDA graph (no host-to-device copy).
    ranks = torch.arange(R, device=q.device) + ring.ranks[0]
    m = torch.full((R, B, Sl, Hq, 1), _NEG_INF, device=q.device)
    l = torch.zeros((R, B, Sl, Hq, 1), device=q.device)
    acc = torch.zeros((R, B, Sl, Hq, D), device=q.device)
    kk, vv = k, v
    for i in range(n):
        src = (ranks - i) % n                  # whose block each rank holds
        pv, bm, bl = _block_attention(q, kk, vv, scale, ranks * Sl, src * Sl,
                                      causal)
        m_new = torch.maximum(m, bm)
        c_old, c_new = torch.exp(m - m_new), torch.exp(bm - m_new)
        acc = acc * c_old + pv * c_new
        l = l * c_old + bl * c_new
        m = m_new
        if i < n - 1:
            kk = _Rotate.apply(kk, ring)
            vv = _Rotate.apply(vv, ring)
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None,
                   impl: str = "ppermute") -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``axis_name`` (a
    ``LocalRing`` or a ``DeviceMesh``).  Differentiable in q, k and v."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} must be a multiple of kv "
                         f"heads {k.shape[2]}")
    ring = ring_of(mesh, axis_name)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qs, ks, vs = (ring.shard(t) for t in (q, k, v))
    if impl == "ppermute":
        out = _plain_ring(qs, ks, vs, ring, causal, scale)
    elif impl == "rdma":
        out = ring_kernel.ring_attention_rdma(qs, ks, vs, ring, causal, scale)
    else:
        raise ValueError(f"unknown ring impl {impl!r} (ppermute or rdma)")
    return ring.unshard(out)
