"""Ring attention with the CUDA step kernel, the exchange overlapped.

Port of ``kuberay_tpu/parallel/ring_pallas.py`` (``ring_attention_rdma``
and ``_ring_kernel``).  A ``torch.autograd.Function`` over the ranks held
here (q/k/v [R, B, S_local, H, D], from ``parallel/ring.py``):

Forward.  K/V live in a double buffer [2, R, 2, B, S_local, Hkv, D] (slot,
rank, K or V).  At step i a side stream sends slot ``i % 2`` one rank right
and receives into slot ``(i + 1) % 2`` (``ring.rotate``:
``dist.batch_isend_irecv`` on a
``DeviceMesh``, a copy of the rolled shards on a ``LocalRing``), while the
step kernel (``ops/ring_attention.py``'s ``RingSteps``: the buffers checked
once a ring, not once a launch) merges slot ``i % 2`` into the f32 state
on the current stream.  CUDA events take the place of the TPU
kernel's DMA semaphores and capacity token: before the side stream
overwrites a slot it waits on the compute event of the step that last read
it, and the current stream waits on the arrival event before step i + 1.
Blocks that lie wholly in a rank's causal future are skipped, and the
state is normalised into (out, lse) at the last step whose block the rank
sees.  The forward saves (q, k, v, out, lse).

Backward.  The JAX package differentiates the ppermute ring here.  This
runs the ring again with the flash backward kernels per block, from the
global lse and delta = rowsum(dO * O): the block with ``src == my`` goes to
``flash_bwd_dkv`` / ``flash_bwd_dq`` with ``causal=True``, blocks with
``src < my`` with ``causal=False``, blocks with ``src > my`` are skipped.
dQ accumulates in f32 here; dK/dV accumulate in f32 buffers that travel
with K/V and are home after the n-th rotation (the partials of a block
belong to its owner).  The shards must be equal (S divisible by sp), as
``shard_map`` requires.

On CPU tensors every launch takes its plain version and the streams and
events are skipped: the same control flow, in order.
"""

from __future__ import annotations

import contextlib

import torch

from kuberay_tpu_torch.ops.attention import (
    attention_delta,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from kuberay_tpu_torch.ops.ring_attention import RingSteps

_NEG_INF = -1e30


class _Overlap:
    """A side stream for the exchange, ordered against the current stream
    by events.  On the CPU every call runs in program order."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.computed = None
        if self.cuda:
            self.main = torch.cuda.current_stream(device)
            self.side = torch.cuda.Stream(device)
            self.side.wait_stream(self.main)        # inputs and buffers ready

    def exchange(self, *bufs: torch.Tensor):
        """Context for exchange work: on the side stream, after the last
        recorded compute event."""
        if not self.cuda:
            return contextlib.nullcontext()
        for b in bufs:
            b.record_stream(self.side)
        if self.computed is not None:
            self.side.wait_event(self.computed)
        return torch.cuda.stream(self.side)

    def record_compute(self) -> None:
        """Mark the end of a step's launches on the current stream."""
        if self.cuda:
            self.computed = torch.cuda.Event()
            self.computed.record(self.main)

    def wait_arrival(self) -> None:
        """The current stream waits for the exchange issued so far."""
        if self.cuda:
            arrived = torch.cuda.Event()
            arrived.record(self.side)
            self.main.wait_event(arrived)


def _sees(causal: bool, src: int, rank: int) -> bool:
    return not causal or src <= rank


def _double_buffer(k, v):
    """[2, R, 2, B, S_local, Hkv, D] with slot 0 holding (k, v)."""
    kv = torch.empty((2, k.shape[0], 2) + k.shape[1:], dtype=k.dtype,
                     device=k.device)
    kv[0, :, 0].copy_(k)
    kv[0, :, 1].copy_(v)
    return kv


def _forward(q, k, v, ring, causal, scale):
    R, B, Sl, Hq, D = q.shape
    n = ring.n
    f32 = dict(dtype=torch.float32, device=q.device)
    kv = _double_buffer(k, v)
    acc = torch.zeros(q.shape, **f32)
    m = torch.full((R, B, Hq, Sl), _NEG_INF, **f32)
    l = torch.zeros((R, B, Hq, Sl), **f32)
    out = torch.empty_like(q)
    lse = torch.empty((R, B, Hq, Sl), **f32)
    steps = RingSteps(q, kv, acc, m, l, out, lse, causal, scale)
    ov = _Overlap(q.device)
    for i in range(n):
        slot, nxt = i % 2, (i + 1) % 2
        if i < n - 1:
            with ov.exchange(kv):
                ring.rotate(kv[slot], out=kv[nxt])
        for j, r in enumerate(ring.ranks):
            src = (r - i) % n
            if not _sees(causal, src, r):
                continue
            # The last step whose block this rank sees: every later one
            # lies in its causal future.
            last = i == (r if causal else n - 1)
            steps.step(slot, j, r * Sl, src * Sl, last)
        ov.record_compute()
        if i < n - 1:
            ov.wait_arrival()
    return out, lse


def _backward(q, k, v, out, lse, do, ring, causal, scale):
    n = ring.n
    kv = _double_buffer(k, v)
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=k.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    delta = [attention_delta(out[j], do[j]) for j in range(len(ring.ranks))]
    ov = _Overlap(q.device)
    for i in range(n):
        slot, nxt = i % 2, (i + 1) % 2
        if i < n - 1:
            with ov.exchange(kv):              # the next K/V, overlapped
                ring.rotate(kv[slot], out=kv[nxt])
        for j, r in enumerate(ring.ranks):
            src = (r - i) % n
            if not _sees(causal, src, r):
                continue
            blk_causal = causal and src == r
            kb, vb = kv[slot, j, 0], kv[slot, j, 1]
            dk, dv = flash_bwd_dkv(q[j], kb, vb, do[j], lse[j], delta[j],
                                   blk_causal, scale)
            dkv[slot, j, 0] += dk
            dkv[slot, j, 1] += dv
            dq[j] += flash_bwd_dq(q[j], kb, vb, do[j], lse[j], delta[j],
                                  blk_causal, scale)
        ov.record_compute()
        # dK/dV travel with their block once this step's partials are in.
        with ov.exchange(dkv):
            ring.rotate(dkv[slot], out=dkv[nxt])
        ov.wait_arrival()
    home = dkv[n % 2]
    return dq.to(q.dtype), home[:, 0].to(k.dtype), home[:, 1].to(v.dtype)


class _RingKernel(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale):
        out, lse = _forward(q, k, v, ring, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, do.contiguous(), ctx.ring,
                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def ring_attention_rdma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        ring, causal: bool, scale: float) -> torch.Tensor:
    """q [R, B, S_local, Hq, D], k/v [R, B, S_local, Hkv, D] (R ranks of
    ``ring`` held here) -> out like q.  Differentiable in q, k and v."""
    return _RingKernel.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                             ring, causal, scale)
