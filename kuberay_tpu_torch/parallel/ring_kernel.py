"""Ring attention with the persistent CUDA ring kernel.

Port of ``kuberay_tpu/parallel/ring_pallas.py`` (``ring_attention_rdma``
and ``_ring_kernel``).  A ``torch.autograd.Function`` over the ranks held
here (q/k/v [R, B, S_local, H, D], from ``parallel/ring.py``):

Forward.  One launch of ``ops/ring_attention.py``'s ``ring_attention_fwd``
a ring, as the TPU kernel is one call a ring.  On a ``LocalRing`` every
rank is held here (R = n) and every block is already on the card in k and
v, so the kernel reads them in place: no exchange, no buffer, no event.
On a ``DeviceRing`` (one rank a process, R = 1) the blocks go around into
an n-slot buffer [n, 2, B, S_local, Hkv, D], block src into slot src
(this rank's own first): a side stream runs the n - 1 rotations (slot
(r - i + 1) % n sent right, slot (r - i) % n received from the left at
rotation i; distinct slots, so no capacity token), and after each
arrival sets that slot's int32 word (``ring_attention.arrive``, a stream
memory write).  The kernel is launched on the current stream right after
the first rotation is queued and reads each block once its word is set.
The buffer holds the whole sequence's K/V of a layer while the forward
runs.  The forward saves (q, k, v, out, lse).

Backward.  The JAX package differentiates the ppermute ring here.  This
runs the ring again with the flash backward kernels per block, from the
global lse and delta = rowsum(dO * O): the block with ``src == my`` goes to
``flash_bwd_dkv`` / ``flash_bwd_dq`` with ``causal=True``, blocks with
``src < my`` with ``causal=False``, blocks with ``src > my`` are skipped.
K/V live in a double buffer [2, R, 2, B, S_local, Hkv, D] (slot, rank, K
or V) whose next slot a side stream fills (``ring.rotate``) while the
current one is read, ordered by CUDA events.  dQ accumulates in f32 here;
dK/dV accumulate in f32 buffers that travel with K/V and are home after
the n-th rotation (the partials of a block belong to its owner).  The
shards must be equal (S divisible by sp), as ``shard_map`` requires.

On CPU tensors every launch takes its plain version and the streams,
events and words are skipped: the same control flow, in order.
"""

from __future__ import annotations

import contextlib

import torch

from kuberay_tpu_torch.ops.attention import (
    attention_delta,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from kuberay_tpu_torch.ops import ring_attention as ra


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
    R, n = q.shape[0], ring.n
    if R == n:                       # every block is here: read in place
        return ra.ring_attention_fwd(q, k, v, ring.ranks[0], n, causal, scale)
    r = ring.ranks[0]
    buf = torch.empty((n, 2) + k.shape[1:], dtype=k.dtype, device=k.device)
    buf[r, 0].copy_(k[0])
    buf[r, 1].copy_(v[0])
    kb, vb = buf[:, 0], buf[:, 1]
    if q.device.type != "cuda":
        for i in range(1, n):
            ring.rotate(buf[(r - i + 1) % n], out=buf[(r - i) % n])
        return ra.ring_attention_fwd(q, kb, vb, r, n, causal, scale)
    words = torch.zeros(n, dtype=torch.int32, device=q.device)
    words[r] = 1
    main = torch.cuda.current_stream(q.device)
    side = torch.cuda.Stream(q.device)
    side.wait_stream(main)                     # buffer and words ready
    buf.record_stream(side)
    words.record_stream(side)
    for i in range(1, n):                      # n >= 2 here
        with torch.cuda.stream(side):
            ring.rotate(buf[(r - i + 1) % n], out=buf[(r - i) % n])
            ra.arrive(words, (r - i) % n)
        if i == 1:
            res = ra.ring_attention_fwd(q, kb, vb, r, n, causal, scale,
                                        words)
    main.wait_stream(side)
    return res


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
