"""One step of sequence-parallel ring attention: a CUDA kernel and its plain
version.

Replaces the compute of ``kuberay_tpu/parallel/ring_pallas.py``'s
``_ring_kernel`` (one ring step's block attention and online merge, and the
final normalisation) with the hand-written kernel in
``csrc/ring_attention.cu``, built by ``ops/_build.py`` and called through
ctypes.  Bound on an H100: operations, nearly balanced with the f32 state's
bytes (the source's header note gives the numbers and the design).  The
ring around it, with the exchange, is ``parallel/ring_kernel.py``.

Layout: q [B, Sq, Hq, D], one K/V block [B, Skv, Hkv, D] (GQA when Hq >
Hkv), global positions ``q_off + i`` and ``k_off + j``; the f32 state is
acc [B, Sq, Hq, D] and the running max and sum m, l [B, Hq, Sq], updated
in place.  With ``last`` the merged state is normalised into ``out`` (q's
dtype) and ``lse`` ([B, Hq, Sq] f32) instead, and the state is left as it
was.  ``ring_attention_step`` takes ``ring_attention_step_ref`` for CPU
tensors only; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kuberay_tpu_torch.ops._build import FLOAT, INT, PTR, bind

# Kernel launches on CUDA tensors, for run-time checks.
launches = 0

_NEG_INF = -1e30

# The C entry points of csrc/<LIBRARY>.cu and their ctypes argtypes: the
# step (q, k, v, acc, m, l, out, lse; B, Sq, Skv, Hq, Hkv, D, q_off, k_off,
# causal, last; the scale and the stream), and the kernel's shared memory
# a block at head dim D as the runtime holds it after a launch
# (tests/test_torch_abi.py holds them to the C signatures).
LIBRARY = "ring_attention"
ARGTYPES = {"ring_attention_step_bf16": [PTR] * 8 + [INT] * 10
            + [FLOAT, PTR],
            "ring_attention_step_smem_bytes": [INT]}
_fn = bind(LIBRARY, ARGTYPES)


def ring_attention_step_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            acc: torch.Tensor, m: torch.Tensor,
                            l: torch.Tensor, q_off: int, k_off: int,
                            causal: bool = True, scale: Optional[float] = None,
                            last: bool = False,
                            out: Optional[torch.Tensor] = None,
                            lse: Optional[torch.Tensor] = None) -> None:
    """Plain version: ``_block_attention`` (f32 scores, causal mask on
    global positions, block max, p zeroed where the max is at or below
    -1e30/2, p rounded to v's dtype before P @ V) and the online merge of
    ``parallel/ring.py`` in the JAX package, on the same arguments as the
    kernel."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    group = Hq // Hkv
    kk = k.repeat_interleave(group, dim=2) if group > 1 else k
    vv = v.repeat_interleave(group, dim=2) if group > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    if causal:
        rows = q_off + torch.arange(Sq, device=q.device)[:, None]
        cols = k_off + torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, _NEG_INF)
    bm = s.amax(dim=-1)                                      # [B, Hq, Sq]
    p = torch.exp(s - bm[..., None])
    p = torch.where(bm[..., None] <= _NEG_INF / 2, 0.0, p)
    bl = p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(vv.dtype).float(), vv.float())
    m_new = torch.maximum(m, bm)
    c_old, c_new = torch.exp(m - m_new), torch.exp(bm - m_new)
    acc_new = (acc * c_old.transpose(1, 2)[..., None]
               + pv * c_new.transpose(1, 2)[..., None])
    l_new = l * c_old + bl * c_new
    if not last:
        acc.copy_(acc_new)
        m.copy_(m_new)
        l.copy_(l_new)
        return
    l_new = torch.where(l_new == 0.0, 1.0, l_new)
    out.copy_(acc_new / l_new.transpose(1, 2)[..., None])
    lse.copy_(m_new + torch.log(l_new))


def _check(q, k, v, acc, m, l, last, out, lse):
    """Device, shape, dtype, layout and alignment checks for a launch."""
    name = "ring_attention_step"
    if last and (out is None or lse is None):
        raise ValueError(f"{name}: last=True needs out and lse")
    tensors = [q, k, v, acc, m, l] + ([out, lse] if last else [])
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv != 0:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if D not in (64, 128) or Hq // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"{name}: no kernel for head_dim {D}, group "
                         f"{Hq // Hkv} (64/128; 1, 2, 4, 8)")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{name}: q/k/v must be bfloat16")
    rows = (B, Hq, Sq)
    if acc.shape != q.shape or m.shape != rows or l.shape != rows or any(
            t.dtype != torch.float32 for t in (acc, m, l)):
        raise ValueError(f"{name}: acc must be [B, Sq, Hq, D] and m, l "
                         f"[B, Hq, Sq], all float32")
    if last and (out.shape != q.shape or out.dtype != q.dtype
                 or lse.shape != rows or lse.dtype != torch.float32):
        raise ValueError(f"{name}: out must match q and lse be [B, Hq, Sq] "
                         f"float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return B, Sq, Skv, Hq, Hkv, D


def _launch(ptrs, dims, q_off, k_off, causal, last, scale, stream) -> None:
    """One launch of the step kernel: ``ptrs`` q, k, v, acc, m, l, out, lse
    (out and lse None unless ``last``), ``dims`` B, Sq, Skv, Hq, Hkv, D."""
    global launches
    err = _fn("ring_attention_step_bf16")(
        *ptrs, *dims, int(q_off), int(k_off), int(causal), int(last), scale,
        stream)
    if err != 0:
        raise RuntimeError(f"ring_attention_step kernel launch failed: "
                           f"cudaError {err}")
    launches += 1


def ring_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                        q_off: int, k_off: int, causal: bool = True,
                        scale: Optional[float] = None, last: bool = False,
                        out: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None) -> None:
    """Merge one K/V block into (acc, m, l), or with ``last`` into out and
    lse.  CPU tensors take ``ring_attention_step_ref``; CUDA tensors launch
    the kernel or raise."""
    if q.device.type == "cpu":
        return ring_attention_step_ref(q, k, v, acc, m, l, q_off, k_off,
                                       causal, scale, last, out, lse)
    dims = _check(q, k, v, acc, m, l, last, out, lse)
    scale = scale if scale is not None else 1.0 / math.sqrt(dims[-1])
    ptrs = [t.data_ptr() for t in (q, k, v, acc, m, l)] + (
        [out.data_ptr(), lse.data_ptr()] if last else [None, None])
    _launch(ptrs, dims, q_off, k_off, causal, last, scale,
            torch.cuda.current_stream(q.device).cuda_stream)


class RingSteps:
    """``ring_attention_step`` over one ring's stacked buffers, checked
    once: q, out [R, B, Sl, Hq, D]; kv [2, R, 2, B, Sl, Hkv, D], the
    exchange's double buffer (slot, rank, K or V); acc like q in float32;
    m, l, lse [R, B, Hq, Sl] float32.  ``step(slot, j, q_off, k_off,
    last)`` merges ``kv[slot, j]`` into rank j's state.

    A ring forward makes up to n^2 launches, each a few tens of
    microseconds on the card, so the per-call checks, views and stream
    lookup would set its pace: they are done here once, and a step
    launches from the pointers worked out here, on the stream that was
    current at construction.  On CPU tensors a step is
    ``ring_attention_step`` on rank j's views (its plain version)."""

    def __init__(self, q, kv, acc, m, l, out, lse, causal: bool,
                 scale: Optional[float]):
        self.bufs = (q, kv, acc, m, l, out, lse)
        self.causal = causal
        self.scale = scale if scale is not None else 1.0 / math.sqrt(
            q.shape[-1])
        self.cpu = q.device.type == "cpu"
        R = q.shape[0]
        if kv.dim() != 7 or kv.shape[:3] != (2, R, 2) or any(
                t.shape[0] != R for t in (acc, m, l, out, lse)):
            raise ValueError(f"ring_attention_step: stacked buffers q "
                             f"{tuple(q.shape)}, kv {tuple(kv.shape)}")
        if not all(t.is_contiguous() for t in self.bufs):
            raise ValueError("ring_attention_step: buffers must be "
                             "contiguous")
        # Rank j's view of a stacked buffer starts j strides past its base
        # (q, acc, m, l, out, lse), K and V of kv[slot, j] likewise.
        rank = [(t.data_ptr(), t.stride(0) * t.element_size())
                for t in (q, acc, m, l, out, lse)]
        self.rank_ptrs = [[p + j * s for p, s in rank] for j in range(R)]
        p, (s0, s1, s2) = kv.data_ptr(), [
            s * kv.element_size() for s in kv.stride()[:3]]
        self.kv_ptrs = [[(p + s * s0 + j * s1, p + s * s0 + j * s1 + s2)
                         for j in range(R)] for s in range(2)]
        if self.cpu:
            return
        # Every rank's views share rank 0's shapes.
        self.dims = _check(q[0], kv[0, 0, 0], kv[0, 0, 1], acc[0], m[0],
                           l[0], True, out[0], lse[0])
        if any(a % 16 for row in self.rank_ptrs + sum(self.kv_ptrs, [])
               for a in row):
            raise ValueError("ring_attention_step: inputs must be 16-byte "
                             "aligned")
        self.stream = torch.cuda.current_stream(q.device).cuda_stream

    def step(self, slot: int, j: int, q_off: int, k_off: int,
             last: bool) -> None:
        if self.cpu:
            q, kv, acc, m, l, out, lse = self.bufs
            return ring_attention_step(
                q[j], kv[slot, j, 0], kv[slot, j, 1], acc[j], m[j], l[j],
                q_off, k_off, self.causal, self.scale, last, out[j], lse[j])
        qp, accp, mp, lp, outp, lsep = self.rank_ptrs[j]
        ptrs = (qp, *self.kv_ptrs[slot][j], accp, mp, lp,
                *((outp, lsep) if last else (None, None)))
        _launch(ptrs, self.dims, q_off, k_off, self.causal, last,
                self.scale, self.stream)
