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

import ctypes
import math
import threading
from typing import Optional

import torch

# Kernel launches on CUDA tensors, for run-time checks.
launches = 0

_NEG_INF = -1e30
_lock = threading.Lock()
_fn = None


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


def _get_fn():
    global _fn
    with _lock:
        if _fn is None:
            from kuberay_tpu_torch.ops._build import load_library
            fn = load_library("ring_attention").ring_attention_step_bf16
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


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


def ring_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                        q_off: int, k_off: int, causal: bool = True,
                        scale: Optional[float] = None, last: bool = False,
                        out: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None) -> None:
    """Merge one K/V block into (acc, m, l), or with ``last`` into out and
    lse.  CPU tensors take ``ring_attention_step_ref``; CUDA tensors launch
    the kernel or raise."""
    global launches
    if q.device.type == "cpu":
        return ring_attention_step_ref(q, k, v, acc, m, l, q_off, k_off,
                                       causal, scale, last, out, lse)
    B, Sq, Skv, Hq, Hkv, D = _check(q, k, v, acc, m, l, last, out, lse)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    err = _get_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), out.data_ptr() if last else None,
        lse.data_ptr() if last else None, B, Sq, Skv, Hq, Hkv, D,
        int(q_off), int(k_off), int(causal), int(last), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_attention_step kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
