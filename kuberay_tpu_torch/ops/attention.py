"""Flash attention for training: three CUDA kernels behind one autograd rule.

Replaces ``kuberay_tpu/ops/attention.py``'s Pallas kernels: ``_fwd_kernel``
(via ``_flash_fwd``), ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` (via
``_flash_bwd``), with the hand-written kernels in
``csrc/flash_attention.cu``, built by ``ops/_build.py`` and called through
ctypes.  Bound on an H100: operations (the source's header note gives the
numbers and the design).

Public layout as in the JAX package: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]
(GQA when Hq > Hkv), causal alignment bottom-right (query row r sees keys
<= r + Skv - Sq).  ``flash_attention`` is a ``torch.autograd.Function``:
its forward launches the forward kernel and saves (q, k, v, out, lse); its
backward forms delta = rowsum(dO * O) in f32, then launches the dK/dV
kernel, then the dQ kernel.  Each kernel's wrapper (``flash_fwd``,
``flash_bwd_dkv``, ``flash_bwd_dq``) takes its plain version (the same
name with ``_ref``) for CPU tensors only; on a CUDA tensor it launches its
kernel or raises.

``attention_ref`` mirrors ``attention_xla``, the reference the model uses
with ``attn_impl="xla"``; it differs from the flash functions only for a
row that sees no key (the XLA path averages V over every key, the kernels
give 0 with lse -1e30), which causal attention with Skv >= Sq never has.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

# Kernel launches on CUDA tensors, for run-time checks.
fwd_launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0

_NEG_INF = -1e30
_lock = threading.Lock()
_fns = {}


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention, as ``attention_xla``: f32 scores from the working
    dtype, softmax, probabilities rounded to v's dtype, f32 P @ V."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    group = Hq // Hkv
    kk = k.repeat_interleave(group, dim=2) if group > 1 else k
    vv = v.repeat_interleave(group, dim=2) if group > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(Sq, Skv, q.device), _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(vv.dtype).float(), vv.float())
    return out.to(q.dtype)


def _causal_mask(Sq: int, Skv: int, device) -> torch.Tensor:
    rows = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    return torch.arange(Skv, device=device)[None, :] <= rows      # [Sq, Skv]


def _scores(q, k, causal, scale):
    """f32 scores [B, Hkv, G, Sq, Skv] and the visibility mask."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqngd,bknd->bngqk", qg, k.float()) * scale
    if causal:
        vis = _causal_mask(Sq, Skv, q.device)
    else:
        vis = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    return s, vis


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out [B, Sq, Hq, D] in q's
    dtype, lse [B, Hq, Sq] f32).  A row that sees no key gives out 0 and
    lse -1e30."""
    B, Sq, Hq, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s, vis = _scores(q, k, causal, scale)
    s = s.masked_fill(~vis, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~vis, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bngqk,bknd->bqngd", p.to(v.dtype).float(), v.float())
    out = out.reshape(B, Sq, Hq, D) / l.reshape(B, Hq, Sq).transpose(
        1, 2)[..., None]
    lse = (m + torch.log(l)).reshape(B, Hq, Sq)
    return out.to(q.dtype), lse


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [B, Hq, Sq] (the backward kernels'
    per-row term, formed outside them as in the JAX package)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _p_ds(q, k, v, do, lse, delta, causal, scale):
    """P recomputed from lse, and dS = P * (dP - delta) * scale, both f32
    [B, Hkv, G, Sq, Skv] (0 where a key is not visible)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s, vis = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq)[..., None])
    p = p.masked_fill(~vis, 0.0)
    dp = torch.einsum("bqngd,bknd->bngqk",
                      do.float().reshape(B, Sq, Hkv, G, D), v.float())
    ds = p * (dp - delta.reshape(B, Hkv, G, Sq)[..., None]) * scale
    return p, ds


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool = True,
                      scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: dV = P^T dO and dK = dS^T Q, P
    and dS rounded to the working dtype, f32 sums over the q rows and the
    kv head's group; (dk, dv) in k's and v's dtypes."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bngqk,bqngd->bknd", p.to(do.dtype).float(),
                      do.float().reshape(B, Sq, Hkv, G, D))
    dk = torch.einsum("bngqk,bqngd->bknd", ds.to(q.dtype).float(),
                      q.float().reshape(B, Sq, Hkv, G, D))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool = True,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the dQ kernel: dQ = dS K, dS rounded to the working
    dtype, f32 sums; in q's dtype."""
    B, Sq, Hq, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bngqk,bknd->bqngd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(B, Sq, Hq, D).to(q.dtype)


def _get_fn(name: str, n_ptrs: int):
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            from kuberay_tpu_torch.ops._build import load_library
            fn = getattr(load_library("flash_attention"), name)
            fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return fn


def _check(name: str, q, k, v, *more):
    """Device, shape, dtype, layout and alignment checks for a launch."""
    tensors = (q, k, v) + more
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
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return B, Sq, Skv, Hq, Hkv, D


def _raise_on(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse).  CPU tensors take ``flash_fwd_ref``; CUDA tensors launch
    the forward kernel or raise."""
    global fwd_launches
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal, scale)
    B, Sq, Skv, Hq, Hkv, D = _check("flash_fwd", q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    err = _get_fn("flash_fwd_bf16", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Sq, Skv, Hq, Hkv, D, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_fwd", err)
    fwd_launches += 1
    return out, lse


def _check_bwd(name, q, k, v, do, lse, delta):
    dims = _check(name, q, k, v, do, lse, delta)
    B, Sq, _, Hq, _, _ = dims
    if do.shape != q.shape or do.dtype != q.dtype or \
            lse.shape != (B, Hq, Sq) or delta.shape != (B, Hq, Sq) or \
            lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"{name}: do must match q; lse and delta must be "
                         f"[B, Hq, Sq] float32")
    return dims


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = True, scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv).  CPU tensors take ``flash_bwd_dkv_ref``; CUDA tensors
    launch the dK/dV kernel or raise."""
    global bwd_dkv_launches
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale)
    B, Sq, Skv, Hq, Hkv, D = _check_bwd("flash_bwd_dkv", q, k, v, do, lse,
                                        delta)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _get_fn("flash_bwd_dkv_bf16", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, Skv, Hq, Hkv, D, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_bwd_dkv", err)
    bwd_dkv_launches += 1
    return dk, dv


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool = True,
                 scale: Optional[float] = None) -> torch.Tensor:
    """dq.  CPU tensors take ``flash_bwd_dq_ref``; CUDA tensors launch the
    dQ kernel or raise."""
    global bwd_dq_launches
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale)
    B, Sq, Skv, Hq, Hkv, D = _check_bwd("flash_bwd_dq", q, k, v, do, lse,
                                        delta)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dq = torch.empty_like(q)
    err = _get_fn("flash_bwd_dq_bf16", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, Sq, Skv, Hq, Hkv, D, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_bwd_dq", err)
    bwd_dq_launches += 1
    return dq


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): delta, then the dK/dV kernel, then the dQ kernel (or
    their plain versions on CPU tensors, which makes this the plain version
    of the whole backward there)."""
    if out.shape != q.shape:
        raise ValueError("flash_bwd: out must match q")
    delta = attention_delta(out, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal, scale), dk, dv


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(),
                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention.  q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D]; GQA via
    Hq > Hkv.  Differentiable in q, k and v."""
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"q heads {q.shape[2]} must be a multiple of kv "
                         f"heads {k.shape[2]}")
    return _FlashAttention.apply(q, k, v, causal, scale)
