"""Decode attention: one-token queries against the dense serving cache.

Replaces ``kuberay_tpu/ops/decode_attention.py::_decode_kernel`` (bf16
cache, via ``decode_attention_pallas``) with the hand-written CUDA kernel in
``csrc/decode_attention.cu``, built by ``ops/_build.py`` and called through
ctypes.  Bound on an H100: bytes (each slot's live K/V rows stream once);
the kernel reads only positions below ``lens[s]``, the live-length skip the
TPU kernel exists for.  The source's header note gives the design.

Layout as in the JAX package: q [S, Hq, D]; ck/cv [S, M, Hkv, D];
lens [S] -> out [S, Hq, D].  A slot with ``lens == 0`` gives 0, as the TPU
kernel does (its XLA reference instead averages V over the whole cache).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

launches = 0           # kernel launches on CUDA tensors, for run-time checks

_NEG_INF = -1e30
_lock = threading.Lock()
_fn = None


def decode_attention_ref(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                         lens: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: float32 scores over the whole cache, masked
    past each slot's length; ``lens == 0`` slots give 0."""
    S, Hq, D = q.shape
    M, Hkv = ck.shape[1], ck.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.float().reshape(S, Hkv, G, D)
    s = torch.einsum("sngd,smnd->sngm", qg, ck.float()) * scale
    live = torch.arange(M, device=q.device)[None, :] < lens.to(q.device)[:, None]
    s = s.masked_fill(~live[:, None, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("sngm,smnd->sngd", p, cv.float()).reshape(S, Hq, D)
    out = out * (lens.to(q.device) > 0)[:, None, None]
    return out.to(q.dtype)


def _get_fn():
    global _fn
    with _lock:
        if _fn is None:
            from kuberay_tpu_torch.ops._build import load_library
            fn = load_library("decode_attention").decode_attention_bf16
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     lens: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention.  CPU tensors take ``decode_attention_ref``; CUDA
    tensors launch the CUDA kernel or raise."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_ref(q, ck, cv, lens, scale)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (ck, cv, lens)):
        raise ValueError("decode_attention: q, ck, cv and lens must be on "
                         "one CUDA device")
    if q.dim() != 3 or ck.dim() != 4 or cv.shape != ck.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"ck {tuple(ck.shape)}, cv {tuple(cv.shape)}")
    S, Hq, D = q.shape
    M, Hkv = ck.shape[1], ck.shape[2]
    if ck.shape[0] != S or ck.shape[3] != D or Hq % Hkv != 0 \
            or lens.shape != (S,):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"ck {tuple(ck.shape)}, lens {tuple(lens.shape)}")
    if D not in (64, 128) or Hq // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention: no kernel for head_dim {D}, "
                         f"group {Hq // Hkv} (64/128; 1, 2, 4, 8)")
    if any(t.dtype != torch.bfloat16 for t in (q, ck, cv)) \
            or lens.dtype != torch.int32:
        raise TypeError("decode_attention: q/ck/cv must be bfloat16 and "
                        "lens int32")
    if not all(t.is_contiguous() for t in (q, ck, cv, lens)):
        raise ValueError("decode_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, ck, cv)):
        raise ValueError("decode_attention: q/ck/cv must be 16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    err = _get_fn()(q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
                    lens.data_ptr(), out.data_ptr(), S, M, Hq, Hkv, D,
                    scale, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
