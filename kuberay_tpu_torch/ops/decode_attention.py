"""Decode attention: one-token queries against the dense serving cache.

Replaces ``kuberay_tpu/ops/decode_attention.py::_decode_kernel`` in both
its forms with the hand-written CUDA kernels in ``csrc/decode_attention.cu``
(built by ``ops/_build.py``, called through ctypes): the bf16 cache
(``decode_attention_pallas``) and the int8 cache with per-position scales
(``decode_attention_quant_pallas``).  Bound on an H100: bytes (each slot's
live K/V rows stream once); the kernels read only positions below
``lens[s]``, the live-length skip the TPU kernel exists for.  The source's
header note gives the design.

Layout as in the JAX package: q [S, Hq, D]; ck/cv [S, M, Hkv, D], or for
the int8 cache kq/vq [S, M, Hkv, D] int8 with ks/vs [S, Hkv, M] float32
(positions on the last axis); lens [S] -> out [S, Hq, D].  A slot with
``lens == 0`` gives 0, as the TPU kernel does (its XLA reference instead
averages V over the whole cache).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kuberay_tpu_torch.ops._build import FLOAT, INT, PTR, bind

launches = 0           # bf16 kernel launches on CUDA tensors
launches_quant = 0     # int8 kernel launches on CUDA tensors

_NEG_INF = -1e30

# The C entry points of csrc/<LIBRARY>.cu and their ctypes argtypes:
# pointers, then the ints, then the scale and the stream
# (tests/test_torch_abi.py holds them to the C signatures).
LIBRARY = "decode_attention"
ARGTYPES = {
    # q, ck, cv, lens, out; S, M, Hq, Hkv, D
    "decode_attention_bf16": [PTR] * 5 + [INT] * 5 + [FLOAT, PTR],
    # q, kq, ks, vq, vs, lens, out; S, M, Hq, Hkv, D
    "decode_attention_int8": [PTR] * 7 + [INT] * 5 + [FLOAT, PTR],
}
_fn = bind(LIBRARY, ARGTYPES)


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


def dequant_lanes(x8: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Dequantise the lane-major scale layout: x8 [..., M, H, D] int8,
    s [..., H, M] float32 -> [..., M, H, D] in ``dtype``."""
    return (x8.float() * s.transpose(-2, -1)[..., None]).to(dtype)


def decode_attention_quant_ref(q: torch.Tensor, kq: torch.Tensor,
                               ks: torch.Tensor, vq: torch.Tensor,
                               vs: torch.Tensor, lens: torch.Tensor,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Plain version for the int8 cache: dequantise to q's dtype, then
    ``decode_attention_ref`` (the JAX package's
    ``decode_attention_quant_xla``, with 0 for ``lens == 0``)."""
    return decode_attention_ref(q, dequant_lanes(kq, ks, q.dtype),
                                dequant_lanes(vq, vs, q.dtype), lens, scale)


def check_cuda_inputs(name: str, q: torch.Tensor, hkv: int,
                      lens: torch.Tensor, kv: tuple, others: tuple = ()
                      ) -> None:
    """The checks the decode kernels share: one CUDA device, q [S, Hq, D]
    bf16 with D 64 or 128, a group Hq / hkv of 1, 2, 4 or 8, lens [S]
    int32, everything contiguous, and q and the ``kv`` tensors 16-byte
    aligned."""
    tensors = (q, *kv, lens, *others)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if q.dim() != 3 or lens.shape != (q.shape[0],):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"lens {tuple(lens.shape)}")
    Hq, D, Hkv = q.shape[1], q.shape[2], hkv
    if D not in (64, 128) or Hq % Hkv or Hq // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"{name}: no kernel for head_dim {D}, {Hq} q / "
                         f"{Hkv} kv heads (64/128; group 1, 2, 4, 8)")
    if q.dtype != torch.bfloat16 or lens.dtype != torch.int32:
        raise TypeError(f"{name}: q must be bfloat16 and lens int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, *kv)):
        raise ValueError(f"{name}: q and the cache must be 16-byte aligned")


def _scale(D: int, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(D)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     lens: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over the bf16 cache.  CPU tensors take
    ``decode_attention_ref``; CUDA tensors launch the CUDA kernel or
    raise."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_ref(q, ck, cv, lens, scale)
    S, Hq, D = q.shape
    if ck.dim() != 4 or cv.shape != ck.shape or ck.shape[0] != S \
            or ck.shape[3] != D:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"ck {tuple(ck.shape)}, cv {tuple(cv.shape)}")
    check_cuda_inputs("decode_attention", q, ck.shape[2], lens, (ck, cv))
    if ck.dtype != torch.bfloat16 or cv.dtype != torch.bfloat16:
        raise TypeError("decode_attention: ck/cv must be bfloat16")
    M, Hkv = ck.shape[1], ck.shape[2]
    out = torch.empty_like(q)
    fn = _fn("decode_attention_bf16")
    _raise_on(fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), S, M, Hq, Hkv, D, _scale(D, scale),
                 torch.cuda.current_stream(q.device).cuda_stream),
              "decode_attention")
    launches += 1
    return out


def decode_attention_quant(q: torch.Tensor, kq: torch.Tensor,
                           ks: torch.Tensor, vq: torch.Tensor,
                           vs: torch.Tensor, lens: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over the int8 cache (kq/vq [S, M, Hkv, D] int8,
    ks/vs [S, Hkv, M] float32).  CPU tensors take
    ``decode_attention_quant_ref``; CUDA tensors launch the CUDA kernel or
    raise."""
    global launches_quant
    if q.device.type == "cpu":
        return decode_attention_quant_ref(q, kq, ks, vq, vs, lens, scale)
    S, Hq, D = q.shape
    if kq.dim() != 4 or vq.shape != kq.shape or kq.shape[0] != S \
            or kq.shape[3] != D:
        raise ValueError(f"decode_attention_quant: shapes q {tuple(q.shape)}, "
                         f"kq {tuple(kq.shape)}, vq {tuple(vq.shape)}")
    check_cuda_inputs("decode_attention_quant", q, kq.shape[2], lens,
                      (kq, vq), (ks, vs))
    M, Hkv = kq.shape[1], kq.shape[2]
    if ks.shape != (S, Hkv, M) or vs.shape != ks.shape:
        raise ValueError(f"decode_attention_quant: scales ks "
                         f"{tuple(ks.shape)}, vs {tuple(vs.shape)} != "
                         f"{(S, Hkv, M)}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 \
            or ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError("decode_attention_quant: kq/vq must be int8 and "
                        "ks/vs float32")
    out = torch.empty_like(q)
    fn = _fn("decode_attention_int8")
    _raise_on(fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
                 vs.data_ptr(), lens.data_ptr(), out.data_ptr(), S, M, Hq,
                 Hkv, D, _scale(D, scale),
                 torch.cuda.current_stream(q.device).cuda_stream),
              "decode_attention_quant")
    launches_quant += 1
    return out
