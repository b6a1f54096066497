"""Decode attention: one-token queries against the dense serving cache.

Replaces ``kuberay_tpu/ops/decode_attention.py::_decode_kernel`` in both
its forms with the hand-written CUDA kernels in ``csrc/decode_attention.cu``
(built by ``ops/_build.py``, called through ctypes): the bf16 cache
(``decode_attention_pallas``) and the int8 cache with per-position scales
(``decode_attention_quant_pallas``).  Bound on an H100: bytes (each slot's
live K/V rows stream once, plus the split partials' float32 write and
read); the kernels read only positions below ``lens[s]``, the live-length
skip the TPU kernel exists for.

Design (flash-decoding; the source's header note has the details): each
slot's positions are cut into ``split_plan(M)`` chunks of ``CHUNK``; one
block per (slot, kv head, chunk) streams the chunk's live rows through a
4-stage ``cp.async`` ring and writes a float32 partial (m, l, acc) to a
workspace that the wrapper allocates; a merge kernel combines each
(slot, q head)'s partials in a fixed order.  The split count depends on
the cache capacity alone, never on ``lens`` (which stays on the device),
so a call is captured by a CUDA graph.  ``*_split_ref`` are plain models
of the split-and-merge with the same chunk and split count.

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
import torch.nn.functional as F

from kuberay_tpu_torch.ops._build import FLOAT, INT, PTR, bind

launches = 0           # bf16 wrapper calls that launched the kernels
launches_quant = 0     # int8 wrapper calls that launched the kernels

_NEG_INF = -1e30
TILE = 64              # rows a block's 4 warps take a round (16 each)
CHUNK = 256            # positions a split owns (a multiple of TILE)
MAX_SPLITS = 4096      # splits a call may have (the merge's shared memory)

# The C entry points of csrc/<LIBRARY>.cu and their ctypes argtypes:
# pointers, then the ints, then the scale and the stream
# (tests/test_torch_abi.py holds them to the C signatures).
LIBRARY = "decode_attention"
ARGTYPES = {
    # q, ck, cv, lens, out, ws; S, M, Hq, Hkv, D, chunk, nsplit
    "decode_attention_bf16": [PTR] * 6 + [INT] * 7 + [FLOAT, PTR],
    # q, kq, ks, vq, vs, lens, out, ws; S, M, Hq, Hkv, D, chunk, nsplit
    "decode_attention_int8": [PTR] * 8 + [INT] * 7 + [FLOAT, PTR],
    # ws, out; rows, nsplit, D; the stream
    "decode_attention_merge": [PTR] * 2 + [INT] * 3 + [PTR],
    # D, G, quant
    "decode_attention_smem_bytes": [INT] * 3,
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


def split_plan(cap: int, chunk: int = CHUNK) -> int:
    """The number of splits of a cache of ``cap`` positions (M, or
    ``max_blocks * block_size`` for the paged pool): ceil(cap / chunk).
    Depends on the capacity alone, never on ``lens``."""
    n = -(-cap // chunk) if chunk > 0 else 0
    if cap <= 0 or chunk <= 0 or chunk % TILE or n > MAX_SPLITS:
        raise ValueError(f"split plan: capacity {cap}, chunk {chunk} (a "
                         f"positive multiple of {TILE}, at most "
                         f"{MAX_SPLITS} splits)")
    return n


def workspace_numel(S: int, Hq: int, D: int, nsplit: int) -> int:
    """float32 values of the kernels' workspace: acc [S * Hq, nsplit, D],
    then (m, l) [S * Hq, nsplit, 2]."""
    return S * Hq * nsplit * (D + 2)


def split_partials_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lens: torch.Tensor, scale: Optional[float] = None,
                       chunk: int = CHUNK, ks: Optional[torch.Tensor] = None,
                       vs: Optional[torch.Tensor] = None):
    """Plain model of the split kernels: the float32 partials of every
    (slot, q head, split), acc [S, Hq, nsplit, D] (unnormalised), m and l
    [S, Hq, nsplit]; an empty split has m = -inf, l = 0 and acc 0.  With
    ``ks``/``vs`` ([S, Hkv, M] scales of an int8 cache ``k``/``v``), the key
    scale multiplies the score column and the value scale multiplies p
    after p joins l, as the kernel folds them."""
    S, Hq, D = q.shape
    M, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n = split_plan(M, chunk)
    pad = n * chunk - M
    qg = q.float().reshape(S, Hkv, G, D)
    s = torch.einsum("sngd,smnd->sngm", qg, k.float()) * _scale(D, scale)
    if ks is not None:
        s = s * ks.float()[:, :, None, :]
    live = (torch.arange(n * chunk, device=q.device)[None, :]
            < lens.to(q.device).clamp(0, M)[:, None])
    s = F.pad(s, (0, pad)).masked_fill(~live[:, None, None, :],
                                       -math.inf).reshape(S, Hkv, G, n, chunk)
    m = s.amax(-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(-1)
    if vs is not None:
        p = p * F.pad(vs.float(), (0, pad)).reshape(S, Hkv, 1, n, chunk)
    vv = F.pad(v.float(), (0, 0, 0, 0, 0, pad)).reshape(S, n, chunk, Hkv, D)
    acc = torch.einsum("sngic,sicnd->sngid", p, vv)
    return (acc.reshape(S, Hq, n, D), m.reshape(S, Hq, n),
            l.reshape(S, Hq, n))


def merge_ref(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """Plain model of the merge kernel: sum_i w_i acc_i / sum_i w_i l_i
    with w_i = exp(m_i - max m) over the partials with l_i > 0 (the others'
    acc never read), 0 where there are none."""
    live = l > 0
    mx = torch.where(live, m, -math.inf).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - torch.where(torch.isfinite(mx), mx,
                                                    0.0)), 0.0)
    den = (w * l).sum(-1)
    num = torch.where(live[..., None], w[..., None] * acc, 0.0).sum(-2)
    out = torch.where(den[..., None] > 0,
                      num / torch.where(den > 0, den, 1.0)[..., None], 0.0)
    return out.to(dtype)


def pack_partials(acc: torch.Tensor, m: torch.Tensor,
                  l: torch.Tensor) -> torch.Tensor:
    """The partials in the kernels' workspace layout (flat float32)."""
    return torch.cat([acc.float().reshape(-1),
                      torch.stack([m, l], -1).float().reshape(-1)])


def decode_attention_split_ref(q: torch.Tensor, ck: torch.Tensor,
                               cv: torch.Tensor, lens: torch.Tensor,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Plain model of the bf16 kernels' split-and-merge."""
    return merge_ref(*split_partials_ref(q, ck, cv, lens, scale), q.dtype)


def decode_attention_quant_split_ref(q: torch.Tensor, kq: torch.Tensor,
                                     ks: torch.Tensor, vq: torch.Tensor,
                                     vs: torch.Tensor, lens: torch.Tensor,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Plain model of the int8 kernels' split-and-merge, scales folded as
    the kernel folds them."""
    return merge_ref(*split_partials_ref(q, kq, vq, lens, scale, ks=ks,
                                         vs=vs), q.dtype)


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


def _workspace(q: torch.Tensor, nsplit: int) -> torch.Tensor:
    """The split kernels' float32 workspace on q's device (and, through
    the caching allocator, its current stream); every value the merge
    reads is written by the split kernel first."""
    S, Hq, D = q.shape
    return torch.empty(workspace_numel(S, Hq, D, nsplit),
                       dtype=torch.float32, device=q.device)


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     lens: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over the bf16 cache.  CPU tensors take
    ``decode_attention_ref``; CUDA tensors launch the split kernel over
    ``split_plan(M)`` splits and the merge, or raise."""
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
    nsplit = split_plan(M)
    out = torch.empty_like(q)
    ws = _workspace(q, nsplit)
    fn = _fn("decode_attention_bf16")
    _raise_on(fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), S, M, Hq, Hkv, D, CHUNK,
                 nsplit, _scale(D, scale),
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
    ``decode_attention_quant_ref``; CUDA tensors launch the split kernel
    and the merge, as ``decode_attention``, or raise."""
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
    nsplit = split_plan(M)
    out = torch.empty_like(q)
    ws = _workspace(q, nsplit)
    fn = _fn("decode_attention_int8")
    _raise_on(fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
                 vs.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), S, M, Hq, Hkv, D, CHUNK, nsplit,
                 _scale(D, scale),
                 torch.cuda.current_stream(q.device).cuda_stream),
              "decode_attention_quant")
    launches_quant += 1
    return out


def merge_partials(ws: torch.Tensor, S: int, Hq: int, D: int,
                   nsplit: int) -> torch.Tensor:
    """The merge kernel alone over a workspace ``ws`` (``pack_partials``'s
    layout, on the card) -> [S, Hq, D] bf16: for checking the merge against
    ``merge_ref`` and timing it.  Not counted in ``launches``."""
    if ws.device.type != "cuda" or ws.dtype != torch.float32 \
            or not ws.is_contiguous() \
            or ws.numel() != workspace_numel(S, Hq, D, nsplit):
        raise ValueError(f"merge_partials: workspace {tuple(ws.shape)} "
                         f"{ws.dtype} on {ws.device}")
    out = torch.empty(S, Hq, D, dtype=torch.bfloat16, device=ws.device)
    _raise_on(_fn("decode_attention_merge")(
        ws.data_ptr(), out.data_ptr(), S * Hq, nsplit, D,
        torch.cuda.current_stream(ws.device).cuda_stream),
        "decode_attention_merge")
    return out


def smem_bytes(D: int, G: int, quant: bool) -> int:
    """Shared memory a block of the split kernel holds at (D, G), as the
    runtime reports it once that instantiation has launched."""
    return _fn("decode_attention_smem_bytes")(D, G, int(quant))
