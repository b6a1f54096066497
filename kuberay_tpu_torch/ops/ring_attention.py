"""Sequence-parallel ring attention's forward: one persistent CUDA kernel a
ring, and its plain version.

Replaces ``kuberay_tpu/parallel/ring_pallas.py``'s ``_ring_kernel``, whole
(every ring step's block attention and online merge, and the final
normalisation, in one call), with the hand-written kernel in
``csrc/ring_attention.cu``, built by ``ops/_build.py`` and called through
ctypes.  Bound on an H100: operations (the source's header note gives the
numbers and the design).  The ring around it, with the exchange and the
backward, is ``parallel/ring_kernel.py``.

Layout: q [R, B, Sl, Hq, D], the R ranks held here (global ranks rank0 ..
rank0 + R - 1, rows at global positions r * Sl + i); k, v [n, B, Sl, Hkv,
D], every rank's K/V block (GQA when Hq > Hkv), each block contiguous and
the blocks any 16-byte multiple apart, so the K and V views of an n-slot
buffer [n, 2, B, Sl, Hkv, D] are taken as they are; out like q, lse [R, B,
Hq, Sl] float32.  Rank r merges the blocks ``ring_blocks(r, n, causal)``
in that order: src = r, r - 1, ... (mod n), with ``causal`` only src <= r,
key j of block src visible to row i when src * Sl + j <= r * Sl + i.

``ring_attention_fwd`` takes ``ring_attention_fwd_ref`` (the plain step
chained over the same blocks in the same order) for CPU tensors only; on
CUDA tensors it launches the kernel or raises.  With ``words`` (int32 [n]
on the card, zeroed) the kernel reads block src only once ``words[src]``
is set; ``arrive`` sets a word on the current stream after the work
queued there (the block's copy).  ``ring_schedule`` and ``ring_grid``
mirror the kernel's persistent grid for the CPU model of its schedule in
``tests/test_torch_ring_persistent.py``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from kuberay_tpu_torch.ops import launches
from kuberay_tpu_torch.ops._build import FLOAT, INT, PTR, bind

_NEG_INF = -1e30

# csrc/ring_attention.cu's RESERVED_SMS and fwd90::BQ: SMs a waiting grid
# leaves free, q rows a tile.
RESERVED_SMS = 4
BQ = 128

# The C entry points of csrc/<LIBRARY>.cu and their ctypes argtypes: the
# forward (q, k, v, out, lse, words; R, rank0, n, B, Sl, Hq, Hkv, D,
# kv_stride, causal; the scale and the stream), the kernel's shared
# memory a block at head dim D as the runtime holds it after a launch, and
# the arrival write (word, stream) (tests/test_torch_abi.py holds
# them to the C signatures).
LIBRARY = "ring_attention"
ARGTYPES = {"ring_attention_fwd_bf16": [PTR] * 6 + [INT] * 10
            + [FLOAT, PTR],
            "ring_attention_fwd_smem_bytes": [INT],
            "ring_arrival_write": [PTR, PTR]}
_fn = bind(LIBRARY, ARGTYPES)


def ring_attention_step_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            acc: torch.Tensor, m: torch.Tensor,
                            l: torch.Tensor, q_off: int, k_off: int,
                            causal: bool = True, scale: Optional[float] = None,
                            last: bool = False,
                            out: Optional[torch.Tensor] = None,
                            lse: Optional[torch.Tensor] = None) -> None:
    """One ring step, plain: ``_block_attention`` (f32 scores, causal mask
    on global positions, block max, p zeroed where the max is at or below
    -1e30/2, p rounded to v's dtype before P @ V) and the online merge of
    ``parallel/ring.py`` in the JAX package, on q [B, Sq, Hq, D], one K/V
    block [B, Skv, Hkv, D] and the f32 state acc [B, Sq, Hq, D], m, l
    [B, Hq, Sq], updated in place; with ``last`` normalised into out and
    lse instead.  ``ring_attention_fwd_ref`` chains it."""
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


def ring_blocks(r: int, n: int, causal: bool) -> List[int]:
    """The sources whose blocks rank r merges, in the ring's order: its
    own, then each left neighbour's; with ``causal`` none from its
    future."""
    return [(r - i) % n for i in range(n) if not causal or r - i >= 0]


def ring_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, rank0: int, n: int,
                           causal: bool = True,
                           scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: for each held rank, ``ring_attention_step_ref`` over
    ``ring_blocks`` from the empty state, normalising at the last block."""
    R, B, Sl, Hq, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty((R, B, Hq, Sl), **f32)
    for j in range(R):
        r = rank0 + j
        acc = torch.zeros((B, Sl, Hq, D), **f32)
        m = torch.full((B, Hq, Sl), _NEG_INF, **f32)
        l = torch.zeros((B, Hq, Sl), **f32)
        srcs = ring_blocks(r, n, causal)
        for i, src in enumerate(srcs):
            ring_attention_step_ref(q[j], k[src], v[src], acc, m, l, r * Sl,
                                    src * Sl, causal, scale,
                                    i == len(srcs) - 1, out[j], lse[j])
    return out, lse


def _check(q, k, v, rank0, n, words):
    """Shape, dtype, rank and layout checks, then device and alignment, for
    a launch; returns the kernel's dims."""
    name = "ring_attention_fwd"
    if q.dim() != 5 or k.dim() != 5 or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (q [R, B, "
                         f"Sl, Hq, D], k/v [n, B, Sl, Hkv, D])")
    R, B, Sl, Hq, D = q.shape
    Hkv = k.shape[3]
    if k.shape[0] != n or k.shape[1:3] != (B, Sl) or k.shape[4] != D or \
            Hq % Hkv:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} for a ring of {n}")
    if not 0 <= rank0 or rank0 + R > n:
        raise ValueError(f"{name}: held ranks {rank0}..{rank0 + R - 1} lie "
                         f"outside a ring of {n}")
    if D not in (64, 128) or Hq // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"{name}: no kernel for head_dim {D}, group "
                         f"{Hq // Hkv} (64/128; 1, 2, 4, 8)")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{name}: q/k/v must be bfloat16")
    if words is not None and (words.shape != (n,) or words.dtype !=
                              torch.int32):
        raise ValueError(f"{name}: words must be int32 [{n}]")
    tensors = [q, k, v] + ([words] if words is not None else [])
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    stride = k.stride(0)
    if not (q.is_contiguous() and k[0].is_contiguous()
            and v[0].is_contiguous() and v.stride(0) == stride
            and (words is None or words.is_contiguous())):
        raise ValueError(f"{name}: q and each K/V block must be contiguous, "
                         f"k and v blocks equally far apart")
    if stride < k[0].numel() or stride % 8 or stride >= 2 ** 31 or any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: K/V blocks must not overlap and lie "
                         f"16-byte aligned (stride {stride})")
    return R, B, Sl, Hq, Hkv, D, stride


def ring_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       rank0: int, n: int, causal: bool = True,
                       scale: Optional[float] = None,
                       words: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the held ranks' queries over the ring's blocks.  CPU
    tensors take ``ring_attention_fwd_ref`` (``words`` unused: the blocks
    are there); CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return ring_attention_fwd_ref(q, k, v, rank0, n, causal, scale)
    R, B, Sl, Hq, Hkv, D, stride = _check(q, k, v, rank0, n, words)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty((R, B, Hq, Sl), dtype=torch.float32, device=q.device)
    err = _fn("ring_attention_fwd_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), None if words is None else words.data_ptr(), R,
        rank0, n, B, Sl, Hq, Hkv, D, stride, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_attention_fwd kernel launch failed: "
                           f"cudaError {err}")
    launches.bump("ring_attention_fwd")
    return out, lse


def arrive(words: torch.Tensor, src: int) -> None:
    """Sets words[src] (to 1) once the work queued on the current stream is
    done (on the card a stream memory write; on the CPU a store)."""
    if words.device.type == "cpu":
        words[src] = 1
        return
    err = _fn("ring_arrival_write")(
        words[src].data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_arrival_write failed: error {err}")


def ring_grid(total: int, sms: int, waits: bool) -> int:
    """The kernel's grid: a block per SM, RESERVED_SMS left free while it
    may wait for arrivals, no more blocks than tiles."""
    return max(1, min(total, sms - (RESERVED_SMS if waits else 0)))


def ring_schedule(R: int, rank0: int, n: int, B: int, Sl: int, Hq: int,
                  causal: bool, grid: int) -> List[List[dict]]:
    """Each block's q tiles in the order it takes them, as the kernel's
    ``RingPlan`` walks them: tile (j, b, h, q0) with its global rank r and
    its blocks (src, off) in the order the kernel reads them."""
    nqt = -(-Sl // BQ)
    BH, total = B * Hq, R * nqt * B * Hq
    out = []
    for c in range(grid):
        full = total // grid
        pos = grid - 1 - c if full & 1 else c
        jobs = []
        for k in range(full + (pos < total - full * grid)):
            idx = k * grid + (grid - 1 - c if k & 1 else c)
            gq, bh = R * nqt - 1 - idx // BH, idx % BH
            j, r = gq // nqt, rank0 + gq // nqt
            jobs.append({"j": j, "r": r, "b": bh // Hq, "h": bh % Hq,
                         "q0": (gq % nqt) * BQ,
                         "blocks": [(s, (r - s) * Sl)
                                    for s in ring_blocks(r, n, causal)]})
        out.append(jobs)
    return out
