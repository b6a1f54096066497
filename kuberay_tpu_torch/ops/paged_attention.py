"""Paged decode attention: one-token queries read straight from the block
pool through each request's block table.

Replaces ``kuberay_tpu/ops/paged_attention.py::_paged_kernel`` (reached
through ``paged_decode_attention_pallas``) with the hand-written CUDA
kernel in ``csrc/paged_attention.cu``, built by ``ops/_build.py`` and
called through ctypes.  Bound on an H100: bytes, the same live K/V rows as
the dense decode kernel; the indirection adds a table entry per page and
the split partials their float32 write and read.  It runs the dense
kernels' split-and-merge (``ops/decode_attention.py``: ``split_plan`` of
the table's capacity ``max_blocks * block_size``, a float32 workspace,
the merge kernel) with each row's address read from the table; the
source's header note gives the design.  ``paged_decode_attention_split_ref``
is the plain model of that split-and-merge.

Layout as in the JAX package: q [S, Hq, D]; the pool pk/pv is head-major
[Hkv, P, D] (P = num_blocks * block_size), so one page of one kv head is a
contiguous ``block_size * D`` run; tables [S, max_blocks] physical block
ids; lens [S] -> out [S, Hq, D].  ``lens == 0`` gives 0, the TPU kernel's
``l == 0`` guard.
"""

from __future__ import annotations

from typing import Optional

import torch

from kuberay_tpu_torch.ops import launches
from kuberay_tpu_torch.ops._build import FLOAT, INT, PTR, bind
from kuberay_tpu_torch.ops.decode_attention import (
    CHUNK,
    _raise_on,
    _scale,
    _workspace,
    check_cuda_inputs,
    decode_attention_ref,
    decode_attention_split_ref,
    split_plan,
)

# The C entry points of csrc/<LIBRARY>.cu and their ctypes argtypes
# (tests/test_torch_abi.py holds them to the C signatures).
LIBRARY = "paged_attention"
ARGTYPES = {
    # q, pk, pv, tables, lens, out, ws; S, P, max_blocks, block_size, Hq,
    # Hkv, D, chunk, nsplit; the scale and the stream
    "paged_decode_attention_bf16": [PTR] * 7 + [INT] * 9 + [FLOAT, PTR],
    # D, G
    "paged_decode_attention_smem_bytes": [INT] * 2,
}
_fn = bind(LIBRARY, ARGTYPES)


def flat_indices(tables: torch.Tensor, block_size: int) -> torch.Tensor:
    """[B, max_blocks] tables -> [B, max_blocks * block_size] flat pool
    positions: the one logical-to-physical position map for gathered views
    (values and the int8 scale pools resolve through it alike)."""
    B, nblk = tables.shape
    offs = torch.arange(block_size, device=tables.device, dtype=tables.dtype)
    return (tables[:, :, None] * block_size + offs).reshape(
        B, nblk * block_size)


def gather_view(pool: torch.Tensor, tables: torch.Tensor,
                block_size: int) -> torch.Tensor:
    """[Hkv, P, D] pool + [B, max_blocks] tables -> [B, K, Hkv, D]
    per-request logical view (a gathered copy, returned as a transpose:
    not contiguous)."""
    flat = flat_indices(tables, block_size).long()
    return pool[:, flat].permute(1, 2, 0, 3)


def paged_decode_attention_ref(q: torch.Tensor, pk: torch.Tensor,
                               pv: torch.Tensor, lens: torch.Tensor,
                               tables: torch.Tensor, block_size: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: gather each request's logical view, then
    ``decode_attention_ref`` (the JAX package's
    ``paged_decode_attention_xla``, with 0 for ``lens == 0``)."""
    return decode_attention_ref(q, gather_view(pk, tables, block_size),
                                gather_view(pv, tables, block_size), lens,
                                scale)


def paged_decode_attention_split_ref(q: torch.Tensor, pk: torch.Tensor,
                                     pv: torch.Tensor, lens: torch.Tensor,
                                     tables: torch.Tensor, block_size: int,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Plain model of the paged kernels' split-and-merge: the gathered
    view's split partials over ``split_plan(max_blocks * block_size)``
    splits, merged."""
    return decode_attention_split_ref(
        q, gather_view(pk, tables, block_size),
        gather_view(pv, tables, block_size), lens, scale)


def paged_decode_attention(q: torch.Tensor, pk: torch.Tensor,
                           pv: torch.Tensor, lens: torch.Tensor,
                           tables: torch.Tensor, block_size: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention.  CPU tensors take
    ``paged_decode_attention_ref``; CUDA tensors launch the split kernel
    over ``split_plan(max_blocks * block_size)`` splits and the
    merge, or raise.  Table entries of live blocks must name blocks of the
    pool; entries past ``ceil(lens / block_size)`` are never read."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pk, pv, lens, tables,
                                          block_size, scale)
    S, Hq, D = q.shape
    if pk.dim() != 3 or pv.shape != pk.shape or pk.shape[2] != D \
            or tables.dim() != 2 or tables.shape[0] != S or block_size <= 0 \
            or pk.shape[1] % block_size:
        raise ValueError(f"paged_decode_attention: shapes q {tuple(q.shape)}, "
                         f"pk {tuple(pk.shape)}, pv {tuple(pv.shape)}, "
                         f"tables {tuple(tables.shape)}, block_size "
                         f"{block_size}")
    check_cuda_inputs("paged_decode_attention", q, pk.shape[0], lens,
                      (pk, pv), (tables,))
    if pk.dtype != torch.bfloat16 or pv.dtype != torch.bfloat16 \
            or tables.dtype != torch.int32:
        raise TypeError("paged_decode_attention: pk/pv must be bfloat16 and "
                        "tables int32")
    Hkv, P = pk.shape[0], pk.shape[1]
    nsplit = split_plan(tables.shape[1] * block_size)
    out = torch.empty_like(q)
    ws = _workspace(q, nsplit)
    fn = _fn("paged_decode_attention_bf16")
    _raise_on(fn(q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), S, P, tables.shape[1], block_size, Hq, Hkv,
                 D, CHUNK, nsplit, _scale(D, scale),
                 torch.cuda.current_stream(q.device).cuda_stream),
              "paged_decode_attention")
    launches.bump("paged_decode_attention")
    return out


def smem_bytes(D: int, G: int) -> int:
    """Shared memory a block of the split kernel holds at (D, G), as the
    runtime reports it once that instantiation has launched."""
    return _fn("paged_decode_attention_smem_bytes")(D, G)
