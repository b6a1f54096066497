"""Grouped (ragged) expert matmuls for MoE layers, in PyTorch.

Port of ``kuberay_tpu/ops/moe_matmul.py``.  The dropless all-experts path
runs every expert on every token and zero-weights the unchosen ones: E/K
times the necessary FLOPs (8 x 7B top-2: 4x).  The grouped FFN runs the K
chosen experts only:

1. replicate each token once per chosen expert (the T*K (token, k) rows),
2. sort the rows by expert id with a stable sort (ties keep row order, as
   the reference's ``argsort``),
3. run the SwiGLU over each expert's contiguous group,
4. unsort and combine with the routing weights.

The JAX package runs step 3 as one ``jax.lax.ragged_dot`` per weight, an
XLA op (no Pallas kernel stands behind it).  Here it is a ``torch.matmul``
per non-empty group, which needs the group sizes on the host: one
device-to-host sync per call (a layer), counted as ``moe_host_syncs`` in
``ops/launches.py``.  A hand-written grouped GEMM is later speed work.

Under expert parallelism a rank holds experts [expert_offset,
expert_offset + E_local) only (``w_*`` are its shards): rows routed
elsewhere are sorted past the local groups, never run, and add zero, so
the caller sums the ranks' outputs over ep.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from kuberay_tpu_torch.ops import launches


def grouped_moe_ffn(xt: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor,
                    topi: torch.Tensor, topw: torch.Tensor,
                    expert_offset: int = 0) -> torch.Tensor:
    """SwiGLU expert FFN over the tokens' top-k experts only.

    xt: [T, d] tokens (the products keep xt's dtype); w_gate, w_up: [E, d,
    f]; w_down: [E, f, d] (E local experts, the first of them expert
    ``expert_offset``); topi: [T, K] chosen expert ids; topw: [T, K]
    combine weights (already normalised and masked).  Returns [T, d]: the
    sum over the chosen experts held here.
    """
    T, d = xt.shape
    E = w_gate.shape[0]
    K = topi.shape[1]
    local = topi.reshape(T * K) - expert_offset
    # row r -> local expert id; rows for other ranks' experts -> E (last).
    flat_expert = torch.where((local >= 0) & (local < E), local, E)
    order = torch.argsort(flat_expert, stable=True)
    x_sorted = xt[order // K]                        # row r is token r // K
    sizes = torch.bincount(flat_expert, minlength=E + 1).tolist()
    launches.bump("moe_host_syncs")
    out_sorted = torch.zeros_like(x_sorted)
    lo = 0
    for e, n in enumerate(sizes[:E]):
        if n:
            xs = x_sorted[lo:lo + n]
            gated = F.silu(xs @ w_gate[e]) * (xs @ w_up[e])
            out_sorted[lo:lo + n] = gated @ w_down[e]
        lo += n
    unsorted = torch.empty_like(out_sorted)
    unsorted[order] = out_sorted
    per_k = unsorted.reshape(T, K, d)
    return torch.einsum("tk,tkd->td", topw.to(per_k.dtype), per_k)


def dropless_reference(xt: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, w_down: torch.Tensor,
                       topi: torch.Tensor, topw: torch.Tensor
                       ) -> torch.Tensor:
    """All-experts reference: every expert runs on every token and the
    unchosen ones get zero combine weight (the numeric check of the
    grouped FFN)."""
    T, _ = xt.shape
    E = w_gate.shape[0]
    weights = torch.zeros(T, E, dtype=xt.dtype, device=xt.device)
    weights.scatter_(1, topi.long(), topw.to(xt.dtype))
    gated = F.silu(torch.einsum("td,edf->tef", xt, w_gate)) \
        * torch.einsum("td,edf->tef", xt, w_up)
    all_out = torch.einsum("tef,efd->ted", gated, w_down)
    return torch.einsum("te,ted->td", weights, all_out)


def moe_ffn_flops(T: int, d: int, f: int, n_experts: int, top_k: int
                  ) -> Dict[str, float]:
    """FLOPs of the two strategies (3 matmuls each)."""
    per_row = 3 * 2 * d * f
    return {"grouped": float(T * top_k * per_row),
            "dropless": float(T * n_experts * per_row)}
