"""Rotary position embeddings (RoPE), Llama-3 style.

Plain torch: RoPE is elementwise and bandwidth-bound; it needs no kernel
of its own.  Port of ``kuberay_tpu/ops/rope.py``.
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 500000.0,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Precompute float32 cos/sin tables: [max_len, head_dim//2]."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor | None = None) -> torch.Tensor:
    """Apply RoPE.  x: [..., seq, heads, head_dim]; cos/sin: [max_len, hd//2].

    ``positions``: optional [..., seq] absolute positions (decode-time
    cache stepping); defaults to arange(seq).  As in the JAX package, a
    bf16 ``x`` meets the float32 tables in float32 and the result is cast
    back to ``x.dtype`` once.
    """
    if positions is None:
        seq = x.shape[-3]
        c = cos[:seq, None, :]
        s = sin[:seq, None, :]
    else:
        c = cos[positions][..., :, None, :]
        s = sin[positions][..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
