"""Kernel launch counts of the port's wrappers, one count a kernel name.

A wrapper bumps its kernel's name once a launch on CUDA tensors (a CPU
tensor takes the plain version and counts nothing).  The names are the
kernels' names in PERF.md's kernel table; ``rmsnorm_bwd_g_copies`` counts
the gradients RMSNorm's backward copies into a row layout first and
``moe_host_syncs`` the grouped MoE FFN's device-to-host syncs.

Readers take a ``snapshot`` and compare two of them.  A CUDA graph replay
skips the wrappers' Python, so whoever replays a captured call adds what
the capture counted (``add``); ``serve/forward_graphs.py`` does.
"""

from __future__ import annotations

from typing import Dict

NAMES = ("rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd_dw", "rmsnorm_bwd_g_copies",
         "decode_attention", "decode_attention_quant",
         "paged_decode_attention", "flash_fwd", "flash_bwd_dkv",
         "flash_bwd_dq", "ring_attention_fwd", "moe_host_syncs")

_counts: Dict[str, int] = dict.fromkeys(NAMES, 0)


def bump(name: str) -> None:
    _counts[name] += 1


def snapshot(*names: str) -> Dict[str, int]:
    """The counts of ``names`` (every name where none is given)."""
    return {n: _counts[n] for n in names or NAMES}


def add(delta: Dict[str, int]) -> None:
    """Adds ``delta``'s counts, name by name."""
    for n, k in delta.items():
        _counts[n] += k


def clear() -> None:
    """Every count back to 0."""
    for n in NAMES:
        _counts[n] = 0
