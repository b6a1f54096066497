"""Prefix hashes of the paged KV cache.

A copy of ``chain_hash`` and ``block_hashes`` from
``kuberay_tpu/serve/prefix.py``: a chained hash over full ``block_size``
token blocks (the vLLM/SGLang prefix-cache key).  The gateway of the JAX
package hashes prompts the same way to predict where a prefix is cached,
so the copy must give the same numbers; it does, because Python's hash of
a tuple of ints is not salted by ``PYTHONHASHSEED`` (only str and bytes
are).
"""

from __future__ import annotations

from typing import List, Sequence


def chain_hash(parent: int, block_tokens: Sequence[int]) -> int:
    """One link of the prefix hash chain."""
    return hash((parent, tuple(block_tokens)))


def block_hashes(tokens: Sequence[int], block_size: int) -> List[int]:
    """Hash chain over the full blocks of a token sequence (the partial
    tail block is never cacheable and never hashed)."""
    out: List[int] = []
    parent = 0
    for i in range(0, len(tokens) - len(tokens) % block_size, block_size):
        parent = chain_hash(parent, tokens[i:i + block_size])
        out.append(parent)
    return out
