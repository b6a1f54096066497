"""Weights made from the seed, on the device, in the type they are used in.

The benchmark makes the weights and hands the same tensors to the port and
to the reference: a Llama-architecture tree in the port's layout (a dict
whose layer leaves are stacked on a leading ``[layers]`` axis, matmul
weights ``[in, out]``).  Each leaf is one draw from its own generator, so
one leaf can be drawn again alone and a run draws in a few large calls.
Scales: normal(0, 1 / sqrt(d)) for the matmul weights and the embedding,
divided by sqrt(2 L) for the two output projections (GPT-NeoX style), and
1 + normal(0, 0.05) for the RMSNorm gains, so that a norm that drops its
gain is seen.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.counts import Dims

NORMS = ("attn_norm", "mlp_norm")


def leaf_specs(dims: Dims) -> List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                         str]]:
    """(path, shape, init) of every leaf, in draw order."""
    d, f, v, L = dims.d, dims.ff, dims.vocab, dims.layers
    q, kv = dims.heads * dims.head_dim, dims.kv_heads * dims.head_dim
    specs = [(("embed",), (v, d), "in"),
             (("layers", "attn_norm"), (L, d), "norm"),
             (("layers", "wq"), (L, d, q), "in"),
             (("layers", "wk"), (L, d, kv), "in"),
             (("layers", "wv"), (L, d, kv), "in"),
             (("layers", "wo"), (L, q, d), "out"),
             (("layers", "mlp_norm"), (L, d), "norm"),
             (("layers", "w_gate"), (L, d, f), "in"),
             (("layers", "w_up"), (L, d, f), "in"),
             (("layers", "w_down"), (L, f, d), "out"),
             (("final_norm",), (d,), "norm")]
    if not dims.tied:
        specs.append((("lm_head",), (d, v), "in"))
    return specs


def leaf_seed(seed: int, index: int) -> int:
    return (abs(int(seed)) * 1000003 + 7919 * index + (seed < 0)) % (2 ** 63)


def make_leaf(dims: Dims, seed: int, index: int, device,
              dtype: torch.dtype) -> torch.Tensor:
    _, shape, init = leaf_specs(dims)[index]
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, index))
    w = torch.randn(shape, generator=g, device=device, dtype=dtype)
    std = 1.0 / math.sqrt(dims.d)
    if init == "norm":
        return w.mul_(0.05).add_(1.0)
    if init == "out":
        std /= math.sqrt(2 * dims.layers)
    return w.mul_(std)


def make_params(dims: Dims, seed: int, device,
                dtype: torch.dtype) -> Dict:
    """The whole tree, one draw a leaf."""
    tree: Dict = {"layers": {}}
    for i, (path, _, _) in enumerate(leaf_specs(dims)):
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = make_leaf(dims, seed, i, device, dtype)
    return tree


def leaf_names(dims: Dims) -> List[str]:
    return [".".join(path) for path, _, _ in leaf_specs(dims)]


def get_leaf(tree: Dict, name: str) -> torch.Tensor:
    node = tree
    for key in name.split("."):
        node = node[key]
    return node
