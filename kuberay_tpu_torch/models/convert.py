"""Convert a JAX Llama parameter tree (as numpy arrays) into the port's.

The tree is the same leaf for leaf, and the port keeps the reference's
``[in, out]`` matmul orientation, so nothing is transposed.  bf16 leaves
(numpy arrays of ml_dtypes' bfloat16) go through float32, which holds
every bf16 value exactly.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from kuberay_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    dtype = _DTYPES.get(a.dtype.name)
    if dtype is None:
        raise TypeError(f"unsupported parameter dtype {a.dtype}")
    t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
    return t.to(device=device, dtype=dtype)


def params_from_jax(cfg, np_tree: Dict[str, Any], device="cuda"
                    ) -> Dict[str, Any]:
    """``np_tree``: the JAX ``init_params`` tree with every leaf passed
    through ``np.asarray``.  Returns the port's tree on ``device``."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf(node, dev)

    params = walk(np_tree)
    expected = {"embed", "layers", "final_norm"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(params) != expected:
        raise ValueError(f"parameter tree keys {sorted(params)} != "
                         f"{sorted(expected)}")
    return params
