"""Convert a JAX Llama or Mixtral parameter tree (as numpy arrays) into
the port's.

The tree is the same leaf for leaf (Mixtral's 4-D expert leaves ``[L, E,
in, out]`` and its router included), and the port keeps the reference's
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
        set() if getattr(cfg, "tie_embeddings", False) else {"lm_head"})
    if set(params) != expected:
        raise ValueError(f"parameter tree keys {sorted(params)} != "
                         f"{sorted(expected)}")
    return params


def state_from_jax(cfg, np_state: Dict[str, Any], device="cuda"
                   ) -> Dict[str, Any]:
    """A JAX train state (``init_train_state`` / ``make_train_step``'s
    output, leaves through ``np.asarray``) as the port's state.

    The JAX optimizer state is optax's chain(clip_by_global_norm,
    adamw): ``(EmptyState, (ScaleByAdamState(count, mu, nu), EmptyState,
    ScaleByScheduleState(count)))``; its Adam count, mu and nu become the
    port's {"count", "mu", "nu"} (the two optax counts always agree).
    """
    adam = np_state["opt_state"][1][0]
    count, mu, nu = adam[0], adam[1], adam[2]
    return {"step": int(np.asarray(np_state["step"])),
            "params": params_from_jax(cfg, np_state["params"], device),
            "opt_state": {"count": int(np.asarray(count)),
                          "mu": params_from_jax(cfg, mu, device),
                          "nu": params_from_jax(cfg, nu, device)}}
