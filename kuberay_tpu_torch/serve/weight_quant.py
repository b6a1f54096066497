"""int8 weights for serving (W8A16), in PyTorch.

Port of ``kuberay_tpu/serve/weight_quant.py``: the matmul weights
(attention projections, FFN, ``lm_head``) are stored as int8 with one
float32 scale per output channel, so the resident weights take half the
bytes of bf16 ones.  Activations stay in the model's dtype.  Embeddings and
norm vectors are not quantised (the embedding is read by gather, not by a
product).

Quantisation is the reference's arithmetic, bit for bit: the absolute
maximum over the contraction axis (``ndim - 2``, so stacked layers keep
their own scales), ``max(amax, 1e-8) / 127``, round half to even, clip to
+-127.  Dequantisation is the reference's too: ``q8`` times ``s8``, both
in bf16 in the forward (then cast to the model's dtype where that is not
bf16), both in the requested dtype in ``dequantize_weights``.

Where XLA fuses the dequantisation into each product's operand read, an
eager forward would write and re-read a whole bf16 tree if it dequantised
the tree up front.  So ``make_weight_dequant_forward`` hands the forward a
view of the tree that dequantises on access: a stacked leaf one layer at a
time, as ``forward_with_cache``'s layer loop indexes it, and ``lm_head``
when the logits read it.  The products stay ``torch.matmul`` on the
dequantised layer.

Under tensor parallelism each rank quantises its own shards, after
sharding.  A channel's scale is taken over the contraction axis, and for
``wo`` and ``w_down`` that axis is the one split over ``(tp, tpr)``: a
rank's local maximum would give each rank its own scale, another function.
So their per-channel maxima are all-reduced with MAX over the axes that
split the contraction first, as the JAX package's max over a sharded axis
is global.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

# Leaves quantised, by name; everything else (norms, embed) is untouched.
_QUANT_LEAVES = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head",
})


def _quantize_leaf(w: torch.Tensor, reduce_amax: Optional[Callable] = None
                   ) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8, scaled over the contraction axis
    only (``w.ndim - 2`` in the ``x @ w`` layout): a leaf stacked over
    layers keeps one scale row per layer.  A stacked leaf is quantised one
    layer at a time (the same numbers: the reduction never crosses the
    stack axis), so the float32 temporaries are one layer's.
    ``reduce_amax``: the maxima's all-reduce over the ranks that split the
    contraction axis, where a tp layout does."""
    if w.ndim > 2:
        parts = [_quantize_leaf(w[i], reduce_amax) for i in range(w.shape[0])]
        return {k: torch.stack([p[k] for p in parts]) for k in ("q8", "s8")}
    wf = w.float()
    amax = wf.abs().amax(dim=w.ndim - 2, keepdim=True)
    if reduce_amax is not None:
        amax = reduce_amax(amax)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q8": q, "s8": scale}


def _is_quant_leaf(obj: Any) -> bool:
    return isinstance(obj, dict) and set(obj) == {"q8", "s8"}


def _amax_reducer(layout, axes, w: torch.Tensor) -> Optional[Callable]:
    """The all-reduce (MAX) of a leaf's per-channel maxima over the layout
    axes that split its contraction axis (``w.ndim - 2``), or None."""
    if layout is None:
        return None
    split = layout.leaf_dims(axes).get(w.ndim - 2)
    if not split:
        return None
    return lambda amax: layout.all_reduce(amax, split, op=dist.ReduceOp.MAX)


def quantize_weights(params: Dict[str, Any], donate: bool = False,
                     layout=None, axes: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The params tree with matmul weights replaced by {"q8": int8, "s8":
    float32 per-channel} pairs, quantised leaf by leaf.  With ``donate``
    the caller hands the tree over: each bf16 leaf is removed from its
    dict once quantised, so it is freed as soon as nothing else holds it
    (the peak is then the int8 tree plus one leaf, not both trees).  A tp
    rank passes its serving ``layout`` and the model's logical ``axes``
    (``param_axes``) with its shards: leaves whose contraction axis is
    split take their maxima over every rank that splits it."""
    def walk(node, ax):
        if not isinstance(node, dict):
            return node
        out = {}
        for k in list(node):
            v = node[k]
            sub = ax[k] if ax is not None else None
            if k in _QUANT_LEAVES and not isinstance(v, dict):
                out[k] = _quantize_leaf(v, _amax_reducer(layout, sub, v))
                if donate:
                    del node[k]
                    del v
            else:
                out[k] = walk(v, sub)
        return out
    if layout is not None and axes is None:
        raise ValueError("quantize_weights under a layout needs the "
                         "params' logical axes")
    return walk(params, axes)


def _dequant(leaf: Dict[str, torch.Tensor], dtype=torch.bfloat16,
             out_dtype=None) -> torch.Tensor:
    """``q8 * s8``, both in ``dtype``, as the reference computes it (int8
    times a ``dtype`` tensor promotes to ``dtype``: one rounding of the
    exact product), then cast to ``out_dtype`` where given."""
    w = leaf["q8"] * leaf["s8"].to(dtype)
    return w if out_dtype in (None, dtype) else w.to(out_dtype)


def dequantize_weights(params: Dict[str, Any],
                       dtype=torch.bfloat16) -> Dict[str, Any]:
    """The inverse transform over the whole tree (tests and diagnostics;
    the serving forwards dequantise a layer at a time instead)."""
    def walk(node):
        if _is_quant_leaf(node):
            return _dequant(node, dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(params)


class _StackedLeaf:
    """A quantised leaf stacked over layers; ``[i]`` dequantises layer i
    (in bf16, cast to ``dtype``)."""

    __slots__ = ("leaf", "dtype")

    def __init__(self, leaf, dtype):
        self.leaf, self.dtype = leaf, dtype

    def __getitem__(self, i) -> torch.Tensor:
        return _dequant({k: v[i] for k, v in self.leaf.items()},
                        out_dtype=self.dtype)


class DequantView(Mapping):
    """A read-only view of a quantised params tree that dequantises on
    access, in bf16 as the reference's forward does, then cast to
    ``dtype`` (the model's): a top-level quantised leaf (``lm_head``)
    whole, the leaves of a nested dict (the stacked ``layers``) one layer
    per index."""

    def __init__(self, params: Dict[str, Any], dtype):
        self._params, self._dtype = params, dtype

    def __getitem__(self, key):
        v = self._params[key]
        if _is_quant_leaf(v):
            return _dequant(v, out_dtype=self._dtype)
        if isinstance(v, dict):
            return {k: _StackedLeaf(x, self._dtype) if _is_quant_leaf(x)
                    else x for k, x in v.items()}
        return v

    def __iter__(self):
        return iter(self._params)

    def __len__(self) -> int:
        return len(self._params)


def make_weight_dequant_forward(base_forward):
    """Forward adapter with the ``(cfg, params, ...)`` head shared by
    ``forward_with_cache``, the int8-cache wrapper and the paged forwards:
    it hands ``base_forward`` a ``DequantView`` of the quantised tree, in
    the model's dtype, so it runs outermost over any of them."""
    def fwd(cfg, params, *args, **kwargs):
        return base_forward(cfg, DequantView(params, cfg.dtype), *args,
                            **kwargs)
    return fwd


def quantization_error(params: Dict[str, Any]) -> float:
    """Max relative round-trip error over the quantised leaves (the
    largest error over the leaf's largest |value|); per-channel int8 sits
    near 1/254 of a channel's amplitude."""
    q = quantize_weights(params)
    d = dequantize_weights(q, dtype=torch.float32)
    worst = 0.0

    def walk(orig, deq):
        nonlocal worst
        if isinstance(orig, dict):
            for k, v in orig.items():
                walk(v, deq[k])
            return
        if orig.shape != deq.shape:
            return
        o = orig.float()
        amax = o.abs().max().item()
        if amax == 0:
            return
        worst = max(worst, (o - deq.float()).abs().max().item() / amax)

    walk(params, d)
    return worst
