"""Tensor-parallel serving: the serving mesh and where each leaf lives.

Port of ``kuberay_tpu/serve/sharding.py``.  The port runs one process per
card, so tensor parallelism is always a group of processes
(``serve/multihost.py`` keeps them in lockstep), and the serving mesh is a
2-axis ``DeviceMesh`` ``("tp", "tpr")`` over the process group, ranks in
row-major ``(kv, rep)`` order:

- ``tp``, the kv-head axis: q heads, kv heads, mlp width and vocabulary
  split here, and the KV cache splits its kv-head axis;
- ``tpr``, kv replication: where the parallelism exceeds the model's kv
  heads (``llama3_8b`` has 8, a slice may have 16 cards) the extra factor
  goes here.  q heads, mlp and vocabulary split over ``(tp, tpr)``
  jointly, ``tp`` the major block; the KV cache is replicated across
  ``tpr``.  With tp <= n_kv_heads, tpr is 1.

A leaf's logical axes (``models/*.param_axes``) go through
``SERVE_RULES`` to this rank's block of it (``parallel/spmd.py``'s
``Layout`` and ``LeafSpec``; one ``LeafSpec`` a leaf where the JAX package
has a ``NamedSharding``).  Every process holds plain local tensors, and
the serving forward (``serve/kv_cache.py::forward_with_cache`` under a
``layout``) calls the collectives itself: a vocab-parallel embedding
lookup, one all-reduce after ``wo`` and one after ``w_down`` a layer, and
the logits gathered over ``(tp, tpr)`` before sampling.

GQA grouping survives the split: q heads split over (tp, tpr) in
contiguous blocks, so the rank at mesh coordinate (i, j) holds q heads
whose kv head block is i, the block its ``wk``/``wv`` and cache hold.

The JAX module's ``make_tp_attention``, ``make_tp_attention_quant`` and
``make_tp_paged_attention`` wrap attention in ``shard_map`` because the
SPMD partitioner cannot see into a Pallas kernel.  They have no
counterpart here: a rank's forward already sees only its local heads, so
the stock attention and the decode kernels run on them unchanged, with no
collective inside.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from kuberay_tpu_torch.models import llama, mixtral
from kuberay_tpu_torch.parallel.mesh import _device_mesh
from kuberay_tpu_torch.parallel.spmd import Layout, LeafSpec

# Serving logical -> mesh rules (copied).  No fsdp, sp or ep axes: embed,
# batch, seq and expert replicate; the head and width axes split over the
# joint (tp, tpr) parallelism except kv heads, which split over tp only.
SERVE_RULES: Dict[str, object] = {
    "batch": None,
    "seq": None,
    "embed": None,
    "heads": ("tp", "tpr"),
    "kv_heads": "tp",
    "mlp": ("tp", "tpr"),
    "vocab": ("tp", "tpr"),
    "layers": None,
    "expert": None,
    "head_dim": None,
    "norm": None,
}

# The serving mesh's axes, in mesh order.
SERVE_AXES = ("tp", "tpr")

# A serving mesh, this rank's layout on it, or (for checks made before a
# group exists) its axis sizes, {"tp": kv, "tpr": rep}.
MeshLike = Union[DeviceMesh, Layout, Mapping]


def tp_factors(tp: int, n_kv_heads: Optional[int] = None) -> tuple:
    """Split total parallelism into (kv-shard factor, kv-replica factor)."""
    if n_kv_heads is None or tp <= n_kv_heads:
        return tp, 1
    if tp % n_kv_heads:
        raise ValueError(
            f"tp={tp} exceeds n_kv_heads={n_kv_heads} but is not a "
            f"multiple of it")
    return n_kv_heads, tp // n_kv_heads


def serve_mesh(tp: int, n_kv_heads: Optional[int] = None,
               device_type: str = "cuda") -> DeviceMesh:
    """The serving mesh over the first ``tp`` processes of the default
    group (one card each): axes ("tp", "tpr"), ranks row-major.

    Pass the model's ``n_kv_heads`` so tp > n_kv_heads lands the excess
    on the kv-replication axis; without it, tp must divide the model's kv
    heads (``validate_tp`` enforces this at engine construction)."""
    have = dist.get_world_size()
    if have < tp:
        raise ValueError(f"tp={tp} needs {tp} devices, have {have}")
    kv, rep = tp_factors(tp, n_kv_heads)
    return _device_mesh(device_type, torch.arange(tp).reshape(kv, rep),
                        SERVE_AXES)


def serve_layout(mesh: MeshLike) -> Layout:
    """This process's ``Layout`` on a serving mesh, under ``SERVE_RULES``
    (made once and kept on the mesh); a ``Layout`` is returned as is."""
    if isinstance(mesh, Layout):
        return mesh
    lay = getattr(mesh, "_serve_layout", None)
    if lay is None:
        lay = mesh._serve_layout = Layout(mesh, SERVE_RULES)
    return lay


def _size(mesh: MeshLike, axis: str) -> int:
    if isinstance(mesh, Mapping):
        return mesh.get(axis, 1)
    return serve_layout(mesh).size(axis)


def mesh_tp(mesh: MeshLike) -> int:
    """Total tensor parallelism of a serving mesh."""
    return _size(mesh, "tp") * _size(mesh, "tpr")


def validate_tp(cfg, mesh: MeshLike) -> None:
    """Serving TP needs even splits (whole heads, mlp columns and
    vocabulary rows a rank; GQA groups must not straddle ranks)."""
    tp = mesh_tp(mesh)
    kv = _size(mesh, "tp")
    problems = []
    if cfg.n_kv_heads % kv:
        problems.append(f"n_kv_heads={cfg.n_kv_heads} by kv axis {kv}")
    if cfg.n_heads % tp:
        problems.append(f"n_heads={cfg.n_heads}")
    if cfg.d_ff % tp:
        problems.append(f"d_ff={cfg.d_ff}")
    if cfg.vocab_size % tp:
        problems.append(f"vocab_size={cfg.vocab_size}")
    if problems:
        raise ValueError(
            f"tp={tp} does not divide {', '.join(problems)}; choose a tp "
            f"that divides heads/d_ff/vocab (build the mesh with "
            f"serve_mesh(tp, n_kv_heads=...) so kv replication absorbs "
            f"tp > n_kv_heads)")


def _model(cfg):
    return mixtral if isinstance(cfg, mixtral.MixtralConfig) else llama


def param_axes_of(cfg) -> Dict[str, Any]:
    """The logical axes of the config's model family's params tree."""
    return _model(cfg).param_axes(cfg)


def _specs(axes_tree, layout: Layout):
    if isinstance(axes_tree, dict):
        return {k: _specs(v, layout) for k, v in axes_tree.items()}
    return LeafSpec(layout, tuple(axes_tree))


def param_shardings(cfg, mesh: MeshLike) -> Dict[str, Any]:
    """The params tree's ``LeafSpec``s on the serving mesh."""
    return _specs(param_axes_of(cfg), serve_layout(mesh))


def cache_shardings(cfg, mesh: MeshLike, quant: str = "none"
                    ) -> Dict[str, Any]:
    """``LeafSpec``s of the ``init_kv_cache`` layout: kv heads on ``tp``
    (replicated across ``tpr``).  bf16: k/v are [L, slots, max_len, Hkv,
    D]; int8 adds per-(slot, head, position) scales [L, slots, Hkv,
    max_len]."""
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    if quant == "int8":
        leaf = {"q": kv, "s": ("layers", "batch", "kv_heads", "seq")}
        return _specs({"k": leaf, "v": leaf}, serve_layout(mesh))
    return _specs({"k": kv, "v": kv}, serve_layout(mesh))


def paged_cache_shardings(mesh: MeshLike, quant: str = "none"
                          ) -> Dict[str, Any]:
    """``LeafSpec``s of the paged pool [L, Hkv, P, D]
    (``paged_kv.init_paged_cache``): kv heads on tp, replicated on tpr;
    int8 adds per-(head, position) scale pools [L, Hkv, P].  The block
    tables are replicated: the pool's position axis is unsplit, so every
    table is valid on every rank."""
    kv = ("layers", "kv_heads", "seq", "head_dim")
    if quant == "int8":
        leaf = {"q": kv, "s": ("layers", "kv_heads", "seq")}
        return _specs({"k": leaf, "v": leaf}, serve_layout(mesh))
    return _specs({"k": kv, "v": kv}, serve_layout(mesh))


def local_kv_heads(cfg, mesh: Optional[MeshLike]) -> int:
    """The kv heads of this rank's cache (all of them without a mesh)."""
    return cfg.n_kv_heads if mesh is None else \
        cfg.n_kv_heads // _size(mesh, "tp")


def _map(fn, tree, specs, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k], path + (k,)) for k, v in
                tree.items()}
    return fn(path, tree, specs)


def shard_params(cfg, full: Dict[str, Any], mesh: MeshLike
                 ) -> Dict[str, Any]:
    """This rank's shards of a whole params tree."""
    return _map(lambda path, t, spec: spec.shard(t), full,
                param_shardings(cfg, mesh))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def init_sharded_params(cfg, seed: int, mesh: MeshLike) -> Dict[str, Any]:
    """Seeded params drawn straight into this rank's shards, on the
    layout's device: ``init_params(cfg, torch.Generator(device)
    .manual_seed(seed))`` sliced to the rank's shard.  Each leaf is drawn
    whole in ``init_params``' order, its shard kept (a copy) and the rest
    freed, so the peak is one whole leaf (the JAX package jits the init
    with sharded outputs instead).  Real deployments restore a checkpoint
    (``train/checkpoint.py::load_params_for_serving`` takes the same
    shardings)."""
    lay = serve_layout(mesh)
    specs = param_shardings(cfg, lay)

    def keep(path, t):
        local = _at(specs, path).shard(t)
        # A block of the leading dim is a view of the whole leaf: copy it,
        # so that the rest is freed.
        if local.numel() < t.numel() and local.untyped_storage().data_ptr() \
                == t.untyped_storage().data_ptr():
            local = local.clone()
        return local

    gen = torch.Generator(device=lay.device).manual_seed(seed)
    return _model(cfg).init_params(cfg, gen, lay.device, keep=keep)


def check_local_params(cfg, params: Dict[str, Any], mesh: MeshLike) -> None:
    """Raise unless every leaf of ``params`` has the shape of this rank's
    shard (an engine under a layout takes shards, never the whole
    tree)."""
    specs = param_shardings(cfg, mesh)
    full = _model(cfg).init_params(cfg, device="meta")

    def check(path, t, spec):
        want = spec.chunk(_at(full, path).shape)[1]
        if tuple(t.shape) != want:
            raise ValueError(
                f"params leaf {'/'.join(path)} has shape {tuple(t.shape)}, "
                f"this rank's shard is {want}: pass the rank's shards "
                f"(serve/sharding.py::shard_params, init_sharded_params)")
    _map(check, params, specs)
