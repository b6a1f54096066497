"""The collectives of a multi-axis mesh, written out.

In the JAX package a leaf's logical axes (``models/llama.py::param_axes``)
go through ``DEFAULT_RULES`` to a ``NamedSharding``, and GSPMD inserts the
collectives.  Here every process holds plain local tensors (its shard of
each leaf) and the model calls the collectives itself, through the
autograd-correct functions below, over the sub-groups of a ``DeviceMesh``
built by ``MeshSpec``:

- **fsdp** (ZeRO-3): a leaf split along ``embed`` is gathered before use
  (``Layout.use``); the gather's backward is a reduce-scatter, so each
  rank ends with its shard of the gradient summed over fsdp.
- **tp** (Megatron): ``wq``/``wk``/``wv``/``w_gate``/``w_up`` are split by
  output column (each rank its own heads or mlp slice),
  ``wo``/``w_down`` by input row; ``copy_to`` (identity forward,
  all-reduce backward) stands at the input of a column-parallel block and
  ``reduce_over`` (all-reduce forward, identity backward) sums a
  row-parallel output.  The vocabulary splits over tp too: a masked local
  embedding lookup summed over tp, and a vocab-parallel cross entropy
  whose max, sum of exponentials and target logit are reduced over tp
  (``vocab_xent``).
- **ep**: a Mixtral expert leaf is split by expert; the tokens are the
  same on every ep rank (the batch splits over dp and fsdp only), the
  router logits are gathered over ep before top-k (``gather_over``, whose
  backward takes this rank's slice: every ep rank holds the whole
  gradient), each rank runs its own experts and the combine sums over ep.
- **dp, fsdp, sp** split the batch (rows over the flattened dp x fsdp
  index, dp-major, as JAX's ``P(("dp", "fsdp"))``; the sequence over sp),
  so each rank's loss is its share of the global mean (every sum divided
  by the global token count) and ``grad_sync`` sums the gradients over
  them (over fsdp only for leaves that are not split along it: those got
  their sum from the reduce-scatter).
- ``global_norm`` counts a leaf replicated over tp or ep once.

When the mesh is on CUDA and its groups run gloo (the launcher's
``--dist-backend gloo`` on the card, which lets two ranks share one card:
NCCL refuses that), every collective here goes through pinned host buffers
(``HostStagedGloo``); ``Layout.host_staged`` says so.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from kuberay_tpu_torch.parallel.mesh import (
    DEFAULT_RULES,
    logical_to_sharding,
    mesh_sizes,
)

class HostStagedGloo:
    """gloo collectives on CUDA tensors through pinned host buffers: copy
    to the host, run the collective on the host copy, copy the result
    back.  Used only by a layout on CUDA whose groups run gloo."""

    name = "HostStagedGloo"

    @staticmethod
    def run(fn: Callable[[torch.Tensor], torch.Tensor],
            t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return fn(host).to(t.device)


class Layout:
    """This process's place on a named ``DeviceMesh`` (``MeshSpec``'s
    training mesh, or ``serve/sharding.py::serve_mesh``'s ("tp", "tpr")):
    the axis sizes, its coordinate on each axis, each axis's process group
    and the collectives over them.  ``rules`` maps a leaf's logical axes to
    mesh axes (``DEFAULT_RULES``, or the serving rules)."""

    def __init__(self, mesh: DeviceMesh, rules: Optional[Dict] = None):
        self.mesh = mesh
        self.rules = DEFAULT_RULES if rules is None else rules
        self.names = tuple(mesh.mesh_dim_names or ())
        self.sizes = mesh_sizes(mesh)
        self.coord = {a: mesh.get_local_rank(a) for a in self.sizes}
        self.groups = {a: mesh.get_group(a)
                       for a, n in self.sizes.items() if n > 1}
        backends = {dist.get_backend(g) for g in self.groups.values()}
        self.nccl = "nccl" in backends
        # gloo takes no CUDA tensors: stage them through the host.
        self.host_staged = mesh.device_type == "cuda" and "gloo" in backends
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda"
                       else torch.device(mesh.device_type))

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coord.get(axis, 0)

    # -- collectives (plain; no autograd) ---------------------------------

    def _run(self, fn, t: torch.Tensor) -> torch.Tensor:
        if self.host_staged and t.is_cuda:
            return HostStagedGloo.run(fn, t)
        return fn(t)

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str],
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over ``axes`` (in place)."""
        for a in axes:
            if self.size(a) > 1:
                def fn(x, g=self.groups[a]):
                    dist.all_reduce(x, op=op, group=g)
                    return x
                out = self._run(fn, t)
                if out is not t:
                    t.copy_(out)
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The shards of every rank on ``axis``, joined along ``dim``."""
        n = self.size(axis)
        if n == 1:
            return t

        def fn(x):
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=self.groups[axis])
            return torch.cat(parts, dim)
        return self._run(fn, t)

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """This rank's slice along ``dim`` of ``t`` summed over ``axis``.
        NCCL reduce-scatters; gloo all-reduces and keeps the slice."""
        n = self.size(axis)
        if n == 1:
            return t
        g, i = self.groups[axis], self.index(axis)
        if self.nccl:
            x = t.movedim(dim, 0).contiguous()
            out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
            dist.reduce_scatter_tensor(out, x, group=g)
            return out.movedim(0, dim)

        def fn(x):
            x = x.clone()
            dist.all_reduce(x, group=g)
            return x.chunk(n, dim)[i].contiguous()
        return self._run(fn, t)

    # -- the batch --------------------------------------------------------

    @property
    def batch_shards(self) -> int:
        return self.size("dp") * self.size("fsdp")

    @property
    def batch_index(self) -> int:
        """This rank's row block: the flattened (dp, fsdp) index,
        dp-major."""
        return self.index("dp") * self.size("fsdp") + self.index("fsdp")

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global [B, ...] tensor."""
        n, B = self.batch_shards, t.shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split over dp x fsdp = "
                             f"{n} ranks")
        b = B // n
        return t[self.batch_index * b:(self.batch_index + 1) * b]

    def local_batch(self, batch: Dict[str, torch.Tensor], rows: bool = True
                    ) -> Dict[str, torch.Tensor]:
        """This rank's part of a global [B, S] batch: its rows (unless
        ``rows`` is False: the batch holds them already), and its sequence
        shard when sp > 1."""
        out = {}
        for k, t in batch.items():
            if rows:
                t = self.local_rows(t)
            n = self.size("sp")
            if n > 1:
                S = t.shape[1]
                if S % n:
                    raise ValueError(f"sequence {S} does not split into "
                                     f"{n} equal sp shards")
                s = S // n
                i = self.index("sp")
                t = t[:, i * s:(i + 1) * s]
            out[k] = t.contiguous()
        return out

    def sum_batch(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` summed over the axes that split the batch (dp,
        fsdp, sp); no gradient."""
        return self.all_reduce(t.detach().clone(), ("dp", "fsdp", "sp"))

    # -- leaves -----------------------------------------------------------

    def leaf_dims(self, logical_axes) -> Dict[int, List[str]]:
        """{tensor dim: the mesh axes (size > 1, mesh order) it is split
        over} for a leaf with these logical axes."""
        names = self.names
        out = {}
        for dim, logical in enumerate(logical_axes):
            spec = self.rules.get(logical)
            axes = [a for a in ((spec,) if isinstance(spec, str)
                                else spec or ()) if self.size(a) > 1]
            if axes:
                out[dim] = sorted(axes, key=names.index)
        return out

    def _block(self, axes: Sequence[str]) -> Tuple[int, int]:
        """(index, count) of this rank's block of a dim split over
        ``axes``, the first axis the most significant."""
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * self.size(a) + self.index(a), n * self.size(a)
        return idx, n

    def chunk(self, global_shape, logical_axes
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(offsets, sizes) of this rank's shard in the global leaf."""
        offsets, sizes = [0] * len(global_shape), list(global_shape)
        for dim, axes in self.leaf_dims(logical_axes).items():
            idx, n = self._block(axes)
            if global_shape[dim] % n:
                raise ValueError(
                    f"dimension {dim} ({logical_axes[dim]!r}) of size "
                    f"{global_shape[dim]} does not split over {axes} "
                    f"({n} ranks)")
            sizes[dim] = global_shape[dim] // n
            offsets[dim] = idx * sizes[dim]
        return tuple(offsets), tuple(sizes)

    def shard(self, full: torch.Tensor, logical_axes) -> torch.Tensor:
        """This rank's shard of a global leaf (a contiguous copy)."""
        offsets, sizes = self.chunk(full.shape, logical_axes)
        out = full
        for dim, (o, s) in enumerate(zip(offsets, sizes)):
            if s != full.shape[dim]:
                out = out.narrow(dim, o, s)
        return out.contiguous()

    def gather(self, local: torch.Tensor, logical_axes) -> torch.Tensor:
        """The global leaf from every rank's shard (no gradient)."""
        out = local.detach()
        for dim, axes in self.leaf_dims(logical_axes).items():
            for a in reversed(axes):        # innermost axis first
                out = self.all_gather(out, a, dim)
        return out

    def use(self, local: torch.Tensor, logical_axes) -> torch.Tensor:
        """The leaf as a layer uses it: gathered along its fsdp-split dim
        (a differentiable gather whose backward reduce-scatters); dims
        split over tp or ep stay local."""
        for dim, axes in self.leaf_dims(logical_axes).items():
            if "fsdp" in axes:
                if axes != ["fsdp"]:
                    raise ValueError(f"dim {dim} split over {axes}: only "
                                     f"fsdp alone is gathered before use")
                local = _Gather.apply(local, self, "fsdp", dim, "sum")
        return local

    def grad_sync(self, grads, axes_tree):
        """Gradients summed over the batch's axes: dp and sp always, fsdp
        where the leaf is not split along it (the gather's reduce-scatter
        already summed those)."""
        def leaf(g, axes):
            split = {a for v in self.leaf_dims(axes).values() for a in v}
            over = [a for a in ("dp", "fsdp", "sp")
                    if self.size(a) > 1 and a not in split]
            return self.all_reduce(g, over) if over else g
        return _tree_map2(leaf, grads, axes_tree)

    def global_norm(self, tree, axes_tree) -> torch.Tensor:
        """sqrt of the sum of squares of the global leaves, in f32: each
        shard's squares summed over the axes its leaf is split over, a
        replicated leaf counted once."""
        by_split: Dict[Tuple[str, ...], torch.Tensor] = {}
        for g, axes in _pairs(tree, axes_tree):
            split = tuple(sorted({a for v in self.leaf_dims(axes).values()
                                  for a in v}))
            sq = torch.sum(torch.square(g.float()))
            by_split[split] = sq if split not in by_split \
                else by_split[split] + sq
        total = 0.0
        for split in sorted(by_split):
            total = total + self.all_reduce(by_split[split], split)
        return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Where a leaf lives on a layout: its logical axes, its DTensor
    placements, and this rank's chunk of it."""

    layout: Layout
    axes: Tuple

    @property
    def placements(self) -> Tuple:
        return logical_to_sharding(self.layout.rules, self.layout.mesh,
                                   self.axes)

    def chunk(self, global_shape):
        """(offsets, sizes) of this rank's shard."""
        return self.layout.chunk(tuple(global_shape), self.axes)

    def global_shape(self, local_shape) -> Tuple[int, ...]:
        shape = list(local_shape)
        for dim, axes in self.layout.leaf_dims(self.axes).items():
            shape[dim] *= math.prod(self.layout.size(a) for a in axes)
        return tuple(shape)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        return self.layout.shard(full, self.axes)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        return self.layout.gather(local, self.axes)


def check_divisible(cfg, layout: Layout) -> None:
    """The port splits whole heads, experts and vocabulary rows: a tp that
    does not divide the heads (or an fsdp that does not divide d_model,
    ...) is refused with the dimension's name.  (JAX's GSPMD would split a
    head's columns and still compute; ROADMAP §C.)"""
    need = [("n_heads", cfg.n_heads, "tp"),
            ("n_kv_heads", cfg.n_kv_heads, "tp"),
            ("d_ff", cfg.d_ff, "tp"), ("vocab_size", cfg.vocab_size, "tp"),
            ("d_model", cfg.d_model, "fsdp")]
    if hasattr(cfg, "n_experts"):
        need.append(("n_experts", cfg.n_experts, "ep"))
    for name, value, axis in need:
        n = layout.size(axis)
        if value % n:
            raise ValueError(f"{name} = {value} does not split over "
                             f"{axis} = {n}")


# --------------------------------------------------------------------------
# Autograd-correct collectives
# --------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axis``.  Backward ``"sum"``:
    reduce-scatter (each rank used the whole tensor with its own data, as
    fsdp does); ``"split"``: this rank's slice (every rank holds the same
    whole gradient, as after a replicated computation)."""

    @staticmethod
    def forward(ctx, x, layout, axis, dim, back):
        ctx.layout, ctx.axis, ctx.dim, ctx.back = layout, axis, dim, back
        return layout.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        lay, axis, dim = ctx.layout, ctx.axis, ctx.dim
        if ctx.back == "sum":
            return lay.reduce_scatter(g, axis, dim), None, None, None, None
        n = lay.size(axis)
        return (g.chunk(n, dim)[lay.index(axis)].contiguous(), None, None,
                None, None)


class _Reduce(torch.autograd.Function):
    """Sum over ``axes`` forward; identity backward (the sum's value is
    replicated, and every rank holds its whole gradient)."""

    @staticmethod
    def forward(ctx, x, layout, axes):
        return layout.all_reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    """Identity forward; sum over ``axes`` backward: a replicated value
    that each rank then uses with its own shard of a weight."""

    @staticmethod
    def forward(ctx, x, layout, axes):
        ctx.layout, ctx.axes = layout, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.all_reduce(g.contiguous().clone(), ctx.axes), \
            None, None


def _live(layout: Optional[Layout], axes) -> Tuple[str, ...]:
    if layout is None:
        return ()
    return tuple(a for a in axes if layout.size(a) > 1)


def copy_to(x: torch.Tensor, layout: Optional[Layout], *axes: str
            ) -> torch.Tensor:
    """Megatron's ``f`` over ``axes``: identity, all-reduce backward."""
    live = _live(layout, axes)
    return _Copy.apply(x, layout, live) if live else x


def reduce_over(x: torch.Tensor, layout: Optional[Layout], *axes: str
                ) -> torch.Tensor:
    """Megatron's ``g`` over ``axes``: all-reduce, identity backward."""
    live = _live(layout, axes)
    return _Reduce.apply(x, layout, live) if live else x


def gather_over(x: torch.Tensor, layout: Optional[Layout], axis: str,
                dim: int) -> torch.Tensor:
    """All-gather over ``axis`` of a value whose gradient every rank then
    holds whole; the backward keeps this rank's slice."""
    if layout is None or layout.size(axis) == 1:
        return x
    return _Gather.apply(x, layout, axis, dim, "split")


def global_argmax(vals: torch.Tensor, idx: torch.Tensor,
                  layout: Optional[Layout], axis: str = "tp"
                  ) -> torch.Tensor:
    """The argmax over ranks on ``axis`` of each row's local (max, index):
    the first rank with the largest value wins, so ties go to the lower
    global index, as a single argmax over the whole row."""
    if layout is None or layout.size(axis) == 1:
        return idx
    v = layout.all_gather(vals[None], axis, 0)                  # [n, T]
    i = layout.all_gather(idx[None], axis, 0)
    best = torch.argmax(v, dim=0)
    return i.gather(0, best[None])[0]


def vocab_xent(logits: torch.Tensor, targets: torch.Tensor,
               layout: Optional[Layout]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross entropy over a vocabulary split over tp: ``logits`` [..., V /
    tp] f32 (this rank's columns), ``targets`` global ids.  Returns (nll,
    logz, pred), each over the whole vocabulary and the same on every tp
    rank: the max, the sum of exponentials and the target logit are
    reduced over tp (the max without a gradient, as logsumexp's)."""
    Vl = logits.shape[-1]
    v0 = layout.index("tp") * Vl
    m = logits.detach().amax(-1)
    layout.all_reduce(m, ("tp",), op=dist.ReduceOp.MAX)
    se = reduce_over(torch.exp(logits - m[..., None]).sum(-1), layout, "tp")
    logz = m + torch.log(se)
    local = targets.long() - v0
    inside = (local >= 0) & (local < Vl)
    tl = logits.gather(-1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    tl = reduce_over(torch.where(inside, tl, 0.0), layout, "tp")
    lv, li = logits.detach().max(-1)
    pred = global_argmax(lv.reshape(-1), (li + v0).reshape(-1), layout
                         ).reshape(li.shape)
    return logz - tl, logz, pred


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 layout: Optional[Layout], *axes: str) -> torch.Tensor:
    """Rows of an embedding table whose vocabulary is split over ``axes``
    (default tp; the first axis the most significant block): each rank
    looks up the ids it holds (zeros elsewhere), summed over the axes."""
    live = _live(layout, axes or ("tp",))
    if not live:
        return table[tokens]
    Vl = table.shape[0]
    local = tokens.long() - layout._block(live)[0] * Vl
    inside = (local >= 0) & (local < Vl)
    rows = table[local.clamp(0, Vl - 1)]
    return reduce_over(torch.where(inside[..., None], rows, 0.0).to(
        table.dtype), layout, *live)


# --------------------------------------------------------------------------
# Trees
# --------------------------------------------------------------------------

def _pairs(tree, axes_tree) -> list:
    """(leaf, its logical axes) for every leaf, matched by key."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _pairs(tree[k], axes_tree[k])]
    return [(tree, axes_tree)]


def _tree_map2(fn, tree, axes_tree):
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, tree[k], axes_tree[k]) for k in tree}
    return fn(tree, axes_tree)


def global_numel(tree, axes_tree, layout: Optional[Layout]) -> int:
    """The global element count of a tree of shards."""
    pairs = _pairs(tree, axes_tree)
    if layout is None:
        return sum(t.numel() for t, _ in pairs)
    total = 0
    for t, axes in pairs:
        n = t.numel()
        for dim_axes in layout.leaf_dims(axes).values():
            n *= math.prod(layout.size(a) for a in dim_axes)
        total += n
    return total


def layout_of(mesh: Any) -> Optional[Layout]:
    """The ``Layout`` of a ``DeviceMesh`` (made once, and kept on the
    mesh), or None for anything else (a ``LocalRing``, no mesh)."""
    if not isinstance(mesh, DeviceMesh):
        return None
    lay = getattr(mesh, "_spmd_layout", None)
    if lay is None:
        lay = mesh._spmd_layout = Layout(mesh)
    return lay
