"""Device meshes, the logical-axis rules, and the sp ring they give.

Port of ``kuberay_tpu/parallel/mesh.py``: ``MeshSpec`` (axis names and
``resolve``, copied), ``build`` over the default process group (one
process a device, ranks in row-major order over ``AXES``, as the JAX mesh
lays its devices out), ``build_multislice`` (the cross-slice ``dcn_axes``
outermost, every other axis within a slice; ranks follow
``WorkerIdentity.global_process_id``, which is contiguous per slice), and
``DEFAULT_RULES`` with ``logical_to_sharding``, which here maps a leaf's
logical axes to DTensor placements, one per mesh dimension.  What the
placements mean for the forward and the gradients (the collectives GSPMD
inserts in the JAX package) is ``parallel/spmd.py``.

Axis names as in the JAX package: ``dp`` (data parallel), ``pp``
(pipeline stages, ``parallel/pipeline.py``), ``fsdp`` (parameters sharded
along ``embed``, gathered
before use), ``tp`` (tensor parallel: heads, mlp and vocabulary), ``sp``
(the sequence ring below) and ``ep`` (experts).

Two kinds of mesh carry the ``sp`` ring:

- a ``DeviceMesh`` from ``MeshSpec.build``: one process per sp rank, each
  holding its own sequence shard; neighbours exchange through
  ``torch.distributed`` point-to-point ops (NCCL on cards, gloo on the
  CPU), and a sum over sp is an all-reduce;
- ``LocalRing(sp=n)``: n sp ranks held by one device and one process.
  Tensors carry the whole sequence, the ring cuts it into n equal shards
  inside, the exchange is a copy between the shards' slots, and a sum over
  sp is the identity (every value is already global).

``ring_of(mesh)`` gives both the one interface the ring and the train step
read: the sp size ``n``, the ranks held here, the device, cutting a
sequence into per-rank shards and back, the shard offset, the neighbour
exchange (``rotate``) and the sum over sp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from kuberay_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape.  Axis size -1 means 'absorb remaining devices'."""

    dp: int = 1
    pp: int = 1
    fsdp: int = -1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    AXES = ("dp", "pp", "fsdp", "tp", "sp", "ep")

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in self.AXES}
        wildcard = [a for a, s in sizes.items() if s == -1]
        if len(wildcard) > 1:
            raise ValueError(f"at most one -1 axis, got {wildcard}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcard:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes

    def build(self, device_type: str = "cuda") -> DeviceMesh:
        """The mesh over every process of the default process group (one
        device each), with the axes named as in the JAX package."""
        sizes = self.resolve(dist.get_world_size())
        ranks = torch.arange(dist.get_world_size())
        return _device_mesh(device_type, ranks.reshape(
            [sizes[a] for a in self.AXES]), self.AXES)

    def build_multislice(self, num_slices: int,
                         dcn_axes: Sequence[str] = ("dp",),
                         device_type: str = "cuda") -> DeviceMesh:
        """The hybrid mesh of a multi-slice job: the ``dcn_axes`` (default:
        pure data parallelism) vary across slices, every other axis within
        one.  Slice i holds the ranks [i * per, (i + 1) * per), the order
        of ``WorkerIdentity.global_process_id``.  The dcn axes' sizes must
        multiply to ``num_slices``."""
        n = dist.get_world_size()
        sizes = self.resolve(n)
        for a in dcn_axes:
            if a not in self.AXES:
                raise ValueError(f"unknown dcn axis {a!r}")
        if num_slices < 1 or n % num_slices:
            raise ValueError(f"{n} processes do not divide into "
                             f"{num_slices} slices")
        dcn_size = math.prod(sizes[a] for a in dcn_axes)
        if dcn_size != num_slices:
            raise ValueError(
                f"dcn axes {tuple(dcn_axes)} have total size {dcn_size}, "
                f"but there are {num_slices} slices — the cross-slice "
                f"axes must exactly cover the slices")
        dcn = [a for a in self.AXES if a in dcn_axes]
        ici = [a for a in self.AXES if a not in dcn_axes]
        ranks = torch.arange(n).reshape([sizes[a] for a in dcn + ici])
        perm = [(dcn + ici).index(a) for a in self.AXES]
        return _device_mesh(device_type, ranks.permute(perm).contiguous(),
                            self.AXES)


def _device_mesh(device_type: str, ranks: torch.Tensor,
                 names: Tuple[str, ...]) -> DeviceMesh:
    if device_type == "cuda":
        resolve_device("cuda")
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def mesh_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: size} of a mesh built by ``MeshSpec``."""
    return {a: mesh.size(mesh_dim=i)
            for i, a in enumerate(mesh.mesh_dim_names or ())}


def logical_to_sharding(rules: Dict[str, object], mesh: DeviceMesh,
                        logical_axes) -> Tuple:
    """A leaf's logical axes -> its DTensor placements on ``mesh``, one per
    mesh dimension.  ``rules`` maps a logical axis to a mesh axis, a tuple
    of mesh axes (the tensor dimension split over them in mesh order, as a
    JAX ``PartitionSpec`` entry of several axes) or None; unknown logical
    names and mesh axes of size 1 replicate."""
    names = tuple(mesh.mesh_dim_names or ())
    placements = [Replicate()] * len(names)
    for dim, logical in enumerate(logical_axes):
        spec = rules.get(logical)
        for axis in ((spec,) if isinstance(spec, str) else spec or ()):
            i = names.index(axis)
            if mesh.size(mesh_dim=i) > 1:
                placements[i] = Shard(dim)
    return tuple(placements)


# Default logical->mesh rules for transformer params/activations (copied).
# Conventions: "embed" = d_model, "heads" = attention heads, "mlp" = d_ff,
# "vocab" = vocabulary, "layers" = stacked layer dim, "batch" = batch,
# "seq" = sequence.
DEFAULT_RULES: Dict[str, object] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",      # ZeRO-3: shard params along d_model over fsdp
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "vocab": "tp",
    "layers": None,
    "expert": "ep",
    "head_dim": None,
    "norm": None,
}


class LocalRing:
    """``sp`` ranks held by one device: the counterpart of the JAX tests'
    virtual CPU mesh, and how one card runs the ring."""

    def __init__(self, sp: int, device="cuda"):
        if sp < 1:
            raise ValueError(f"sp must be at least 1, got {sp}")
        self.n = sp
        self.ranks: Tuple[int, ...] = tuple(range(sp))
        # Checked where tensors are made (init_params), so that a missing
        # card raises there with the port's message.
        self.device = torch.device(device)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, ...] -> [n, B, S / n, ...] (contiguous)."""
        B, S = x.shape[:2]
        if S % self.n:
            raise ValueError(f"sequence {S} does not split into {self.n} "
                             f"equal sp shards")
        return x.reshape(B, self.n, S // self.n, *x.shape[2:]).transpose(
            0, 1).contiguous()

    def unshard(self, y: torch.Tensor) -> torch.Tensor:
        """[n, B, S / n, ...] -> [B, S, ...]."""
        n, B, Sl = y.shape[:3]
        return y.transpose(0, 1).reshape(B, n * Sl, *y.shape[3:])

    def local_seq(self, t: torch.Tensor) -> torch.Tensor:
        """This process's part of a global [B, S, ...] batch: all of it."""
        return t

    def seq_offset(self, s_local: int) -> int:
        return 0

    def rotate(self, x: torch.Tensor, out: Optional[torch.Tensor] = None,
               shift: int = 1) -> torch.Tensor:
        """out[r] = x[(r - shift) % n]: every rank sends its slot ``shift``
        ranks to the right."""
        out = torch.empty_like(x) if out is None else out
        s = shift % self.n
        if s == 0:
            return out.copy_(x)
        out[s:].copy_(x[:-s])
        out[:s].copy_(x[-s:])
        return out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t


class DeviceRing:
    """The sp axis of a ``DeviceMesh`` (whose other axes may be larger
    than 1): this process is one rank of its sp group and holds one
    shard."""

    def __init__(self, mesh: DeviceMesh, axis_name: str = "sp"):
        names = mesh.mesh_dim_names or ()
        if axis_name not in names:
            raise ValueError(f"mesh axes {names} have no {axis_name!r}")
        dim = names.index(axis_name)
        self.n = mesh.size(mesh_dim=dim)
        self.group = mesh.get_group(axis_name)
        self.rank = mesh.get_local_rank(axis_name)
        self.ranks: Tuple[int, ...] = (self.rank,)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda"
                       else torch.device(mesh.device_type))

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard [B, S_local, ...] -> [1, B, S_local, ...]."""
        return x.contiguous()[None]

    def unshard(self, y: torch.Tensor) -> torch.Tensor:
        return y[0]

    def local_seq(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's sequence shard of a global [B, S, ...] batch."""
        S = t.shape[1]
        if S % self.n:
            raise ValueError(f"sequence {S} does not split into {self.n} "
                             f"equal sp shards")
        sl = S // self.n
        return t[:, self.rank * sl:(self.rank + 1) * sl].contiguous()

    def seq_offset(self, s_local: int) -> int:
        return self.rank * s_local

    def _peer(self, shift: int) -> int:
        return dist.get_global_rank(self.group, (self.rank + shift) % self.n)

    def rotate(self, x: torch.Tensor, out: Optional[torch.Tensor] = None,
               shift: int = 1) -> torch.Tensor:
        """Send ``x`` to the rank ``shift`` to the right and receive the
        left one's into ``out``, both posted in one batch so that no rank
        waits for another's send."""
        out = torch.empty_like(x) if out is None else out
        if self.n == 1:
            return out.copy_(x)
        ops = [dist.P2POp(dist.isend, x.contiguous(), self._peer(shift),
                          self.group),
               dist.P2POp(dist.irecv, out, self._peer(-shift), self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) over sp, in place."""
        dist.all_reduce(t, group=self.group)
        return t


def ring_of(mesh, axis_name: str = "sp"):
    """The ring interface of a ``LocalRing`` (itself) or a ``DeviceMesh``."""
    if isinstance(mesh, LocalRing):
        return mesh
    if isinstance(mesh, DeviceMesh):
        return DeviceRing(mesh, axis_name)
    raise TypeError(f"expected a LocalRing or a DeviceMesh, got "
                    f"{type(mesh).__name__}")
