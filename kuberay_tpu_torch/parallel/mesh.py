"""Device meshes for sequence parallelism, and the ring they give.

Port of ``kuberay_tpu/parallel/mesh.py``'s ``MeshSpec`` (axis names and
``resolve``, copied).  ``MeshSpec.build`` maps onto
``torch.distributed.device_mesh.init_device_mesh`` over the default process
group; only the ``sp`` axis may be larger than 1 here (FSDP and tensor
parallel placements are ROADMAP C5).

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
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

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
        _only_sp(sizes)
        if device_type == "cuda":
            resolve_device("cuda")
        return init_device_mesh(device_type,
                                tuple(sizes[a] for a in self.AXES),
                                mesh_dim_names=self.AXES)


def _only_sp(sizes: Dict[str, int]) -> None:
    big = {a: s for a, s in sizes.items() if a != "sp" and s > 1}
    if big:
        raise NotImplementedError(
            f"mesh axes {big}: only the sp axis may be larger than 1 here; "
            f"FSDP, tensor, data and expert parallel layouts are ROADMAP C5")


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
    """The sp axis of a ``DeviceMesh``: this process is one rank and holds
    one shard."""

    def __init__(self, mesh: DeviceMesh, axis_name: str = "sp"):
        names = mesh.mesh_dim_names or ()
        if axis_name not in names:
            raise ValueError(f"mesh axes {names} have no {axis_name!r}")
        dim = names.index(axis_name)
        self.n = mesh.size(mesh_dim=dim)
        _only_sp({**{a: mesh.size(mesh_dim=i) for i, a in enumerate(names)
                     if a != axis_name}, "sp": self.n})
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
