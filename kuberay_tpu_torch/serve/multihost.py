"""Tensor-parallel serving across processes: lockstep step plans.

Port of ``kuberay_tpu/serve/multihost.py``.  The port runs one process per
card (``train/launcher.py::initialize_distributed``, ``LOCAL_RANK``), so
tp > 1 is always a group of processes, each holding its shards of the
params and of the cache (``serve/sharding.py``).  The model's collectives
(``serve/kv_cache.py::forward_with_cache`` under a layout) pair up only if
**every rank runs the same device calls with the same operands in the same
order**.

Protocol (as JetStream and MaxText run multi-host serving):

- rank 0 runs the HTTP frontend and the real scheduling loop
  (``MultihostServeEngine``); before every device call it broadcasts a
  fixed-shape *step plan*, the op and its operands;
- every other rank runs ``follower_loop``: receive a plan, run the same
  device funnel (``ServeEngine._prefill_logits``, ``_decode_logits`` or
  ``_verify_logits``) on the same operands.  Followers hold params and
  cache or pool, and no request state.

The plan rides a gloo group of its own on the CPU (``dist.new_group(
backend="gloo")`` over the serving mesh's ranks), one int32 tensor whose
fields sit at fixed offsets (float32 fields by their bits), sized by the
engine's max_len, max_slots, gamma and table width at construction.  The
model's collectives ride the compute group: NCCL between cards, or gloo
through pinned host memory when the ranks share one card
(``parallel/spmd.py::HostStagedGloo``).

Only rank 0 samples: it holds the gathered logits (every rank gathers
them, so the collectives match), and the next tokens reach the followers
in the next plan.  So the RNG key the JAX plan carries is not needed here,
nor the sampling parameters.

A paged engine's block copies (the KV tiers' demotion and promotion,
``/v1/kv/export`` and ``/v1/kv/import``) are plans too.  Rank 0 alone
holds the tier store and decides which blocks move; its
``_read_blocks`` / ``_write_blocks`` broadcast ``OP_READ_BLOCKS`` or
``OP_WRITE_BLOCKS`` with the block ids (at most ``max_blocks`` a plan)
before touching its own pool:

- read: every rank with ``tpr`` index 0 copies its kv heads of the blocks
  to the host as float32 (a replica sends zeros: its heads are index 0's),
  and the plan group gathers them to rank 0, which joins them along the
  kv-head axis in mesh order: ``[L, Hkv, n * block_size, D]``, the bytes
  one process reads;
- write: rank 0 scatters each rank the head slice of its ``tp`` index
  (every replica the same) and each rank writes it into its pool.

The slices are ``[2, L, Hkv / tp, n * block_size, D]`` on every rank, so
gloo's equal-size gather and scatter hold.

A group of one broadcasts nothing: the same engine serves a one-rank
group unchanged.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kuberay_tpu_torch.serve.engine import ServeEngine
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine

OP_STOP, OP_PREFILL, OP_DECODE, OP_VERIFY = 0, 1, 2, 3
OP_READ_BLOCKS, OP_WRITE_BLOCKS = 4, 5

# A follower waits in the plan broadcast for as long as rank 0 is idle, so
# the plan group's timeout is long; a dead rank 0 closes its sockets and
# the broadcast fails at once.
PLAN_TIMEOUT = datetime.timedelta(days=7)


def _zero_plan(max_len: int, max_slots: int, gamma: int,
               max_blocks: int = 0) -> Dict[str, np.ndarray]:
    plan = {
        "op": np.zeros(1, np.int32),
        # slot, real_len, bucket, start_pos
        "scalars": np.zeros(4, np.int32),
        "tokens": np.zeros(max_len, np.int32),
        "last": np.zeros(max_slots, np.int32),
        "lens": np.zeros(max_slots, np.int32),
        "mask": np.zeros(max_slots, np.float32),
        "vtoks": np.zeros((max_slots, gamma + 1), np.int32),
        "ntok": np.zeros(max_slots, np.int32),
    }
    if max_blocks:
        # Paged engines: rank 0 owns the allocator; followers receive the
        # block tables with every plan, and a block plan's ids.
        plan["tables"] = np.zeros((max_slots, max_blocks), np.int32)
        plan["bids"] = np.zeros(max_blocks, np.int32)
        plan["nbids"] = np.zeros(1, np.int32)
    return plan


def _plan_shape(engine: ServeEngine) -> Dict[str, np.ndarray]:
    return _zero_plan(engine.max_len, engine.max_slots, engine.speculative,
                      getattr(engine, "max_blocks", 0))


def _pack(plan: Dict[str, np.ndarray]) -> torch.Tensor:
    """The plan's fields, in order, as one int32 vector (a float32 field
    by its bits)."""
    return torch.from_numpy(np.concatenate(
        [a.view(np.int32).ravel() for a in plan.values()]))


def _unpack(flat: torch.Tensor, like: Dict[str, np.ndarray]
            ) -> Dict[str, np.ndarray]:
    out, o, buf = {}, 0, flat.numpy()
    for k, a in like.items():
        out[k] = buf[o:o + a.size].view(a.dtype).reshape(a.shape)
        o += a.size
    return out


def mesh_ranks(layout) -> list:
    """The global ranks of a layout's mesh, in mesh order."""
    return [int(r) for r in layout.mesh.mesh.flatten()]


def plan_group(ranks):
    """The gloo group that carries the plans, over the serving mesh's
    ``ranks`` (the first the source).  A group's creation is collective
    over the default group: every process calls this once, at the same
    point of its start-up, a process outside the mesh too (where the mesh
    is not the whole group)."""
    return dist.new_group(ranks=list(ranks), backend="gloo",
                          timeout=PLAN_TIMEOUT)


def _broadcast(flat: torch.Tensor, group) -> torch.Tensor:
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    return flat


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _local_blocks_shape(engine, n: int) -> tuple:
    """``[2, L, Hkv_local, n * block_size, D]``: a rank's slice of ``n``
    blocks."""
    L, h, _, d = engine.cache["k"].shape
    return (2, L, h, n * engine.block_size, d)


def gather_blocks(engine, group, bids) -> Optional[np.ndarray]:
    """Every rank of the plan group, the same ``bids``: each rank's kv
    heads of the blocks go to rank 0, which returns float32 ``[2, L, Hkv,
    n * block_size, D]`` over every head (mesh order); the others
    return None."""
    lay = engine.layout
    if lay.index("tpr") == 0:
        local = engine._read_local(bids)
    else:                       # a replica: tpr index 0 holds the same
        local = torch.zeros(_local_blocks_shape(engine, len(bids)))
    src = dist.get_global_rank(group, 0)
    if dist.get_rank() != src:
        dist.gather(local, None, dst=src, group=group)
        return None
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    dist.gather(local, parts, dst=src, group=group)
    # Group rank j sits at mesh (j // tpr, j % tpr).
    return torch.cat(parts[::lay.size("tpr")], dim=2).numpy()


def scatter_blocks(engine, group, bids, kv: Optional[np.ndarray]) -> None:
    """Every rank of the plan group, the same ``bids``: rank 0 passes
    float32 ``[2, L, Hkv, n * block_size, D]``, each rank receives the kv
    heads of its ``tp`` index and writes them into its pool."""
    lay = engine.layout
    local = torch.empty(_local_blocks_shape(engine, len(bids)))
    src = dist.get_global_rank(group, 0)
    parts = None
    if dist.get_rank() == src:
        heads = torch.from_numpy(np.ascontiguousarray(kv)).chunk(
            lay.size("tp"), dim=2)
        parts = [heads[j // lay.size("tpr")].contiguous()
                 for j in range(dist.get_world_size(group))]
    dist.scatter(local, parts, src=src, group=group)
    engine._write_local(bids, local)


class MultihostServeEngine(ServeEngine):
    """Rank 0's engine: broadcasts a step plan before every device call.

    Construct with the same arguments as the followers' engines (the rank's
    shards and its ``layout``); it creates the plan group at the end of
    its constructor, the followers at the start of ``follower_loop``.
    Call :meth:`stop` when shutting down, after the engine loop's thread
    has ended, so followers leave their loop."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._plan0 = _plan_shape(self)
        self._group = plan_group(mesh_ranks(self.layout)) \
            if self.layout is not None else None
        self.monitor = None          # optional GroupMonitor (rank 0)
        self.group_failed = False    # set by the frontend on degradation
        self._compiled_ops: set = set()   # op keys already run once

    @property
    def _peers(self) -> bool:
        return self._group is not None and \
            dist.get_world_size(self._group) > 1

    def attach_monitor(self, monitor) -> None:
        """Step begin/end watchdog hooks (``serve/group_health.py``): a
        dead follower leaves every later collective hung; the monitor's
        watchdog turns that hang into a detected degradation."""
        self.monitor = monitor

    def _send(self, **updates) -> None:
        if not self._peers:
            return
        plan = dict(self._plan0)
        plan.update({k: np.asarray(v, self._plan0[k].dtype).reshape(
            self._plan0[k].shape) for k, v in updates.items()})
        if "tables" in plan:
            plan["tables"] = np.asarray(self.tables, np.int32)
        _broadcast(_pack(plan), self._group)

    def stop(self) -> None:
        """Broadcast STOP (followers return from their loop), unless the
        group is degraded: a broadcast into a dead group hangs or raises."""
        if self._peers and self._group_alive():
            self._send(op=OP_STOP)

    def _group_alive(self) -> bool:
        if self.group_failed:
            return False
        return self.monitor is None or self.monitor.degraded is None

    def _watched(self, op_key: Tuple, send_fn, device_fn):
        """Broadcast and device call under the step watchdog.  The window
        opens before the broadcast (a follower wedged mid-collective hangs
        rank 0 inside the broadcast itself) and closes after a device
        synchronise, so it measures the collectives, not the enqueue.  The
        first occurrence of an op key gets the compile budget (a first
        Triton or nvcc use)."""
        if self.monitor is not None:
            self.monitor.step_begin(
                compiling=op_key not in self._compiled_ops)
        try:
            send_fn()
            out = device_fn()
            _sync(self.device)
            self._compiled_ops.add(op_key)
            return out
        finally:
            if self.monitor is not None:
                self.monitor.step_end()

    def _prefill_logits(self, padded, slot, real_len, start_pos=0):
        bucket = len(padded)

        def send():
            tokens = np.zeros(self.max_len, np.int32)
            tokens[:bucket] = padded
            self._send(op=OP_PREFILL,
                       scalars=[slot, real_len, bucket, start_pos],
                       tokens=tokens)
        return self._watched(
            ("prefill", bucket), send,
            lambda: super(MultihostServeEngine, self)._prefill_logits(
                padded, slot, real_len, start_pos))

    def _decode_logits(self, last, mask):
        return self._watched(
            ("decode",),
            lambda: self._send(op=OP_DECODE, last=last, lens=self.lens,
                               mask=mask),
            lambda: super(MultihostServeEngine, self)._decode_logits(
                last, mask))

    def _verify_logits(self, toks, ntok, mask):
        return self._watched(
            ("verify",),
            lambda: self._send(op=OP_VERIFY, vtoks=toks, ntok=ntok,
                               lens=self.lens, mask=mask),
            lambda: super(MultihostServeEngine, self)._verify_logits(
                toks, ntok, mask))


def follower_loop(engine: ServeEngine) -> int:
    """Run on every rank but 0: replay rank 0's device calls until it
    broadcasts STOP; returns the number of calls replayed.

    ``engine`` is a plain ``ServeEngine`` or ``PagedServeEngine`` built
    with the same arguments as rank 0's ``MultihostServeEngine`` (the
    rank's shards of the same params, the same layout and options), so the
    shapes and the collectives match.  It creates the plan group first.
    A follower holds no tier store: rank 0 decides what moves, and a
    block plan names the blocks to copy."""
    group = plan_group(mesh_ranks(engine.layout))
    if getattr(engine, "tiers", None) is not None:
        engine.tiers = None
    plan0 = _plan_shape(engine)
    flat = _pack(plan0)
    steps = 0
    while True:
        plan = _unpack(_broadcast(flat, group), plan0)
        op = int(plan["op"][0])
        if op == OP_STOP:
            return steps
        steps += 1
        if "tables" in plan:
            engine.tables[:] = plan["tables"]
        if op in (OP_READ_BLOCKS, OP_WRITE_BLOCKS):
            bids = plan["bids"][:int(plan["nbids"][0])].tolist()
            if op == OP_READ_BLOCKS:
                gather_blocks(engine, group, bids)
            else:
                scatter_blocks(engine, group, bids, None)
            continue
        if op == OP_PREFILL:
            slot, real_len, bucket, start_pos = (int(x)
                                                 for x in plan["scalars"])
            engine._prefill_logits(plan["tokens"][:bucket].astype(np.int64),
                                   slot, real_len, start_pos)
        elif op == OP_DECODE:
            engine.lens[:] = plan["lens"]
            engine._decode_logits(plan["last"].astype(np.int64),
                                  plan["mask"].copy())
        elif op == OP_VERIFY:
            engine.lens[:] = plan["lens"]
            engine._verify_logits(plan["vtoks"].astype(np.int64),
                                  plan["ntok"].astype(np.int64),
                                  plan["mask"].copy())
        else:
            raise RuntimeError(f"unknown serve op {op}")


class MultihostPagedServeEngine(MultihostServeEngine, PagedServeEngine):
    """Rank 0's paged engine: ``MultihostServeEngine``'s broadcasts compose
    over ``PagedServeEngine`` through the shared device funnels (MRO:
    broadcast first, the paged forward second); the block tables ride
    every plan, so followers replay against rank 0's allocator without
    running one.  Block reads and writes (the KV tiers, export and
    import) become block plans, at most ``max_blocks`` blocks each."""

    def _block_plans(self, bids):
        for i in range(0, len(bids), self.max_blocks):
            yield list(bids[i:i + self.max_blocks])

    def _send_bids(self, op: int, bids) -> None:
        padded = np.zeros(self.max_blocks, np.int32)
        padded[:len(bids)] = bids
        self._send(op=op, bids=padded, nbids=[len(bids)])

    def _read_blocks(self, bids):
        if not self._peers:
            return super()._read_blocks(bids)
        kv = np.concatenate([self._watched(
            ("read_blocks",),
            lambda: self._send_bids(OP_READ_BLOCKS, part),
            lambda: gather_blocks(self, self._group, part))
            for part in self._block_plans(bids)], axis=3)
        return kv[0], kv[1]

    def _write_blocks(self, bids, k, v):
        if not self._peers:
            return super()._write_blocks(bids, k, v)
        bs = self.block_size
        for j, part in enumerate(self._block_plans(bids)):
            rows = slice(j * self.max_blocks * bs,
                         (j * self.max_blocks + len(part)) * bs)
            kv = np.stack([k[:, :, rows], v[:, :, rows]])
            self._watched(
                ("write_blocks",),
                lambda: self._send_bids(OP_WRITE_BLOCKS, part),
                lambda: scatter_blocks(self, self._group, part, kv))
