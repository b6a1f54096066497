"""Checkpoint and resume of the train state, on ``torch.distributed.checkpoint``.

The counterpart of ``kuberay_tpu/train/checkpoint.py`` (Orbax there): the
same names and the same contract, in another format.  A checkpoint is a
directory per step, ``<directory>/<step>``, holding one
``torch.distributed.checkpoint`` (DCP) save of the whole state: the
params, the optimizer state and the step, whose integer leaves round-trip
with the tensors.  Port checkpoints are not Orbax checkpoints; neither
package reads the other's.

A step counts only once it is committed: it is written under a temporary
name and renamed, so ``latest_step`` never picks a half-written step
after a crash.  The newest ``keep`` steps are kept.

``CheckpointWriter.save_async`` returns once the state is copied to host
memory (pinned buffers for device tensors, reused from save to save); one
writer thread then writes and commits it while training goes on, so
nothing a later step does to the device tensors, in place or not, reaches
the checkpoint.  One save is in flight at a time.  ``dcp.async_save``
would need a process group, which a single process lacks, so the writer
thread calls ``dcp.save`` on the host copy.

A sharded state (the multi-process layouts of
``train_step.make_sharded_train_fns``: every rank holds its shard of each
leaf) is saved and restored with its ``shardings`` (``state_shardings``:
each leaf's chunk of the global tensor).  Each rank hands DCP its chunks
(``_Chunk``), DCP writes every chunk once (replicated chunks from one
rank) and records the global shapes, and a restore reads whatever chunks
the target layout needs: a save from 8 ranks restores into one process
(no ``shardings``: whole leaves) or another layout, as Orbax restores
into target shardings in the JAX package.  The ranks' saves and commits
run over a gloo group of their own, so a writer thread's collectives
never interleave with the training step's.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.default_planner import (
    DefaultLoadPlanner,
    DefaultSavePlanner,
)
from torch.distributed.checkpoint.metadata import (
    ChunkStorageMetadata,
    MetadataIndex,
    TensorProperties,
)
from torch.distributed.checkpoint.planner import (
    TensorWriteData,
    WriteItem,
    WriteItemType,
)

from kuberay_tpu_torch.utils.device import resolve_device

_TMP_SUFFIX = ".tmp"
_WRITE_THREADS = 4


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, str(step))


def _committed_steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(
                      os.path.join(directory, n, ".metadata")))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _Chunk:
    """One rank's chunk of a global tensor, in DCP's checkpointable
    protocol: ``local`` is the data, at ``offsets`` in a tensor of
    ``global_shape``."""

    def __init__(self, local: torch.Tensor, global_shape, offsets):
        self.local = local
        self.global_shape = torch.Size(global_shape)
        self.offsets = torch.Size(offsets)

    def size(self) -> torch.Size:
        return self.global_shape

    def __create_write_items__(self, fqn: str, obj) -> list:
        return [WriteItem(
            index=MetadataIndex(fqn, self.offsets), type=WriteItemType.SHARD,
            tensor_data=TensorWriteData(
                chunk=ChunkStorageMetadata(offsets=self.offsets,
                                           sizes=self.local.shape),
                properties=TensorProperties.create_from_tensor(self.local),
                size=self.global_shape))]

    def __create_chunk_list__(self) -> list:
        return [ChunkStorageMetadata(offsets=self.offsets,
                                     sizes=self.local.shape)]

    def __get_tensor_shard__(self, index) -> torch.Tensor:
        return self.local


class _SavePlanner(DefaultSavePlanner):
    def lookup_object(self, index):
        obj = self.state_dict[index.fqn]
        return obj.local if isinstance(obj, _Chunk) else \
            super().lookup_object(index)


class _LoadPlanner(DefaultLoadPlanner):
    def set_up_planner(self, state_dict, metadata=None,
                       is_coordinator: bool = False) -> None:
        # The default set-up's meta-tensor pass replaces every object it
        # does not know (a _Chunk) by None, in place: put the chunks back
        # into the flat dict the plan reads.
        chunks = dict(_flat_chunks(state_dict))
        super().set_up_planner(state_dict, metadata, is_coordinator)
        self.state_dict.update(chunks)

    def lookup_tensor(self, index):
        obj = self.state_dict[index.fqn]
        return obj.local if isinstance(obj, _Chunk) else \
            super().lookup_tensor(index)


def _chunked(tree, shardings):
    """``tree`` with every tensor leaf that ``shardings`` places wrapped as
    its ``_Chunk`` (other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: _chunked(v, shardings[k]) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    gshape = shardings.global_shape(tree.shape)
    return _Chunk(tree, gshape, shardings.chunk(gshape)[0])


def _flat_chunks(tree, prefix: str = ""):
    """(DCP's flat key, chunk) of every ``_Chunk`` in a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_chunks(v, f"{prefix}{k}.")
        elif isinstance(v, _Chunk):
            yield f"{prefix}{k}", v


def _loaded(state, target):
    """``state`` (whose tensors the load filled in place, through the
    chunks' views) with the other leaves DCP loaded into ``target``."""
    if isinstance(state, dict):
        return {k: _loaded(v, target[k]) for k, v in state.items()}
    return state if isinstance(state, torch.Tensor) else target


def _has_chunks(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_chunks(v) for v in tree.values())
    return isinstance(tree, _Chunk)


_GROUP = None


def _group():
    """The checkpoints' gloo group (made once, by every rank), or None in
    a single process."""
    global _GROUP
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    if _GROUP is None:
        _GROUP = dist.new_group(backend="gloo")
    return _GROUP


def _commit(directory: str, state: Dict[str, Any], step: int,
            keep: int, group=None) -> None:
    """Write ``state`` under a temporary name, rename it to its step, then
    drop all but the newest ``keep`` committed steps.  With a ``group``
    every rank writes its chunks and rank 0 prepares and commits."""
    lead = group is None or dist.get_rank() == 0
    final = _step_dir(directory, step)
    tmp = final + _TMP_SUFFIX
    if lead:
        os.makedirs(directory, exist_ok=True)
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)         # a write cut off by a crash
    writer = dcp.FileSystemWriter(tmp, thread_count=_WRITE_THREADS)
    if group is not None:
        dist.barrier(group=group)
    if group is None and not _has_chunks(state):
        dcp.save(state, storage_writer=writer, no_dist=True)
    else:
        dcp.save(state, storage_writer=writer, planner=_SavePlanner(),
                 process_group=group, no_dist=group is None)
    if lead:
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(directory)
        for old in _committed_steps(directory)[:-keep]:
            shutil.rmtree(_step_dir(directory, old))
    if group is not None:
        dist.barrier(group=group)


def save(directory: str, state: Dict[str, Any], step: int,
         keep: int = 3, shardings=None) -> None:
    """Write and commit ``state`` as ``step``; returns once it is on disk.
    ``shardings``: a sharded state's (``train_step.state_shardings``)."""
    if shardings is None:
        return _commit(directory, state, step, keep)
    _commit(directory, _chunked(state, shardings), step, keep, _group())


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _host_copy(tree, buffers: Dict[str, torch.Tensor], prefix: str = ""):
    """``tree`` with every tensor copied into ``buffers[path]`` (pinned
    for device tensors; made on first use, reused while shape and dtype
    hold).  Other leaves (the integer step and count) are kept as they
    are."""
    if isinstance(tree, dict):
        return {k: _host_copy(v, buffers, f"{prefix}{k}.")
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    buf = buffers.get(prefix)
    if buf is None or buf.shape != tree.shape or buf.dtype != tree.dtype:
        buf = torch.empty(tree.shape, dtype=tree.dtype, device="cpu",
                          pin_memory=tree.is_cuda)
        buffers[prefix] = buf
    buf.copy_(tree, non_blocking=tree.is_cuda)
    return buf


class CheckpointWriter:
    """Asynchronous checkpointing for the training loop.

    ``save_async`` waits for the previous save's commit, copies the state
    to host memory and returns; a writer thread writes and commits it.
    Background failures are sticky: the first one is re-raised by
    ``wait()``, ``close()`` (which still drains the writer) and every
    later ``save_async``.  A sharded state's writer takes its
    ``shardings``; every rank makes one (in the same order), saves at the
    same steps and writes its own chunks."""

    def __init__(self, directory: str, keep: int = 3, shardings=None):
        self.directory = directory
        self.keep = keep
        self.shardings = shardings
        self._group = None if shardings is None else _group()
        self._buffers: Dict[str, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _write(self, host: Dict[str, Any], step: int) -> None:
        try:
            if self._group is None:
                _commit(self.directory, host, step, self.keep)
            else:
                _commit(self.directory, host, step, self.keep, self._group)
        except BaseException as e:        # re-raised on the caller's thread
            self._error = e

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, state: Dict[str, Any], step: int) -> None:
        self.wait()
        host = _host_copy(state, self._buffers)
        if any(t.is_cuda for t in _tensors(state)):
            torch.cuda.synchronize()   # the copies into pinned memory
        if self.shardings is not None:
            host = _chunked(host, self.shardings)
        self._thread = threading.Thread(
            target=self._write, args=(host, step),
            name=f"checkpoint-{step}")
        self._thread.start()

    def wait(self) -> None:
        """Block until the save in flight is committed; raise the first
        background failure."""
        self._join()
        if self._error is not None:
            raise self._error

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "CheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def latest_step(directory: str) -> Optional[int]:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def _check_template(directory: str, step: int, template) -> None:
    """Every tensor of the template must be saved with its (global) shape
    and dtype: a restore casts nothing."""
    meta = dcp.FileSystemReader(_step_dir(directory, step)).read_metadata()

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(tree, (torch.Tensor, _Chunk)):
            fqn = prefix[:-1]
            local = tree.local if isinstance(tree, _Chunk) else tree
            saved = meta.state_dict_metadata.get(fqn)
            if not hasattr(saved, "properties"):
                raise ValueError(f"checkpoint step {step} has no tensor {fqn}")
            if (saved.size, saved.properties.dtype) != (tree.size(),
                                                        local.dtype):
                raise ValueError(
                    f"checkpoint step {step}: {fqn} is {saved.properties.dtype}"
                    f" {list(saved.size)}, the template's {local.dtype} "
                    f"{list(tree.size())}")
    walk(template, "")


def restore(directory: str, step: int, state: Dict[str, Any],
            shardings=None) -> Dict[str, Any]:
    """Load step ``step`` into ``state`` (a template: the freshly
    initialised state, whose dtypes and devices the result keeps) and
    return it.  ``shardings``: the template's layout when it is a sharded
    state (whatever layout the save had)."""
    reader = dcp.FileSystemReader(_step_dir(directory, step))
    if shardings is None:
        _check_template(directory, step, state)
        dcp.load(state, storage_reader=reader, no_dist=True)
        return state
    target = _chunked(state, shardings)
    _check_template(directory, step, target)
    group = _group()
    dcp.load(target, storage_reader=reader, planner=_LoadPlanner(),
             process_group=group, no_dist=group is None)
    return _loaded(state, target)


def restore_latest(directory: str, state: Dict[str, Any], shardings=None
                   ) -> Optional[Dict[str, Any]]:
    """``restore`` of the newest committed step; None when there is none."""
    step = latest_step(directory)
    if step is None:
        return None
    return restore(directory, step, state, shardings)


def load_params_for_serving(directory: str, step: Optional[int] = None,
                            dtype: Optional[torch.dtype] = None,
                            device="cuda", shardings=None
                            ) -> Optional[Dict[str, Any]]:
    """The ``params`` subtree of a train checkpoint, for the serve path.

    Reads only the params (into host memory, in the saved dtypes), casts
    on the host to ``dtype`` when given, then places the tree on
    ``device``.  ``shardings`` (a tree of ``spmd.LeafSpec``, e.g.
    ``serve/sharding.py::param_shardings``): this rank's shards only, the
    leaves read one at a time, so the host holds one whole leaf at most.
    Returns None when ``directory`` does not exist (it is not created) or
    holds no committed step, or when ``step`` is given and not there."""
    dev = resolve_device(device)
    steps = _committed_steps(directory)
    if not steps:
        return None
    if step is None:
        step = steps[-1]
    elif step not in steps:
        return None
    path = _step_dir(directory, step)
    meta = dcp.FileSystemReader(path).read_metadata()
    params: Dict[str, Any] = {}
    for fqn, md in meta.state_dict_metadata.items():
        keys = fqn.split(".")
        if keys[0] != "params":
            continue
        spec = shardings
        for k in keys[1:]:
            spec = spec[k] if spec is not None else None
        leaf = {}
        node = leaf
        for k in keys[1:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(md.size, dtype=md.properties.dtype)
        dcp.load({"params": leaf}, storage_reader=dcp.FileSystemReader(path),
                 no_dist=True)
        t = node[keys[-1]]
        if spec is not None:
            t = spec.shard(t)
        node = params
        for k in keys[1:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t.to(dtype=dtype or t.dtype).to(dev)
    return params
