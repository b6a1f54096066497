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
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch
import torch.distributed.checkpoint as dcp

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


def _commit(directory: str, state: Dict[str, Any], step: int,
            keep: int) -> None:
    """Write ``state`` under a temporary name, rename it to its step, then
    drop all but the newest ``keep`` committed steps."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + _TMP_SUFFIX
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)             # a write cut off by a crash
    dcp.save(state, storage_writer=dcp.FileSystemWriter(
        tmp, thread_count=_WRITE_THREADS), no_dist=True)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(directory)
    for old in _committed_steps(directory)[:-keep]:
        shutil.rmtree(_step_dir(directory, old))


def save(directory: str, state: Dict[str, Any], step: int,
         keep: int = 3) -> None:
    """Write and commit ``state`` as ``step``; returns once it is on disk."""
    _commit(directory, state, step, keep)


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
    later ``save_async``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._buffers: Dict[str, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _write(self, host: Dict[str, Any], step: int) -> None:
        try:
            _commit(self.directory, host, step, self.keep)
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
    """Every tensor of the template must be saved with its shape and dtype:
    a restore casts nothing."""
    meta = dcp.FileSystemReader(_step_dir(directory, step)).read_metadata()

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(tree, torch.Tensor):
            fqn = prefix[:-1]
            saved = meta.state_dict_metadata.get(fqn)
            if not hasattr(saved, "properties"):
                raise ValueError(f"checkpoint step {step} has no tensor {fqn}")
            if (saved.size, saved.properties.dtype) != (tree.shape,
                                                        tree.dtype):
                raise ValueError(
                    f"checkpoint step {step}: {fqn} is {saved.properties.dtype}"
                    f" {list(saved.size)}, the template's {tree.dtype} "
                    f"{list(tree.shape)}")
    walk(template, "")


def restore(directory: str, step: int, state: Dict[str, Any]
            ) -> Dict[str, Any]:
    """Load step ``step`` into ``state`` (a template: the freshly
    initialised state, whose dtypes and devices the result keeps) and
    return it."""
    _check_template(directory, step, state)
    dcp.load(state, storage_reader=dcp.FileSystemReader(
        _step_dir(directory, step)), no_dist=True)
    return state


def restore_latest(directory: str, state: Dict[str, Any]
                   ) -> Optional[Dict[str, Any]]:
    """``restore`` of the newest committed step; None when there is none."""
    step = latest_step(directory)
    if step is None:
        return None
    return restore(directory, step, state)


def load_params_for_serving(directory: str, step: Optional[int] = None,
                            dtype: Optional[torch.dtype] = None,
                            device="cuda") -> Optional[Dict[str, Any]]:
    """The ``params`` subtree of a train checkpoint, for the serve path.

    Reads only the params (into host memory, in the saved dtypes), casts
    on the host to ``dtype`` when given, then places the tree on
    ``device``.  Returns None when ``directory`` does not exist (it is not
    created) or holds no committed step, or when ``step`` is given and not
    there."""
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
        node = params
        for k in keys[1:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(md.size, dtype=md.properties.dtype)
    dcp.load({"params": params}, storage_reader=dcp.FileSystemReader(path),
             no_dist=True)

    def place(tree):
        if isinstance(tree, dict):
            return {k: place(v) for k, v in tree.items()}
        return tree.to(dtype=dtype or tree.dtype).to(dev)

    return place(params)
