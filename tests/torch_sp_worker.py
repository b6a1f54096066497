"""One sp rank of a gloo ``DeviceMesh`` on the CPU, for the port's
sequence-parallel tests (``test_torch_ring.py``,
``test_torch_long_context.py``).

    python tests/torch_sp_worker.py RANK WORLD PORT DIR

Reads ``DIR/task.json`` and ``DIR/inputs.npz`` (global tensors made by the
test), runs the task on this rank's sequence shard and writes
``DIR/out_RANK.npz``.  It imports torch and the port only; the test holds
the shards it gathers to the JAX package.  ``spawn`` is the test's side:
it starts the ranks and collects their outputs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.parallel.mesh import MeshSpec
from kuberay_tpu_torch.parallel.ring import ring_attention
from kuberay_tpu_torch.train import train_step as ts


def _shard(a: np.ndarray, rank: int, n: int) -> torch.Tensor:
    """This rank's sequence shard (axis 1) of a global array."""
    sl = a.shape[1] // n
    return torch.from_numpy(
        np.ascontiguousarray(a[:, rank * sl:(rank + 1) * sl]))


def _unflatten(flat: dict, prefix: str) -> dict:
    tree = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    else:
        out[prefix[:-1]] = tree.detach().float().numpy()
    return out


def ring_task(mesh, rank, n, inp, out):
    """Ring attention, both impls, causal and not: this rank's output and
    the gradients of sum(out * w) in its shard of q, k and v."""
    for impl in ("ppermute", "rdma"):
        for causal in (True, False):
            q, k, v = (_shard(inp[x], rank, n).requires_grad_()
                       for x in ("q", "k", "v"))
            o = ring_attention(q, k, v, mesh, causal=causal, impl=impl)
            (o * _shard(inp["w"], rank, n)).sum().backward()
            tag = f"{impl}_{causal}"
            out[f"{tag}_out"] = o.detach().numpy()
            for x, t in (("q", q), ("k", k), ("v", v)):
                out[f"{tag}_d{x}"] = t.grad.numpy()
    # Only the sp axis may be larger than 1.
    try:
        MeshSpec(dp=1, fsdp=2, tp=1, sp=2).build("cpu")
        out["non_sp_refused"] = np.array(0)
    except NotImplementedError:
        out["non_sp_refused"] = np.array(1)


def train_task(mesh, rank, n, inp, out, task):
    """The model's forward on this rank's tokens, then the sharded train
    step for each variant: its metrics and its params after every step."""
    base = llama.CONFIGS["llama_tiny"]
    for var in task["variants"]:
        cfg = dataclasses.replace(base, attn_impl=var["attn"],
                                  remat=var["remat"])
        params = params_from_jax(cfg, _unflatten(inp, "params/"), "cpu")
        name = var["name"]
        with torch.no_grad():
            out[f"{name}_logits"] = llama.forward(
                cfg, params, _shard(inp["tokens_0"], rank, n), mesh).numpy()
        tc = ts.TrainConfig(**var["tc"])
        _, step, _ = ts.make_sharded_train_fns(cfg, tc, mesh)
        opt = ts.make_optimizer(tc)
        state = {"step": 0, "params": params, "opt_state": opt.init(params)}
        for i in range(task["steps"]):
            batch = {k: torch.from_numpy(inp[f"{k}_{i}"])
                     for k in ("tokens", "targets", "mask")}
            state, metrics = step(state, batch)
            for k, val in metrics.items():
                out[f"{name}_step{i}_{k}"] = np.array(val.item())
        _flatten(state["params"], f"{name}_params/", out)
    # A DeviceMesh shards the sequence: attention that is not the ring is
    # refused rather than run on one shard.
    cfg = dataclasses.replace(base, attn_impl="xla")
    try:
        llama.forward(cfg, params, _shard(inp["tokens_0"], rank, n), mesh)
        out["non_ring_refused"] = np.array(0)
    except ValueError:
        out["non_ring_refused"] = np.array(1)


def spawn(task: dict, arrays: dict, root: Path, world: int = 4,
          timeout: float = 100.0) -> list:
    """Run ``task`` on ``world`` gloo ranks, each in its own process, and
    return every rank's outputs (a dict of arrays per rank)."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "task.json").write_text(json.dumps(task))
    np.savez(root / "inputs.npz", **arrays)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(Path(__file__).resolve().parents[1]),
                os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(port), str(root)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, log) for r, (p, log) in
           enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, bad
    return [dict(np.load(root / f"out_{r}.npz")) for r in range(world)]


def main(argv):
    rank, world = int(argv[1]), int(argv[2])
    port, root = argv[3], Path(argv[4])
    torch.set_num_threads(1)
    task = json.loads((root / "task.json").read_text())
    inp = dict(np.load(root / "inputs.npz"))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = MeshSpec(dp=1, fsdp=1, tp=1, sp=world).build("cpu")
        out = {}
        if task["kind"] == "ring":
            ring_task(mesh, rank, world, inp, out)
        else:
            train_task(mesh, rank, world, inp, out, task)
        np.savez(root / f"out_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
