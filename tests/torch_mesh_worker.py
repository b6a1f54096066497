"""One rank of a gloo ``DeviceMesh`` on the CPU, for the port's
multi-process layout tests (``test_torch_mesh_train.py``,
``test_torch_mesh_launcher.py``).

    python tests/torch_mesh_worker.py RANK WORLD PORT DIR

Reads ``DIR/task.json`` and ``DIR/inputs.npz`` (global arrays made by the
test) and writes ``DIR/out_RANK.npz``.  It imports torch and the port
only; the test holds what it gathers to the JAX package.

Tasks:

- ``"train"``: for each llama variant, a mesh (``MeshSpec(**spec)``, or
  its ``build_multislice``), the converted JAX params sharded onto it and
  the given number of steps of ``make_sharded_train_fns`` on the global
  batches: each step's metrics and the params gathered after the last;
  every rank's mesh coordinate and each param leaf's placements; one
  variant's state saved through ``checkpoint.save`` with its shardings
  and restored into a later variant's layout; the seeded ``init()``
  gathered.  Then Mixtral over ``MeshSpec(dp=-1, fsdp=2, ep=2)``: the
  placements, the forward's logits of this rank's rows and one step's
  metrics.
- ``"launcher"``: ``launcher.main`` with the task's argv (the env carries
  the slice identity), heartbeats posted to the test's recorder.
"""

from __future__ import annotations

import dataclasses
import io
import contextlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from kuberay_tpu_torch.models import llama, mixtral
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.parallel import spmd
from kuberay_tpu_torch.parallel.mesh import MeshSpec
from kuberay_tpu_torch.train import checkpoint as ckpt
from kuberay_tpu_torch.train import train_step as ts

from torch_sp_worker import _flatten, _unflatten, spawn_script


def _mesh(var: dict):
    spec = MeshSpec(**var["spec"])
    if var.get("slices"):
        return spec.build_multislice(var["slices"], device_type="cpu")
    return spec.build("cpu")


def _gathered(tree, specs, prefix: str, out: dict) -> dict:
    full = ts.tree_map(lambda t, s: s.gather(t), tree, specs)
    return _flatten(full, prefix, out)


def _placements(specs, prefix: str, out: dict) -> dict:
    """Each leaf's placements, one ``axis=R`` or ``axis=S<dim>`` a mesh
    axis."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            _placements(v, f"{prefix}{k}/", out)
    else:
        names = specs.layout.mesh.mesh_dim_names
        out[prefix[:-1]] = np.array(",".join(
            f"{a}={'S%d' % p.dim if isinstance(p, Shard) else 'R'}"
            for a, p in zip(names, specs.placements)))
    return out


def train_task(rank, inp, out, task):
    base = llama.CONFIGS["llama_tiny"]
    for var in task["variants"]:
        cfg = dataclasses.replace(base, **var.get("cfg", {}))
        mesh = _mesh(var)
        name = var["name"]
        out[f"{name}_coord"] = np.array(mesh.get_coordinate())
        tc = ts.TrainConfig(**var["tc"])
        init, step, sh = ts.make_sharded_train_fns(cfg, tc, mesh)
        _placements(sh["params"], f"{name}_placements/", out)
        full = params_from_jax(cfg, _unflatten(inp, "params/"), "cpu")
        params = ts.tree_map(lambda t, s: s.shard(t), full, sh["params"])
        opt = ts.make_optimizer(tc)
        state = {"step": 0, "params": params, "opt_state": opt.init(params)}
        for i in range(task["steps"]):
            batch = {k: torch.from_numpy(inp[f"{k}_{i}"])
                     for k in ("tokens", "targets", "mask")}
            state, metrics = step(state, batch)
            for k, val in metrics.items():
                out[f"{name}_step{i}_{k}"] = np.array(val.item())
        _gathered(state["params"], sh["params"], f"{name}_params/", out)
        if var.get("save"):
            ckpt.save(task["ckpt_dir"], state, task["steps"], shardings=sh)
            for part in ("mu", "nu"):
                _gathered(state["opt_state"][part], sh["params"],
                          f"{name}_{part}/", out)
        if var.get("init"):
            _gathered(init()["params"], sh["params"], f"{name}_init/", out)
        if var.get("restore"):
            # The save of another layout, restored into this one.
            state = ckpt.restore(task["ckpt_dir"], task["steps"], init(),
                                 sh)
            _gathered(state["params"], sh["params"], f"{name}_restored/",
                      out)
            out[f"{name}_restored_step"] = np.array(state["step"])
    moe_task(inp, out, task)


def moe_task(inp, out, task):
    cfg = mixtral.CONFIGS["mixtral_tiny"]
    mesh = MeshSpec(dp=-1, fsdp=2, ep=2).build("cpu")
    tc = ts.TrainConfig(**task["moe_tc"])
    _, step, sh = ts.make_sharded_train_fns(cfg, tc, mesh)
    _placements(sh["params"], "moe_placements/", out)
    full = params_from_jax(cfg, _unflatten(inp, "moe_params/"), "cpu")
    params = ts.tree_map(lambda t, s: s.shard(t), full, sh["params"])
    tokens = torch.from_numpy(inp["moe_tokens"])
    lay = spmd.layout_of(mesh)
    with torch.no_grad():
        logits, _ = mixtral.forward(cfg, params, lay.local_rows(tokens),
                                    mesh)
    out["moe_logits"] = logits.numpy()
    out["moe_rows"] = np.array(lay.batch_index)
    opt = ts.make_optimizer(tc)
    state = {"step": 0, "params": params, "opt_state": opt.init(params)}
    _, metrics = step(state, {"tokens": tokens,
                              "targets": torch.from_numpy(
                                  inp["moe_targets"])})
    for k, val in metrics.items():
        out[f"moe_{k}"] = np.array(val.item())


def launcher_task(rank, inp, out, task, port):
    """The launcher as a training pod runs it (the group's rendezvous on
    ``port``), with its heartbeats posted to the test's recorder and its
    stdout kept."""
    from kuberay_tpu_torch.runtime import coordinator_client
    from kuberay_tpu_torch.train import launcher
    coordinator_client.dashboard_url = lambda addr: task["recorder"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launcher.main(task["argv"] + ["--dist-port", port])
    out["rc"] = np.array(rc)
    out["stdout"] = np.array(buf.getvalue())


def main(argv):
    rank, world = int(argv[1]), int(argv[2])
    port, root = argv[3], Path(argv[4])
    torch.set_num_threads(1)
    task = json.loads((root / "task.json").read_text())
    inp = dict(np.load(root / "inputs.npz"))
    out = {}
    if task["kind"] == "launcher":
        env = task["env"][rank]
        os.environ.update(env)
        launcher_task(rank, inp, out, task, port)
    else:
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            train_task(rank, inp, out, task)
        finally:
            dist.destroy_process_group()
    np.savez(root / f"out_{rank}.npz", **out)


def spawn(task: dict, arrays: dict, root: Path, world: int = 8,
          timeout: float = 240.0, wait: bool = True):
    """Start ``world`` ranks of ``task``; with ``wait``, their outputs
    (else a function that waits for them)."""
    return spawn_script(__file__, task, arrays, root, world, timeout, wait)


if __name__ == "__main__":
    main(sys.argv)
