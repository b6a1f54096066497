"""One rank of a gloo group on the CPU, for the port's pipeline tests
(``test_torch_pipeline.py``).

    python tests/torch_pp_worker.py RANK WORLD PORT DIR

Reads ``DIR/task.json`` and ``DIR/inputs.npz`` (the stacks, inputs and
``llama_tiny`` params the test made with numpy and JAX) and writes
``DIR/out_RANK.npz``.  It imports torch and the port only; the test holds
what it writes to the JAX package's ``pipeline_apply``.

Every rank builds ``MeshSpec(pp=4, fsdp=1)``, ``MeshSpec(pp=2, fsdp=2)``
and ``MeshSpec(pp=1, fsdp=4)`` (group creations are collective over all
ranks), then:

- ``out_micro{n}``: ``pipeline_apply`` of the ``tanh(h @ w + b)`` stack
  over pp=4 at ``n`` microbatches; ``out_pp1`` over a mesh whose pp is 1
  (``MeshSpec(pp=1, fsdp=4)``: one stage, no hops);
- ``grad_w``, ``grad_b``: the gradients of ``(out ** 2).sum()`` (default
  microbatches) in the whole stack, each rank's stage rows filled;
- ``llama``: ``llama._layer``'s stack at 2 stages, 2 microbatches;
- ``errors``: the two ``ValueError`` texts.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.ops.rope import rope_frequencies
from kuberay_tpu_torch.parallel.mesh import MeshSpec
from kuberay_tpu_torch.parallel.pipeline import pipeline_apply

from torch_sp_worker import _unflatten, spawn_script


def simple_layer(h, lp):
    return torch.tanh(h @ lp["w"] + lp["b"])


def run(rank, inp, out, task):
    pp4 = MeshSpec(pp=4, fsdp=1).build("cpu")
    pp2 = MeshSpec(pp=2, fsdp=2).build("cpu")
    pp1 = MeshSpec(pp=1, fsdp=4).build("cpu")
    stack = {"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}
    x = torch.from_numpy(inp["x"])
    with torch.no_grad():
        for n in task["n_micro"]:
            out[f"out_micro{n}"] = pipeline_apply(
                simple_layer, stack, x, pp4, n_microbatches=n).numpy()
        out["out_pp1"] = pipeline_apply(simple_layer, stack, x, pp1,
                                        n_microbatches=4).numpy()
    leaves = {k: v.clone().requires_grad_(True) for k, v in stack.items()}
    loss = (pipeline_apply(simple_layer, leaves, x, pp4) ** 2).sum()
    loss.backward()
    out["grad_w"] = leaves["w"].grad.numpy()
    out["grad_b"] = leaves["b"].grad.numpy()
    out["loss"] = np.array(loss.item())

    cfg = llama.CONFIGS["llama_tiny"]
    params = params_from_jax(cfg, _unflatten(inp, "llama/"), "cpu")
    tokens = torch.from_numpy(inp["tokens"]).long()
    h0 = params["embed"][tokens]
    S = tokens.shape[1]
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta)

    def layer(h, lp):
        return llama._layer(cfg, h, lp, cos, sin)

    with torch.no_grad():
        out["llama"] = pipeline_apply(layer, params["layers"], h0, pp2,
                                      n_microbatches=2).numpy()
    errors = []
    bad = {"w": stack["w"][:6], "b": stack["b"][:6]}
    for st, kw in ((bad, {}), (stack, {"n_microbatches": 3})):
        try:
            pipeline_apply(simple_layer, st, x, pp4, **kw)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = np.array(errors)


def main(argv):
    rank, world = int(argv[1]), int(argv[2])
    port, root = argv[3], Path(argv[4])
    torch.set_num_threads(1)
    task = json.loads((root / "task.json").read_text())
    inp = dict(np.load(root / "inputs.npz"))
    out = {}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        run(rank, inp, out, task)
    finally:
        dist.destroy_process_group()
    np.savez(root / f"out_{rank}.npz", **out)


def spawn(task: dict, arrays: dict, root: Path, world: int = 4,
          timeout: float = 120.0, wait: bool = True):
    """Start ``world`` ranks of ``task``; with ``wait``, their outputs
    (else a function that waits for them)."""
    return spawn_script(__file__, task, arrays, root, world, timeout, wait)


if __name__ == "__main__":
    main(sys.argv)
