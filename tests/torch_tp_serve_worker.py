"""One rank of a gloo group on the CPU, for the port's tensor-parallel
serving tests (``test_torch_tp_serving.py``).

    python tests/torch_tp_serve_worker.py RANK WORLD PORT DIR

Reads ``DIR/task.json`` and ``DIR/inputs.npz`` (the JAX package's params
as numpy, made by the test) and writes ``DIR/out_RANK.npz``.  It imports
torch and the port only; the test holds what it writes to the JAX package.

For each variant every rank builds ``serve_mesh(tp)`` and the plan group
(group creations, collective over all ranks); the first ``tp`` ranks take
their shards
of the converted params and run the lockstep engines: rank 0 a
``MultihostServeEngine`` (or its paged twin) on the task's greedy
prompts, the others ``follower_loop``.  Rank 0 writes each request's
tokens and its device-call count (the block plans of a paged engine's
export among them), every follower the calls it replayed;
every rank its engine's cache shapes and, with int8 weights, its local
scales.  Every rank also writes each param and cache leaf's chunk
(offsets and sizes) on the tp=2 and tp=4 meshes, whether its
``init_sharded_params`` equal its shards of the seeded whole tree, and, on
the tp=2 mesh,
the gathered logits of one prefill and one decode step of
``forward_with_cache``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from kuberay_tpu_torch.models import llama, mixtral
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.serve import kv_cache
from kuberay_tpu_torch.serve.engine import Request, ServeEngine
from kuberay_tpu_torch.serve.multihost import (
    OP_READ_BLOCKS,
    OP_WRITE_BLOCKS,
    MultihostPagedServeEngine,
    MultihostServeEngine,
    follower_loop,
    plan_group,
)
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine
from kuberay_tpu_torch.serve.sharding import (
    cache_shardings,
    init_sharded_params,
    paged_cache_shardings,
    param_shardings,
    serve_layout,
    serve_mesh,
    shard_params,
)

from torch_sp_worker import _unflatten, spawn_script

MODELS = {"llama_tiny": llama.CONFIGS, "mixtral_tiny": mixtral.CONFIGS}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _chunks(specs, shapes, prefix: str, out: dict) -> None:
    """Each leaf's (offsets, sizes) in its global leaf, whose shape is
    ``shapes``' leaf."""
    flat = dict(_leaves(shapes))
    for path, spec in _leaves(specs):
        offs, sizes = spec.chunk(flat[path])
        out[f"{prefix}/{path}"] = np.array([offs, sizes])


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return tuple(tree.shape)


def layouts_task(rank, inp, out, task):
    """The chunks of every param and cache leaf on the tp=2 and tp=4
    meshes, and the tp=2 forward's gathered logits."""
    cfg = llama.CONFIGS["llama_tiny"]
    full = params_from_jax(cfg, _unflatten(inp, "llama_tiny/"), "cpu")
    shapes = _shape_tree(full)
    S, M = 4, 64
    for tp in (2, 4):
        mesh = serve_mesh(tp, n_kv_heads=cfg.n_kv_heads, device_type="cpu")
        if rank >= tp:
            continue
        lay = serve_layout(mesh)
        out[f"tp{tp}_coord"] = np.array([lay.index("tp"), lay.index("tpr"),
                                         lay.size("tp"), lay.size("tpr")])
        _chunks(param_shardings(cfg, lay), shapes, f"tp{tp}_params", out)
        for quant in ("none", "int8"):
            dense = _shape_tree(kv_cache.init_kv_cache(cfg, S, M, "meta",
                                                       quant=quant))
            _chunks(cache_shardings(cfg, lay, quant), dense,
                    f"tp{tp}_cache_{quant}", out)
            pool = {n: ({"q": (cfg.n_layers, cfg.n_kv_heads, 128,
                               cfg.head_dim),
                         "s": (cfg.n_layers, cfg.n_kv_heads, 128)}
                        if quant == "int8" else
                        (cfg.n_layers, cfg.n_kv_heads, 128, cfg.head_dim))
                    for n in ("k", "v")}
            _chunks(paged_cache_shardings(lay, quant), pool,
                    f"tp{tp}_pool_{quant}", out)
        for name, mod in (("llama_tiny", llama), ("mixtral_tiny", mixtral)):
            mcfg = mod.CONFIGS[name]
            drawn = init_sharded_params(mcfg, 5, lay)
            want = shard_params(mcfg, mod.init_params(
                mcfg, torch.Generator().manual_seed(5), "cpu"), lay)
            out[f"tp{tp}_init_equal_{name}"] = np.array(all(
                torch.equal(a, b) and a.is_contiguous() for (_, a), (_, b)
                in zip(_leaves(drawn), _leaves(want))))
        if tp == 2:
            local = shard_params(cfg, full, lay)
            cache = kv_cache.init_kv_cache(cfg, S, M, "cpu",
                                           n_kv_heads=cfg.n_kv_heads // 2)
            with torch.no_grad():
                logits, _ = kv_cache.forward_with_cache(
                    cfg, local, torch.from_numpy(inp["fwd_tokens"]).long(),
                    cache, torch.zeros(S, dtype=torch.long), layout=lay)
                out["prefill_logits"] = logits.numpy()
                logits, _ = kv_cache.forward_with_cache(
                    cfg, local,
                    torch.from_numpy(inp["fwd_next"]).long()[:, None],
                    cache, torch.from_numpy(inp["fwd_lens"]).long(),
                    layout=lay)
                out["decode_logits"] = logits.numpy()


def engines_task(rank, inp, out, task):
    prompts = task["prompts"]
    for var in task["variants"]:
        name, tp = var["name"], var["tp"]
        cfg = MODELS[var["model"]][var["model"]]
        mesh = serve_mesh(tp, n_kv_heads=cfg.n_kv_heads, device_type="cpu")
        if rank >= tp:
            plan_group(range(tp))    # collective over every process
            continue
        lay = serve_layout(mesh)
        full = params_from_jax(cfg, _unflatten(inp, f"{var['model']}/"),
                               "cpu")
        params = shard_params(cfg, full, lay)
        del full
        follower_cls, lead_cls = (
            (PagedServeEngine, MultihostPagedServeEngine) if var.get("paged")
            else (ServeEngine, MultihostServeEngine))
        kw = dict(max_slots=task["max_slots"], max_len=task["max_len"],
                  device="cpu", layout=lay, **var.get("kw", {}))
        if var.get("paged"):
            # The KV tiers under tp > 1: refused for an int8 pool only
            # ("" where the engine builds).
            try:
                follower_cls(cfg, params, host_blocks=8, **kw)
                out[f"{name}_tiers_refused"] = np.array("")
            except ValueError as e:
                out[f"{name}_tiers_refused"] = np.array(str(e))
        if rank == 0:
            eng = lead_cls(cfg, params, **kw)
            block_plans = []
            real_send = eng._send

            def send(**updates):
                if int(np.asarray(updates["op"]).ravel()[0]) in (
                        OP_READ_BLOCKS, OP_WRITE_BLOCKS):
                    block_plans.append(updates["op"])
                real_send(**updates)
            eng._send = send
            for i, p in enumerate(prompts):
                eng.add_request(Request(f"r{i}", p,
                                        max_new_tokens=task["max_new"]))
            got = {r.request_id: r.tokens for r in eng.run()}
            if var.get("paged"):
                # Block export and import: refused for an int8 pool only.
                for what in ("export", "import"):
                    try:
                        if what == "export":
                            eng.export_kv_blocks(prompts[3])
                        else:
                            eng.import_kv_blocks(prompts[3], [])
                        out[f"{name}_{what}_refused"] = np.array("")
                    except NotImplementedError as e:
                        out[f"{name}_{what}_refused"] = np.array(str(e))
            eng.stop()
            for i in range(len(prompts)):
                out[f"{name}_tokens_{i}"] = np.array(got[f"r{i}"])
            st = eng.stats
            out[f"{name}_calls"] = np.array(
                st["prefills"] + st["decode_steps"]
                + eng.spec_stats["verify_steps"] + len(block_plans))
            out[f"{name}_drafted"] = np.array(eng.spec_stats["drafted"])
        else:
            eng = follower_cls(cfg, params, **kw)
            out[f"{name}_replayed"] = np.array(follower_loop(eng))
        for path, t in _leaves(eng.cache):
            out[f"{name}_cache/{path}"] = np.array(t.shape)
        if var.get("kw", {}).get("weight_quant") == "int8":
            for path, t in _leaves(eng.params):
                if path.endswith("s8"):
                    out[f"{name}_s8/{path}"] = t.numpy()


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
        layouts_task(rank, inp, out, task)
        engines_task(rank, inp, out, task)
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
