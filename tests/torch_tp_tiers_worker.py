"""One rank of a gloo group on the CPU, for the port's tests of the KV tiers
and the block transfer under tensor parallelism
(``test_torch_tp_tiers.py``).

    python tests/torch_tp_tiers_worker.py RANK WORLD PORT DIR

Reads ``DIR/task.json`` (the variants, prompts and a JAX engine's export
of the import prompt) and ``DIR/inputs.npz`` (the JAX package's
``llama_tiny`` params as numpy) and writes ``DIR/out_RANK.npz``.  It
imports torch and the port only; the test holds what it writes to the
JAX package.

For each variant every rank builds ``serve_mesh(tp)`` and the plan group
(collective over all ranks); the first ``tp`` ranks take their shards of
the converted params and build a ``PagedServeEngine`` with the variant's
``host_blocks`` and ``spill_blocks``: rank 0 a
``MultihostPagedServeEngine``, the others ``follower_loop``.  Rank 0 runs
``test_torch_kv_tiers.py``'s resume case (serve the prompt for one token,
drain the demotions, evict every device block with other prompts, serve
the prompt again under a ``Tracer``), exports the prompt's blocks,
imports the JAX export of a second prompt and serves it, and writes the
tokens, tier counters, ``tier-fetch`` spans, the export's payloads and
how many plans it broadcast of each op; every follower writes the plans
it replayed.
"""

from __future__ import annotations

import base64
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.obs.trace import Tracer
from kuberay_tpu_torch.serve.engine import Request
from kuberay_tpu_torch.serve.multihost import (
    MultihostPagedServeEngine,
    follower_loop,
    plan_group,
)
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine
from kuberay_tpu_torch.serve.sharding import (
    serve_layout,
    serve_mesh,
    shard_params,
)

from torch_sp_worker import _unflatten, spawn_script

# The tier counters both packages' engines report.
TIER_KEYS = ("host_blocks_used", "host_blocks_total", "spill_blocks_used",
             "spill_blocks_total", "pending_demotions", "tier_hits_host",
             "tier_hits_spill", "tier_misses", "tier_demotions",
             "tier_promotions", "tier_evictions", "tier_stale_drops",
             "advert_seq", "tier_fetch_blocks", "tier_demoted_blocks",
             "num_blocks", "free_blocks", "prefix_hit_tokens",
             "prefix_query_tokens")


def serve(eng, rid, prompt, n, **kw):
    eng.add_request(Request(rid, list(prompt), max_new_tokens=n, **kw))
    return eng.run()[0].tokens


def fill_pool(eng, bs):
    """Cannibalise every cached device block with disjoint slot-sized
    in-vocab prompts (``test_torch_kv_tiers.py``'s ``_fill_pool``)."""
    plen = (eng.max_blocks - 1) * bs
    for j in range(eng.num_blocks // (eng.max_blocks - 1) + 1):
        toks = [(30 + j * plen + i) % 231 + 25 for i in range(plen)]
        serve(eng, f"junk{j}", toks, 1)


def payloads(blocks, shape):
    """[n, 2, L, Hkv, bs, D] float32 of wire records, their indices and
    hashes (as strings: the hashes exceed int64)."""
    kv = np.stack([np.stack([np.frombuffer(base64.b64decode(b[n]), "<f4")
                             .reshape(shape) for n in ("k", "v")])
                   for b in blocks]) if blocks else np.zeros((0,))
    return kv, np.array([b["index"] for b in blocks]), \
        np.array([str(b["hash"]) for b in blocks])


def lead(eng, cfg, task, var, out):
    name, bs = var["name"], task["block_size"]
    sent = {}
    real_send = eng._send

    def counting_send(**updates):
        op = int(np.asarray(updates.get("op", 0)).ravel()[0])
        sent[op] = sent.get(op, 0) + 1
        real_send(**updates)

    eng._send = counting_send
    tracer = eng._tracer = Tracer()
    prompt, prompt2 = task["prompt"], task["import_prompt"]
    serve(eng, "p", prompt, 1)
    eng._pump_demotions(limit=1 << 10)
    st = eng.tiers.stats()
    out[f"{name}_demoted"] = np.array(st["host_blocks_used"]
                                      + st["spill_blocks_used"])
    fill_pool(eng, bs)
    out[f"{name}_resident_after_fill"] = np.array(
        eng.resident_prefix_blocks(prompt))
    ctx = tracer.start_request("serve-request")
    out[f"{name}_tokens"] = np.array(serve(eng, "r", prompt, 6, trace=ctx))
    tracer.finish_request(ctx)
    out[f"{name}_fetch"] = np.array(
        [s["attrs"]["blocks"] for s in tracer.export(ctx.trace_id)
         if s["name"] == "tier-fetch"])
    out[f"{name}_stats"] = np.array([eng.stats[k] for k in TIER_KEYS])
    shape = (cfg.n_layers, cfg.n_kv_heads, bs, cfg.head_dim)
    for key, val in zip(("kv", "index", "hash"),
                        payloads(eng.export_kv_blocks(prompt), shape)):
        out[f"{name}_export_{key}"] = val
    counts = eng.import_kv_blocks(prompt2, task["jax_export"])
    out[f"{name}_imported"] = np.array([counts["imported"],
                                        counts["skipped"]])
    out[f"{name}_import_tokens"] = np.array(serve(eng, "d", prompt2, 6))
    out[f"{name}_import_hits"] = np.array(eng.stats["prefix_hit_tokens"])
    eng.stop()
    out[f"{name}_sent"] = np.array([sent.get(op, 0) for op in range(6)])


def run(rank, inp, out, task):
    cfg = llama.CONFIGS["llama_tiny"]
    for var in task["variants"]:
        tp = var["tp"]
        mesh = serve_mesh(tp, n_kv_heads=cfg.n_kv_heads, device_type="cpu")
        if rank >= tp:
            plan_group(range(tp))    # collective over every process
            continue
        lay = serve_layout(mesh)
        params = shard_params(cfg, params_from_jax(
            cfg, _unflatten(inp, "llama_tiny/"), "cpu"), lay)
        kw = dict(max_slots=task["max_slots"], max_len=task["max_len"],
                  block_size=task["block_size"], device="cpu", layout=lay,
                  host_blocks=var["host_blocks"],
                  spill_blocks=var["spill_blocks"])
        if rank == 0:
            lead(MultihostPagedServeEngine(cfg, params, **kw), cfg, task,
                 var, out)
        else:
            eng = PagedServeEngine(cfg, params, **kw)
            out[f"{var['name']}_replayed"] = np.array(follower_loop(eng))
            out[f"{var['name']}_follower_tiers"] = np.array(
                eng.tiers is not None)


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
