"""Entry points of the port: the counterparts of the JAX package's
``__graft_entry__.py``.

- ``entry(device="cuda")`` returns ``(fn, (params, tokens))``:
  ``fn(params, tokens)`` is the ``llama_1b`` forward (float32 logits) at 1
  x 512 with seed-0 params, on the card; ``device="cpu"`` is how tests
  call it.  Without a card it raises (no CPU fallback).
- ``dryrun_multichip(n)`` starts ``n`` ranks (one process each, a
  ``torch.distributed`` group over ``tcp://localhost``) and runs the blocks
  of the JAX dry run this port has: one sharded train step at
  ``llama_tiny`` over the framework's (dp, fsdp, tp) factorisation of
  ``n``; the sp ring over all ``n``; Mixtral's MoE forward over ep = 2;
  and, when 4 divides ``n``, one step over a 2-slice multi-slice mesh.
  Then tensor-parallel serving: the first 4 ranks (2 when 4 does not
  divide ``n``) form a group of their own and serve ``llama_tiny`` (2 kv
  heads, so tp=4 is tp=2 x tpr=2) through the lockstep engine
  (``serve/multihost.py``), rank 0 generating 4 tokens.  When 2 divides
  ``n``, the pipeline block: a seeded 4-layer ``tanh(h @ w)`` stack
  through ``parallel/pipeline.py::pipeline_apply`` over pp = 2 (fsdp
  absorbing the rest), 2 microbatches, as the JAX dry run's.  Rank 0
  prints each block's line.  NCCL needs a card a rank;
  ``backend="gloo"`` on the card stages the model's collectives and the
  pipeline's hops through host memory (``spmd.HostStagedGloo``), but not
  the sp ring's exchange.

    python -m kuberay_tpu_torch.entry [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

from kuberay_tpu_torch.models import llama, mixtral
from kuberay_tpu_torch.parallel import spmd
from kuberay_tpu_torch.parallel.mesh import MeshSpec
from kuberay_tpu_torch.parallel.pipeline import pipeline_apply
from kuberay_tpu_torch.parallel.ring import ring_attention
from kuberay_tpu_torch.serve.engine import Request, ServeEngine
from kuberay_tpu_torch.serve.multihost import (
    MultihostServeEngine,
    follower_loop,
)
from kuberay_tpu_torch.serve.sharding import (
    init_sharded_params,
    serve_layout,
    serve_mesh,
)
from kuberay_tpu_torch.train.train_step import (
    TrainConfig,
    make_sharded_train_fns,
    state_shardings,
)
from kuberay_tpu_torch.utils.device import resolve_device


def entry(device="cuda"):
    """-> (fn, example_args): the flagship model's forward."""
    dev = resolve_device(device)
    cfg = llama.CONFIGS["llama_1b"]
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)
    tokens = torch.zeros((1, 512), dtype=torch.int32, device=dev)

    def fn(params, tokens):
        with torch.no_grad():
            return llama.forward(cfg, params, tokens)

    return fn, (params, tokens)


def _factors(n: int):
    """(dp, fsdp, tp) as the JAX dry run factors n: tp the innermost 2,
    fsdp the next 2, dp the rest."""
    tp = 2 if n % 2 == 0 else 1
    rest = n // tp
    fsdp = 2 if rest % 2 == 0 else 1
    return rest // fsdp, fsdp, tp


def _step(cfg, mesh, batch_size: int, seed: int, device) -> float:
    tc = TrainConfig(warmup_steps=2, decay_steps=10)
    init, step, _ = make_sharded_train_fns(cfg, tc, mesh)
    state = init(torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, 16), generator=gen,
                           device=device, dtype=torch.int32)
    _, m = step(state, {"tokens": tokens,
                        "targets": torch.roll(tokens, -1, 1)})
    loss = float(m["total_loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return loss


def _serve_tp(n: int) -> int:
    """The dry run's serving group: 4 ranks when 4 divides n, else 2."""
    return 4 if n % 4 == 0 else 2


def _rank_main(rank: int, n: int, port: int, device: str, backend: str,
               serve_port: int = 0):
    dev = resolve_device(device)
    torch.set_num_threads(1)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    _blocks(rank, n, port, dev, backend)
    if n >= 2 and rank < _serve_tp(n):
        _serve_block(rank, _serve_tp(n), serve_port, dev, backend)


def _serve_block(rank: int, tp: int, port: int, dev, backend: str) -> None:
    """Tensor-parallel serving over a group of ``tp`` ranks: seeded shards
    of ``llama_tiny``, rank 0's lockstep engine, the others following."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=tp)
    try:
        cfg = llama.CONFIGS["llama_tiny"]
        layout = serve_layout(serve_mesh(tp, n_kv_heads=cfg.n_kv_heads,
                                         device_type=dev.type))
        params = init_sharded_params(cfg, 9, layout)
        kw = dict(max_slots=2, max_len=64, device=dev, layout=layout)
        if rank > 0:
            follower_loop(ServeEngine(cfg, params, **kw))
            return
        eng = MultihostServeEngine(cfg, params, **kw)
        eng.add_request(Request("dryrun", [1, 2, 3, 4], max_new_tokens=4))
        resp = eng.run()
        eng.stop()
        if not resp or len(resp[0].tokens) != 4:
            raise AssertionError(f"dry-run serving gave {resp}")
        print(f"dryrun serve ok: tp={layout.size('tp')} x "
              f"tpr={layout.size('tpr')} engine generated "
              f"{len(resp[0].tokens)} tokens", flush=True)
    finally:
        dist.destroy_process_group()


def _blocks(rank: int, n: int, port: int, dev, backend: str):
    """Every block but serving, over one group of all ``n`` ranks."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)

    def say(line: str):
        if rank == 0:
            print(line, flush=True)

    try:
        cfg = llama.CONFIGS["llama_tiny"]
        dp, fsdp, tp = _factors(n)
        mesh = MeshSpec(dp=dp, fsdp=fsdp, tp=tp).build(dev.type)
        loss = _step(cfg, mesh, dp * fsdp * 2, 1, dev)
        say(f"dryrun_multichip ok: mesh dp={dp} fsdp={fsdp} tp={tp} "
            f"loss={loss:.4f}")
        if n < 2:
            return
        # The sp ring over every rank: this rank's shard of seeded q/k/v.
        sp_mesh = MeshSpec(dp=1, fsdp=1, tp=1, sp=n).build(dev.type)
        gen = torch.Generator(device=dev).manual_seed(2)
        S = 8 * n
        q, k, v = (torch.randn(1, S, h, 8, generator=gen, device=dev)
                   for h in (4, 2, 2))
        sl = slice(rank * 8, (rank + 1) * 8)
        out = ring_attention(q[:, sl], k[:, sl], v[:, sl], sp_mesh,
                             causal=True)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite ring attention output")
        say(f"dryrun sp ok: ring attention over sp={n}")
        # The pipeline over pp = 2: the JAX dry run's stack and shapes.
        pp = 2 if n % 2 == 0 else 1
        if pp > 1:
            pp_mesh = MeshSpec(pp=pp, fsdp=-1).build(dev.type)
            stack = {"w": torch.randn(
                4, 8, 8, generator=torch.Generator(device=dev).manual_seed(3),
                device=dev) * 0.3}
            x = torch.randn(4, 8, device=dev, generator=torch.Generator(
                device=dev).manual_seed(4))
            with torch.no_grad():
                y = pipeline_apply(lambda h, lp: torch.tanh(h @ lp["w"]),
                                   stack, x, pp_mesh, n_microbatches=2)
            if not bool(torch.isfinite(y).all()):
                raise AssertionError("non-finite pipeline output")
            say(f"dryrun pp ok: {pp}-stage pipeline")
        mcfg = mixtral.CONFIGS["mixtral_tiny"]
        ep = 2 if (mcfg.n_experts % 2 == 0 and n % 2 == 0) else 1
        if ep > 1:
            fsdp_ep = n // ep if mcfg.d_model % (n // ep) == 0 else 1
            ep_mesh = MeshSpec(dp=-1, fsdp=fsdp_ep, ep=ep).build(dev.type)
            lay = spmd.layout_of(ep_mesh)
            full = mixtral.init_params(
                mcfg, torch.Generator(device=dev).manual_seed(5), dev)
            params = _shard(full, state_shardings(mcfg, lay)["params"])
            gen = torch.Generator(device=dev).manual_seed(6)
            tokens = torch.randint(0, mcfg.vocab_size,
                                   (max(2, lay.batch_shards), 16),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
            with torch.no_grad():
                logits, _ = mixtral.forward(mcfg, params,
                                            lay.local_rows(tokens), ep_mesh)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("non-finite MoE logits")
            say(f"dryrun ep ok: MoE over ep={ep}")
        if n % 4 == 0:
            ms_mesh = MeshSpec(dp=2, fsdp=-1, tp=2).build_multislice(
                2, device_type=dev.type)
            loss = _step(cfg, ms_mesh, 2 * (n // 4) * 2, 8, dev)
            say(f"dryrun multislice ok: 2 slices x {n // 2} ranks (dp "
                f"over DCN) loss={loss:.4f}")
    finally:
        dist.destroy_process_group()


def _shard(tree, specs):
    if isinstance(tree, dict):
        return {k: _shard(v, specs[k]) for k, v in tree.items()}
    return specs.shard(tree)


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str = "", timeout: float = 600.0) -> None:
    """One sharded train step (and the other ported blocks) over
    ``n_devices`` ranks, each its own process; raises if any rank
    fails."""
    resolve_device(device)
    port, serve_port = _free_ports(2)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [root, os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kuberay_tpu_torch.entry", "--rank", str(r),
         str(n_devices), "--port", str(port), "--serve-port",
         str(serve_port), "--device", device, "--backend", backend],
        env=env) for r in range(n_devices)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    if any(codes):
        raise RuntimeError(f"dryrun_multichip: rank exit codes {codes}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kuberay-tpu-torch-entry")
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="")
    ap.add_argument("--rank", type=int, default=None,
                    help="run one rank (how dryrun_multichip starts them)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--serve-port", type=int, default=0,
                    help="the serving group's rendezvous port")
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.n, args.port, args.device, args.backend,
                   args.serve_port)
    else:
        dryrun_multichip(args.n, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
