"""Training launcher: what a training pod runs, on one CUDA device.

Port of ``kuberay_tpu/train/launcher.py``'s single-device path:

    python -m kuberay_tpu_torch.train.launcher --model llama_1b --steps 1000 \\
        --data /data/shard.bin

It builds the seeded train state (``train_step.init_train_state``), reads
batches from a token shard (or, without ``--data``, from a synthetic shard
of 2,000,000 seeded tokens written to a temporary directory), runs
``make_train_step`` and prints ``step N loss L tok/s T`` every
``--log-every`` steps, as the JAX launcher does.  The card is the default;
``--device cpu`` runs the plain paths.

Not ported yet, and refused rather than ignored: tensor and sequence
parallelism (``--tp``/``--sp`` > 1, ROADMAP C5/C6), checkpointing
(``--checkpoint-dir``) and coordinator step heartbeats
(``--heartbeat-every``), both ROADMAP C7.  The JAX launcher's Prometheus
``/metrics`` server, its coordinator events and the native C++ data loader
also wait for C7; the multi-process ``WorkerIdentity`` env contract for
C5.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.train.data import TokenShardLoader, synthetic_shard
from kuberay_tpu_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_optimizer,
    make_train_step,
    torch_dtype,
)
from kuberay_tpu_torch.utils.device import resolve_device


def train(args) -> int:
    if (args.tp or 1) > 1 or args.sp > 1:
        raise NotImplementedError(
            "--tp/--sp > 1: tensor and sequence parallelism are not ported "
            "yet (ROADMAP C5, C6)")
    if args.checkpoint_dir:
        raise NotImplementedError(
            "--checkpoint-dir: checkpointing is not ported yet (ROADMAP C7)")
    if args.heartbeat_every:
        raise NotImplementedError(
            "--heartbeat-every: coordinator step heartbeats are not ported "
            "yet (ROADMAP C7)")
    device = resolve_device(args.device)
    cfg = llama.CONFIGS[args.model]
    tc = TrainConfig(learning_rate=args.lr,
                     warmup_steps=min(args.warmup, max(1, args.steps // 10)),
                     decay_steps=args.steps,
                     param_dtype=args.param_dtype, mu_dtype=args.mu_dtype,
                     grad_accum=args.grad_accum)
    optimizer = make_optimizer(tc)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(cfg, optimizer, gen, tc.param_dtype, device)
    step_fn = make_train_step(cfg, tc, optimizer)

    def put(raw):
        return {k: torch.from_numpy(raw[k]).to(device)
                for k in ("tokens", "targets")}

    with tempfile.TemporaryDirectory(prefix="train-shard-") as tmp:
        path = args.data
        if not path:
            path = os.path.join(tmp, "synthetic.bin")
            synthetic_shard(path, 2_000_000, cfg.vocab_size, args.seed)
        loader = TokenShardLoader(path, args.seq_len, args.batch,
                                  seed=args.seed)
        try:
            return _train_loop(args, state, step_fn, loader, put)
        finally:
            loader.close()


def _train_loop(args, state, step_fn, loader, put) -> int:
    t0 = time.perf_counter()
    for i in range(state["step"], args.steps):
        state, metrics = step_fn(state, put(loader.next()))
        if (i + 1) % args.log_every == 0:
            loss = float(metrics["loss"])           # waits for the step
            dt = time.perf_counter() - t0
            tok_s = args.batch * args.seq_len * args.log_every / dt
            print(f"step {i + 1} loss {loss:.4f} tok/s {tok_s:.0f}",
                  flush=True)
            t0 = time.perf_counter()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kuberay-tpu-torch-train")
    ap.add_argument("--model", default="llama_1b",
                    choices=sorted(llama.CONFIGS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per optimizer step (batch must "
                         "divide by it)")
    ap.add_argument("--param-dtype", default="",
                    help="master-weight dtype (e.g. float32 with a bf16 "
                         "model); default: model compute dtype")
    ap.add_argument("--mu-dtype", default="",
                    help="Adam first-moment dtype (bfloat16 halves that "
                         "optimizer slice)")
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--data", default="", help="token shard path")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--heartbeat-every", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain paths)")
    args = ap.parse_args(argv)
    for flag in ("param_dtype", "mu_dtype"):
        val = getattr(args, flag)
        if val:
            try:
                torch_dtype(val)
            except ValueError as e:
                ap.error(f"--{flag.replace('_', '-')}: {e}")
    return train(args)


if __name__ == "__main__":
    sys.exit(main())
