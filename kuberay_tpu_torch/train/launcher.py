"""Training launcher: what a training pod runs, on one CUDA device.

Port of ``kuberay_tpu/train/launcher.py`` for one process:

    python -m kuberay_tpu_torch.train.launcher --model llama_1b --steps 1000 \\
        --data /data/shard.bin --checkpoint-dir /ckpt

It reads the slice identity the operator injects (``WorkerIdentity``),
builds the seeded train state (``train_step.init_train_state``), resumes
from the newest committed checkpoint under ``--checkpoint-dir``, reads
batches from a token shard (or, without ``--data``, from a synthetic
shard of 2,000,000 seeded tokens written to a temporary directory) and
runs ``make_train_step``, printing ``step N loss L tok/s T`` every
``--log-every`` steps as the JAX launcher does.  The next batch goes to
the device (through pinned memory) while the step runs.  Every
``--checkpoint-every`` steps the state is saved asynchronously
(``train/checkpoint.py``), and once more at the end unless the last
periodic save covered it.  A resumed run's loader starts again from the
seed, as the JAX launcher's does: step k + 1 of a resumed run trains on
the seed's first batch.

With ``TPU_COORDINATOR_ADDRESS`` set, every worker posts step heartbeats
(batches of ``--heartbeat-every`` steps, default the log interval) and
the lead a ``train_step`` event each log interval, in the JAX launcher's
event format; a coordinator that goes away stops the posting, not the
run.  Worker 0 serves the ``tpu_train_*`` gauges as Prometheus text on
``TPU_TRAIN_METRICS_PORT`` (default ``PORT_METRICS``; 0 turns it off).
MFU needs ``TPU_PEAK_TFLOPS``, the card's peak.

The card is the default; ``--device cpu`` runs the plain paths.  Not
ported yet, and refused rather than ignored: ``--tp``/``--sp`` > 1 and a
slice of more than one process (ROADMAP A8: the multi-process layouts on
``init_process_group``).  The sp ring runs through
``train_step.make_sharded_train_fns`` (over a ``LocalRing`` on one card,
or a ``DeviceMesh`` of processes the caller starts).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from http.server import ThreadingHTTPServer
from typing import Optional

import torch

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.runtime import coordinator_client
from kuberay_tpu_torch.train import checkpoint as ckpt
from kuberay_tpu_torch.train.data import TokenShardLoader, synthetic_shard
from kuberay_tpu_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_optimizer,
    make_train_step,
    torch_dtype,
)
from kuberay_tpu_torch.utils import constants as C
from kuberay_tpu_torch.utils.device import resolve_device
from kuberay_tpu_torch.utils.httpjson import JsonHandler, serve_background
from kuberay_tpu_torch.utils.metrics import MetricsRegistry


@dataclasses.dataclass
class WorkerIdentity:
    """The slice identity the operator injects (a copy of the JAX
    launcher's parser)."""

    worker_id: int
    num_workers: int
    hostnames: list
    topology: str
    coordinator: str          # multi-process coordinator address
    num_slices: int = 1
    slice_id: int = 0

    @classmethod
    def from_env(cls, env=None) -> "WorkerIdentity":
        e = env or os.environ
        hostnames = [h for h in e.get(C.ENV_TPU_WORKER_HOSTNAMES, "").split(",")
                     if h]
        num = int(e.get(C.ENV_NUM_PROCESSES, len(hostnames) or 1))
        # The coordinator is worker 0 (stable DNS through the headless
        # service) on the MXLA port; a single host has none.
        coord = hostnames[0] + f":{C.PORT_MXLA}" if hostnames else ""
        return cls(
            worker_id=int(e.get(C.ENV_TPU_WORKER_ID, "0")),
            num_workers=num,
            hostnames=hostnames,
            topology=e.get(C.ENV_TPU_TOPOLOGY, ""),
            coordinator=coord,
            num_slices=int(e.get(C.ENV_MEGASCALE_NUM_SLICES, "1")),
            slice_id=int(e.get(C.ENV_MEGASCALE_SLICE_ID, "0")),
        )

    @property
    def is_distributed(self) -> bool:
        return self.num_workers > 1 or self.num_slices > 1

    @property
    def global_process_id(self) -> int:
        return self.slice_id * self.num_workers + self.worker_id

    @property
    def global_process_count(self) -> int:
        return self.num_slices * self.num_workers


def initialize_distributed(ident: Optional[WorkerIdentity] = None
                           ) -> WorkerIdentity:
    """The env's identity; a no-op on a single host.  A slice of more than
    one process is refused until its layouts are ported."""
    ident = ident or WorkerIdentity.from_env()
    if ident.is_distributed:
        raise NotImplementedError(
            f"a slice of {ident.global_process_count} processes: the "
            f"launcher's multi-process layouts (init_process_group from this "
            f"env) are not ported yet (ROADMAP A8)")
    return ident


TRAIN_GAUGES = (
    ("tpu_train_step", "Last completed optimizer step"),
    ("tpu_train_loss", "Training loss at the last log interval"),
    ("tpu_train_tokens_per_sec", "Global training throughput"),
    ("tpu_train_step_seconds", "Mean step wall time"),
    ("tpu_train_mfu", "Model flops utilization vs chip peak"))


def _start_metrics_server(port: int):
    """Prometheus ``/metrics`` for the training process (worker 0).
    Returns (registry, server); a busy port only disables it."""
    reg = MetricsRegistry()
    for name, help_text in TRAIN_GAUGES:
        reg.describe(name, help_text)

    class Handler(JsonHandler):
        def do_GET(self):
            if self.path == "/metrics":
                return self._send_text(200, reg.render(),
                                       "text/plain; version=0.0.4")
            return self._send_text(404, "unknown path")

    try:
        srv = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    except OSError as e:
        print(f"train metrics server disabled: {e}", flush=True)
        return reg, None
    serve_background(srv, "train-metrics")
    return reg, srv


@dataclasses.dataclass
class _Telemetry:
    """What the loop reports to, and about: the coordinator's event
    client (None when off or gone), the Prometheus registry (worker 0),
    the job's name, the model's size and the card's peak.  One process
    trains on one card, so the device count is 1."""

    events: Optional[coordinator_client.CoordinatorClient]
    prom: Optional[MetricsRegistry]
    job_id: str
    n_params: int
    peak_tflops: float


def train(args) -> int:
    if (args.tp or 1) > 1 or args.sp > 1:
        raise NotImplementedError(
            "--tp/--sp > 1: the launcher's multi-process layouts are not "
            "ported yet (ROADMAP A8); the sp ring runs through "
            "train_step.make_sharded_train_fns")
    ident = initialize_distributed()
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
    if args.checkpoint_dir:
        restored = ckpt.restore_latest(args.checkpoint_dir, state)
        if restored is not None:
            state = restored
    step_fn = make_train_step(cfg, tc, optimizer)

    events = None
    if os.environ.get(C.ENV_COORDINATOR_ADDRESS):
        events = coordinator_client.CoordinatorClient(
            coordinator_client.dashboard_url(
                os.environ[C.ENV_COORDINATOR_ADDRESS]), timeout=2.0)
    mport = int(os.environ.get("TPU_TRAIN_METRICS_PORT", C.PORT_METRICS))
    with tempfile.TemporaryDirectory(prefix="train-shard-") as tmp:
        path = args.data
        if not path:
            path = os.path.join(tmp, "synthetic.bin")
            synthetic_shard(path, 2_000_000, cfg.vocab_size, args.seed)
        loader = TokenShardLoader(path, args.seq_len, args.batch,
                                  seed=args.seed)
        prom, prom_srv, writer = None, None, None
        try:
            if ident.worker_id == 0 and ident.slice_id == 0 and mport > 0:
                prom, prom_srv = _start_metrics_server(mport)
            tel = _Telemetry(
                events=events, prom=prom,
                job_id=os.environ.get("TPU_JOB_ID", "train"),
                n_params=sum(p.numel() for p in _leaves(state["params"])),
                peak_tflops=float(os.environ.get("TPU_PEAK_TFLOPS", "0")))
            if args.checkpoint_dir:
                writer = ckpt.CheckpointWriter(args.checkpoint_dir)
            return _train_loop(args, ident, state, step_fn, loader, writer,
                               tel, device)
        finally:
            loader.close()
            if prom_srv is not None:
                prom_srv.shutdown()
                prom_srv.server_close()
            if writer is not None:
                # Drain the write in flight on every exit path: a failure
                # mid-loop must not abandon a half-committed checkpoint.
                writer.close()


def device_batch(raw, device: torch.device) -> dict:
    """A loader batch on ``device``: on the card from pinned memory and
    without waiting, so the copy queues behind the step that is running."""
    out = {}
    for k in ("tokens", "targets"):
        t = torch.from_numpy(raw[k])
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _post(tel: _Telemetry, events: list) -> None:
    try:
        tel.events.post_events(events)
    except coordinator_client.CoordinatorError:
        tel.events = None              # coordinator gone: stop trying


def _train_loop(args, ident, state, step_fn, loader, writer, tel,
                device) -> int:
    last_saved = -1
    is_lead = ident.worker_id == 0 and ident.slice_id == 0
    # "s<slice>w<worker>" names the host fleet-wide; step durations buffer
    # here and post every --heartbeat-every steps (one round trip a batch).
    host = f"s{ident.slice_id}w{ident.worker_id}"
    hb_every = args.heartbeat_every or args.log_every
    hb_buf = []                       # (step, wall seconds) per step

    start_step = int(state["step"])
    t0 = time.time()
    step_t0 = t0
    next_batch = (device_batch(loader.next(), device)
                  if start_step < args.steps else None)
    for i in range(start_step, args.steps):
        batch = next_batch
        state, metrics = step_fn(state, batch)
        if i + 1 < args.steps:
            # Read and sent while the step runs on the device.
            next_batch = device_batch(loader.next(), device)
        if tel.events is not None:
            now = time.time()
            hb_buf.append((i + 1, now - step_t0))
            step_t0 = now
            if (i + 1) % hb_every == 0:
                # One device sync a batch: how long this host waits for
                # the steps it queued, on the batch's last step.
                tw = time.time()
                _sync(device)
                wait = time.time() - tw
                tokens = float(args.batch * args.seq_len)
                beats = [{
                    "type": "step", "name": "step_heartbeat",
                    "job_id": tel.job_id, "host": host,
                    "args": {"step": s, "dur_s": round(d, 6),
                             "tokens": tokens,
                             "collective_wait_s": 0.0},
                } for s, d in hb_buf]
                beats[-1]["args"]["collective_wait_s"] = round(wait, 6)
                beats[-1]["args"]["n_params"] = tel.n_params
                beats[-1]["args"]["device_count"] = 1
                if tel.peak_tflops > 0:
                    beats[-1]["args"]["peak_tflops"] = tel.peak_tflops
                _post(tel, beats)
                hb_buf = []
                step_t0 = time.time()     # the sync is not step 1's
        if (i + 1) % args.log_every == 0 and ident.worker_id == 0:
            loss = float(metrics["loss"])           # waits for the step
            dt = time.time() - t0
            tok_s = args.batch * args.seq_len * args.log_every / dt
            print(f"step {i + 1} loss {loss:.4f} tok/s {tok_s:.0f}",
                  flush=True)
            if tel.prom is not None:
                tel.prom.set_gauge("tpu_train_step", float(i + 1))
                tel.prom.set_gauge("tpu_train_loss", loss)
                tel.prom.set_gauge("tpu_train_tokens_per_sec", tok_s)
                tel.prom.set_gauge("tpu_train_step_seconds",
                                   dt / args.log_every)
                if tel.peak_tflops > 0:
                    # 6 N flops a token (forward and backward), one card.
                    achieved = 6.0 * tel.n_params * tok_s / 1e12
                    tel.prom.set_gauge("tpu_train_mfu",
                                       achieved / tel.peak_tflops)
            if is_lead and tel.events is not None:
                _post(tel, [{
                    "type": "step", "name": "train_step",
                    "job_id": tel.job_id, "ts": time.time() - dt,
                    "dur": dt,
                    "args": {"step": i + 1, "loss": loss,
                             "tokens_per_sec": round(tok_s, 1)}}])
            t0 = time.time()
        if writer is not None and (i + 1) % args.checkpoint_every == 0:
            writer.save_async(state, i + 1)
            last_saved = i + 1
    if writer is not None:
        # A final save unless the last periodic one covered it or the run
        # resumed at or past the last step (which would label a later
        # step's state with an earlier step's number).
        if last_saved != args.steps and start_step < args.steps:
            writer.save_async(state, args.steps)
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
    ap.add_argument("--checkpoint-dir", default="",
                    help="resume from, and save to, this directory "
                         "(torch.distributed.checkpoint, one directory a "
                         "step)")
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--heartbeat-every", type=int, default=0,
                    help="steps per step-heartbeat batch to the "
                         "coordinator; 0 = the log interval")
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
