"""Training launcher: what a training pod runs, one process a CUDA device.

Port of ``kuberay_tpu/train/launcher.py``:

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

The card is the default; ``--device cpu`` runs the plain paths.

A slice of more than one process (``TPU_WORKER_HOSTNAMES`` /
``TPU_NUM_PROCESSES``, and ``MEGASCALE_*`` for several slices) joins one
``torch.distributed`` group (``initialize_distributed``: ``tcp://`` to
worker 0 on the coordinator port, one process a card) and trains over
``build_mesh``'s mesh: ``--tp`` (default: the cards of one host), ``--sp``
(the model's attention then runs the kernel ring, ``ring_rdma``) and
``--ep``, fsdp absorbing the rest, dp across slices
(``make_sharded_train_fns``).  Every rank reads the same global batch
and sends its own rows to its card; worker 0 alone prints, serves
``/metrics`` and posts the lead's events; every rank saves its own
chunks of the checkpoint.  ``--dist-backend gloo`` puts the collectives
on gloo (two ranks sharing one card: NCCL refuses that); on CUDA tensors
they are then staged through pinned host buffers
(``spmd.HostStagedGloo``, printed at start).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
import tempfile
import time
from http.server import ThreadingHTTPServer
from typing import Optional

import torch

import torch.distributed as dist

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.parallel import spmd
from kuberay_tpu_torch.parallel.mesh import MeshSpec
from kuberay_tpu_torch.runtime import coordinator_client
from kuberay_tpu_torch.train import checkpoint as ckpt
from kuberay_tpu_torch.train.data import TokenShardLoader, synthetic_shard
from kuberay_tpu_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_optimizer,
    make_sharded_train_fns,
    make_train_step,
    model_of,
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


def initialize_distributed(ident: Optional[WorkerIdentity] = None,
                           backend: str = "", device="cuda",
                           port: int = 0) -> WorkerIdentity:
    """``init_process_group`` from the env's identity, then a barrier (every
    rank has joined): ``tcp://`` to worker 0 at the coordinator address
    (``port``, if given, replaces its port), ``global_process_count``
    ranks, this one ``global_process_id``; backend NCCL on the card and
    gloo on the CPU unless ``backend`` says.  On the card, one process a
    card: the device is ``LOCAL_RANK`` (default: the global rank) modulo
    the host's cards.  A single host is a no-op unless ``backend`` is
    given (a group of one, on 127.0.0.1)."""
    ident = ident or WorkerIdentity.from_env()
    if not ident.is_distributed and not backend:
        return ident
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", ident.global_process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    host, _, coord_port = ident.coordinator.rpartition(":")
    addr = f"tcp://{host or '127.0.0.1'}:{port or coord_port or C.PORT_MXLA}"
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=addr, world_size=ident.global_process_count,
        rank=ident.global_process_id)
    dist.barrier()
    return ident


def build_mesh(tp: Optional[int] = None, sp: int = 1, ep: int = 1,
               num_slices: Optional[int] = None, device_type: str = "cuda"):
    """One mesh over every process of the group (as the JAX launcher's):
    fsdp absorbs what tp, sp and ep leave; under multi-slice dp crosses
    the slices and everything else stays within one
    (``MeshSpec.build_multislice``).  ``tp`` defaults to the cards of one
    host (the chips of one TPU host in the JAX package), 1 on the CPU."""
    n = dist.get_world_size()
    if tp is None:
        tp = min(n, torch.cuda.device_count()) if device_type == "cuda" \
            else 1
    if num_slices is None:
        num_slices = WorkerIdentity.from_env().num_slices
    if num_slices > 1:
        return MeshSpec(dp=num_slices, fsdp=-1, tp=tp, sp=sp,
                        ep=ep).build_multislice(num_slices,
                                                device_type=device_type)
    return MeshSpec(dp=1, fsdp=-1, tp=tp, sp=sp, ep=ep).build(device_type)


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
    the job's name, the model's global size, the card's peak and the
    number of cards (one a process)."""

    events: Optional[coordinator_client.CoordinatorClient]
    prom: Optional[MetricsRegistry]
    job_id: str
    n_params: int
    peak_tflops: float
    device_count: int = 1


def train(args) -> int:
    device = resolve_device(args.device)
    ident = initialize_distributed(None, args.dist_backend, device,
                                   args.dist_port)
    try:
        return _train(args, ident, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, ident: WorkerIdentity, device: torch.device) -> int:
    cfg = llama.CONFIGS[args.model]
    if args.sp > 1 and cfg.attn_impl not in ("ring", "ring_rdma"):
        # The sequence split over sp attends through the ring (JAX's GSPMD
        # gathers the sequence for its flash kernel instead; same math).
        cfg = dataclasses.replace(cfg, attn_impl="ring_rdma")
    tc = TrainConfig(learning_rate=args.lr,
                     warmup_steps=min(args.warmup, max(1, args.steps // 10)),
                     decay_steps=args.steps,
                     param_dtype=args.param_dtype, mu_dtype=args.mu_dtype,
                     grad_accum=args.grad_accum)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    layout, shardings = None, None
    if dist.is_initialized():
        mesh = build_mesh(args.tp, args.sp, args.ep, ident.num_slices,
                          device.type)
        layout = spmd.layout_of(mesh)
        if layout.host_staged and ident.global_process_id == 0:
            print(f"collectives: {spmd.HostStagedGloo.name} (gloo on CUDA "
                  f"tensors, staged through pinned host buffers)",
                  flush=True)
        init, step_fn, shardings = make_sharded_train_fns(cfg, tc, mesh)
        # The loop sends each rank its own rows (device_batch).
        step_fn = functools.partial(step_fn, rows_local=True)
        state = init(gen)
    else:
        # One process: refused (the mesh's own error) unless every axis is 1.
        MeshSpec(dp=1, fsdp=-1, tp=args.tp or 1, sp=args.sp,
                 ep=args.ep).resolve(1)
        optimizer = make_optimizer(tc)
        state = init_train_state(cfg, optimizer, gen, tc.param_dtype, device)
        step_fn = make_train_step(cfg, tc, optimizer)
    if args.checkpoint_dir:
        restored = ckpt.restore_latest(args.checkpoint_dir, state, shardings)
        if restored is not None:
            state = restored

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
                n_params=spmd.global_numel(
                    state["params"], model_of(cfg).param_axes(cfg), layout),
                peak_tflops=float(os.environ.get("TPU_PEAK_TFLOPS", "0")),
                device_count=dist.get_world_size()
                if dist.is_initialized() else 1)
            if args.checkpoint_dir:
                writer = ckpt.CheckpointWriter(args.checkpoint_dir,
                                               shardings=shardings)
            rows = (lambda t: t) if layout is None else layout.local_rows
            return _train_loop(args, ident, state, step_fn, loader, writer,
                               tel, device, rows)
        finally:
            loader.close()
            if prom_srv is not None:
                prom_srv.shutdown()
                prom_srv.server_close()
            if writer is not None:
                # Drain the write in flight on every exit path: a failure
                # mid-loop must not abandon a half-committed checkpoint.
                writer.close()


def device_batch(raw, device: torch.device, rows=lambda t: t) -> dict:
    """A loader batch on ``device`` (``rows``: this rank's rows of it): on
    the card from pinned memory and without waiting, so the copy queues
    behind the step that is running."""
    out = {}
    for k in ("tokens", "targets"):
        t = rows(torch.from_numpy(raw[k])).contiguous()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _post(tel: _Telemetry, events: list) -> None:
    try:
        tel.events.post_events(events)
    except coordinator_client.CoordinatorError:
        tel.events = None              # coordinator gone: stop trying


def _train_loop(args, ident, state, step_fn, loader, writer, tel,
                device, rows) -> int:
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
    next_batch = (device_batch(loader.next(), device, rows)
                  if start_step < args.steps else None)
    for i in range(start_step, args.steps):
        batch = next_batch
        state, metrics = step_fn(state, batch)
        if i + 1 < args.steps:
            # Read and sent while the step runs on the device.
            next_batch = device_batch(loader.next(), device, rows)
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
                beats[-1]["args"]["device_count"] = tel.device_count
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
                    # 6 N flops a token (forward and backward), per card.
                    achieved = 6.0 * tel.n_params * tok_s / 1e12 / max(
                        1, tel.device_count)
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
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor parallel ranks (default: the cards of one "
                         "host)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence parallel ranks (the model's attn_impl "
                         "must be a ring)")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert parallel ranks")
    ap.add_argument("--dist-backend", default="", choices=("", "nccl",
                                                           "gloo"),
                    help="torch.distributed backend of a multi-process "
                         "slice (default: nccl on the card, gloo on the "
                         "cpu; given on a single host, a group of one); "
                         "gloo on the card stages collectives through "
                         "pinned host buffers")
    ap.add_argument("--dist-port", type=int, default=0,
                    help="port of the process group's rendezvous on "
                         "worker 0 (default: the coordinator port)")
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
