"""Benchmark: training throughput of the flagship stack on one card.

    python -m kuberay_tpu_torch.bench [--cpu] [--op] [--profile-out PATH]

The counterpart of the JAX package's ``bench.py``: prints one JSON line,
``{"metric", "value", "unit", "vs_baseline", "detail"}`` with the same
keys.

- Default: ``make_train_step`` at ``llama_1b`` (bf16, full remat, the
  flash kernels and Triton RMSNorm), 4 x 2048, one warm-up step then 10
  timed steps on the card; the step time is the median of each step's
  CUDA events.  ``value`` is tokens/s, ``vs_baseline`` model FLOPs
  utilisation (6 N + 12 L d S FLOPs a token, as the JAX bench counts)
  against the card's dense bf16 peak, from ``PEAK_BF16_TFLOPS`` keyed by
  ``torch.cuda.get_device_name()``; ``detail.mfu_note`` names the card and
  peak assumed (0.0 for a card the table lacks).
  ``BENCH_REMAT_POLICY=dots`` as in the JAX bench.
- ``--cpu``: ``llama_tiny`` at 2 x 128, 3 steps, on the CPU (the plain
  paths; the JAX bench's smoke mode); runs only when asked.
- ``--profile-out PATH``: each timed step is also fenced by its loss's
  host fetch and recorded as a ``train-step`` trace (``obs/trace.py``'s
  ``Tracer``) with two spans, ``dispatch`` (the step's call returning)
  and ``host-fetch`` (the loss's ``.item()``, where the device's time
  lands); the ``tpu-profile/v1`` document of those traces
  (``obs/profile.py::profile_spans``, shape ``train``, with the run's
  model, batch, seq, steps and device as ``meta``) is written to PATH,
  as the JAX bench writes it.  The stdout line is the same.
- ``--op``: the port's ``flash_attention`` forward against SDPA at B 4,
  S 2048, 16/8 heads of 128, causal, bf16 (20 chained calls between CUDA
  events after a warm-up); ``vs_baseline`` is SDPA's time over the
  kernel's.

Not ported: the JAX bench's retries over smaller configs and its device
wait and CPU fallback (``tpu_probe``, ``wait_for_tpu``,
``emit_fallback``); a failure here raises (ROADMAP §C).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.obs.profile import profile_spans
from kuberay_tpu_torch.obs.trace import Tracer
from kuberay_tpu_torch.ops.attention import flash_attention
from kuberay_tpu_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from kuberay_tpu_torch.utils.device import resolve_device

# Dense (no sparsity) bf16 tensor-core peaks, TFLOP/s, from NVIDIA's data
# sheets, keyed by a substring of torch.cuda.get_device_name().
PEAK_BF16_TFLOPS = {
    "H100 80GB HBM3": 989.0,        # H100 SXM5
    "H100 NVL": 835.0,
    "H100 PCIe": 756.0,
    "H200": 989.0,
    "A100": 312.0,
}


def peak_tflops(name: str) -> Optional[float]:
    for key, peak in PEAK_BF16_TFLOPS.items():
        if key in name:
            return peak
    return None


def flops_per_token(cfg, n_params: int, seq: int) -> float:
    """Training FLOPs a token: 6 N for the weights' products, forward and
    backward, and 12 L d S for attention's (as the JAX bench counts)."""
    return 6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * seq


def _step_times_ms(step, state, batch, steps: int, device,
                   tracer: Optional[Tracer] = None, model: str = ""):
    """Each step's time (CUDA events on the card, the host clock on the
    CPU) and the state and metrics after the last.  With ``tracer``, each
    step is fenced by its loss's host fetch and recorded as a
    ``train-step`` trace of a ``dispatch`` and a ``host-fetch`` span."""
    cuda = device.type == "cuda"
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(steps)] if cuda else []
    dts, m = [], None
    for i in range(steps):
        t0 = time.perf_counter()
        if cuda:
            events[i][0].record()
        state, m = step(state, batch)
        t1 = time.perf_counter()
        if cuda:
            events[i][1].record()
        if tracer is not None or not cuda:
            m["total_loss"].item()
        t2 = time.perf_counter()
        if not cuda:
            dts.append((t2 - t0) * 1e3)
        if tracer is not None:
            ctx = tracer.start_request("train-step", ts=t0, model=model)
            tracer.record_span(ctx, "dispatch", t0, t1)
            tracer.record_span(ctx, "host-fetch", t1, t2)
            tracer.finish_request(ctx, ts=t2)
    if cuda:
        torch.cuda.synchronize()
        dts = [s.elapsed_time(e) for s, e in events]
    return dts, state, m


def write_profile(path: str, tracer: Tracer, meta: dict) -> None:
    """The traces' ``tpu-profile/v1`` document at ``path`` (sorted keys,
    as the JAX bench writes it)."""
    doc = profile_spans(tracer.export(), roots={"train-step": "train"},
                        meta=meta)
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, sort_keys=True)
    print(f"profile -> {path}", file=sys.stderr)


def bench_train(cpu: bool, profile_out: str = "") -> dict:
    device = resolve_device("cpu" if cpu else "cuda")
    model, batch, seq, steps = (("llama_tiny", 2, 128, 3) if cpu
                                else ("llama_1b", 4, 2048, 10))
    cfg = llama.CONFIGS[model]
    remat_policy = os.environ.get("BENCH_REMAT_POLICY", "")
    if remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    tc = TrainConfig(warmup_steps=2, decay_steps=1000)
    optimizer = make_optimizer(tc)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(cfg, optimizer, gen, device=device)
    step = make_train_step(cfg, tc, optimizer)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator(device=device
                                                     ).manual_seed(1),
                           device=device, dtype=torch.int32)
    data = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    state, m = step(state, data)                       # warm-up
    float(m["total_loss"])
    tracer = Tracer(max_spans=8192) if profile_out else None
    dts, state, m = _step_times_ms(step, state, data, steps, device,
                                   tracer, model)
    dt_step = sorted(dts)[len(dts) // 2] / 1e3
    tok_s = batch * seq / dt_step
    n_params = cfg.num_params()
    achieved = tok_s * flops_per_token(cfg, n_params, seq) / 1e12
    name = "cpu" if cpu else torch.cuda.get_device_name(0)
    if tracer is not None:
        write_profile(profile_out, tracer, {
            "source": "kuberay_tpu_torch.bench", "model": model,
            "batch": batch, "seq": seq, "steps": steps, "device": name})
    peak = None if cpu else peak_tflops(name)
    mfu = achieved / peak if peak else 0.0
    note = (f"vs_baseline is MFU vs {name}'s dense bf16 peak, {peak} "
            f"TFLOP/s (PEAK_BF16_TFLOPS)" if peak else
            f"no dense bf16 peak known for {name}; vs_baseline 0")
    return {
        "metric": "llama1b_train_tokens_per_sec_per_chip",
        "value": round(tok_s, 1),
        "unit": "tokens/s/chip",
        "vs_baseline": round(mfu, 4),
        "detail": {
            "model": f"{model}(smoke)" if cpu else model,
            "params": n_params,
            "batch": batch, "seq": seq, "steps": steps,
            "achieved_tflops": round(achieved, 2),
            "mfu_note": note,
            "loss": float(m["total_loss"]),
            "device": name,
        },
    }


def bench_attention_op() -> dict:
    """The port's flash_attention forward against SDPA on the card."""
    device = resolve_device("cuda")
    B, S, Hq, Hkv, D = 4, 2048, 16, 8, 128
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device=device,
                           dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv))

    def sdpa(q, k, v):
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
        return o.transpose(1, 2)

    results = {}
    for name, fn in (("cuda", lambda q: flash_attention(q, k, v, True)),
                     ("sdpa", lambda q: sdpa(q, k, v))):
        with torch.no_grad():
            out = fn(q)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):          # chained: out feeds the next q
                out = fn(out)
            end.record()
            end.synchronize()
        results[f"{name}_ms"] = round(start.elapsed_time(end) / 20, 4)
    return {
        "metric": "flash_attention_fwd_ms",
        "value": results["cuda_ms"],
        "unit": "ms",
        "vs_baseline": round(results["sdpa_ms"] / results["cuda_ms"], 2),
        "detail": {**results,
                   "shape": f"B{B} S{S} H{Hq}/{Hkv} D{D} bf16",
                   "device": torch.cuda.get_device_name(0)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kuberay-tpu-torch-bench")
    ap.add_argument("--cpu", action="store_true",
                    help="llama_tiny smoke on the CPU")
    ap.add_argument("--op", action="store_true",
                    help="flash attention forward vs SDPA on the card")
    ap.add_argument("--profile-out", default="", metavar="PATH",
                    help="write the timed steps' tpu-profile/v1 document "
                         "(dispatch and host-fetch spans a step) to PATH")
    args = ap.parse_args(argv)
    line = bench_attention_op() if args.op else \
        bench_train(args.cpu, args.profile_out)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
