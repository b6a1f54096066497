#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile]

1. Device: requires a CUDA device (exits non-zero without one) and prints
   its name and power limit.
2. Kernels: builds every kernel from the sources in this checkout, runs each
   kernel's wrapper at the Llama-3-8B shapes the serving path gives it, and
   holds the result against the plain PyTorch version on the same inputs
   (bf16: RMSNorm atol 1.6e-2, one bf16 ulp for |y| < 4; decode attention
   element by element, as the flash kernels below).  Times kernel, plain
   version and one PyTorch library call
   (yardstick only) with CUDA events, eagerly and replayed from a CUDA
   graph (device time without the host's launch cost), and computes each
   kernel's bound.
   The int8 decode kernel likewise (S 8, M 2048, 32 q / 8 kv heads of 128
   with lens 0..2048; M 1000; D 64 group 1), against its plain version
   (dequantise to bf16, then dense) and against the same attention with
   the cache dequantised in float32 (only the output rounded), with SDPA
   over the dequantised bf16 cache as the library yardstick (the
   dequantisation not timed).  The paged kernel at the same serving shape
   with block size 16 and a scrambled table whose slots share some
   physical pages (lens 0..2048, not multiples of 16), and at block size
   8 with D 64; SDPA over the gathered view (the gather not timed) and the
   dense decode kernel at the same live lengths beside it; also the paged
   int8 path's per-layer gather of contiguous int8 views.  All three
   decode kernels are held to the flash kernels' element-wise limits, at
   their first shapes also on lens at split boundaries, every slot full
   and lens 1 beside full slots; each also against its plain
   split-and-merge model, two calls bit for bit the same, and the merge
   kernel alone against its plain version.  Records the split plan, the
   workspace's bytes and the merge's own time; ptxas' registers, static
   shared memory and spills of every decode instantiation (a spill fails
   the run) and each kernel's shared memory a block from the runtime.
   The three flash-attention kernels of the training path likewise, at
   llama_1b's shape (B 4, S 2048, 16 q / 8 kv heads of 128, causal), the
   Llama-3-8B head layout (32 / 8) at S 1024, a ragged S (1000), Skv > Sq,
   D 64 with group 1 (llama_125m), S 960 (which the forward's 128-row
   tile does not divide, the backward's 64-row q steps do), group 8 at D
   64, and the ring's two block shapes (B 2, shards of 1024, llama_1b's
   heads; causal on the diagonal, not causal on past blocks): out and lse
   (atol 1e-4) of the forward, and dQ/dK/dV for a seeded dO, against the
   plain versions, each
   bf16 element within one ulp of its own value plus 2^-5 of its row's
   RMS, and each tensor within 2^-7 in norm; a second launch of each
   backward kernel on the same inputs bit for bit the same.  SDPA
   forward, ATen's flash backward (the yardstick of the dK/dV + dQ pair,
   at llama_1b's shape and the ring's past block) and SDPA
   forward+backward times as yardsticks; ptxas' registers and spills (a
   spill fails the run) and the runtime's shared memory a block of the
   four Hopper attention kernels (flash forward, dK/dV, dQ, ring forward).
   Chunked cross entropy at llama3_8b's head (T 2048, d 4096, V 128256,
   chunk 16384, bf16): loss, dx and dhead against the dense loss.
   The persistent ring-attention kernel (sequence parallelism: every ring
   step of the ranks held here in one launch) at llama_1b's heads, B 2,
   shards of 1024 of a 4096 sequence: one rank that sees 1, 2 and all 4
   blocks (its diagonal, then past ones), LocalRing(4)'s whole ring, the
   same not causal, a ragged shard of 1000, 2 of 3 ranks at shards of 960,
   D 64 with group 1 causal and (2 of 4 ranks, shards of 512) not, each
   against its plain chain (out element by element as the flash kernels,
   lse atol 1e-4) and a second launch bit for bit; in three of them also
   the staged check: the blocks copied into a fresh n-slot buffer (NaN
   until written) on a side stream after the launch, each copy followed by
   its arrival word, bit for bit the in-place result.  Then the whole ring
   over LocalRing(4), ring_attention(impl="rdma") at B 2 x S 4096, forward
   and backward with a seeded dO, against the port's flash_attention over
   the whole sequence element by element, and against the plain ring (the
   forward element by element, the gradients in norm against the plain
   ring run in float32 from the same bf16 values), with one ring kernel
   launch.  Times: the kernel over the ring's shards (one ring forward),
   its plain chain and SDPA (causal, GQA; the library yardstick) over the
   whole sequence, eagerly and from a CUDA graph, with their bounds; and
   ring_attention's forward (the shards' copies included), the plain
   ring's and flash_fwd over the whole sequence.
   For the two kernels on the Hopper forward main loop (flash_fwd and the
   ring forward): achieved TFLOP/s; registers a thread, static shared
   memory and spills at D 64 and 128 from the build's ``-Xptxas -v``
   report (a spill fails the run); and shared memory a block, static and
   dynamic, as the runtime holds it once each has launched at that D.
3. Serve: builds llama3_8b at full width (seeded random bf16 weights)
   once for every serve phase.  Starts ServeEngine(max_slots=8,
   max_len=2048) behind ServeFrontend on 127.0.0.1, POSTs 8 concurrent
   greedy /v1/completions and then the first prompt twice more.  Checks
   every response, that the repeats' tokens equal the batch's, and that
   the launch counts over this phase are exactly 65 RMSNorms per forward
   and 32 decode attentions per decode step.  Then checks the served
   tokens of the first request against a full-recompute (no-cache)
   forward of the same sequence.
   The same weights then serve through PagedServeEngine (block size 16,
   the dense footprint of 1024 blocks) in bf16, then in int8, and through
   ServeEngine with kv_quant="int8": 8 concurrent greedy requests, 4 of
   which share a 512-token prefix, then one of the four twice more.
   Checks the prefix hits (3 x 512 tokens in the batch, every full block
   of the prompt on each repeat), that the two repeats agree (and, for
   the dense engine, equal the batch's tokens: a paged engine prefills
   past however much was cached, and bf16 matmuls of other shapes round
   differently), exact launch counts (32 paged or int8 decode attentions
   per decode step, none of the other decode kernels, 65 RMSNorms per
   forward), and all 32 of the batch's and of the repeat's tokens against
   the bf16 no-cache recompute: within 5% of the largest |logit| for the
   bf16 pool and 10% for int8 (int8 K/V carry about 6x bf16's relative
   rounding error, per element).  Where the repeat leaves the batch's
   tokens, the recompute's logits of the two tokens at the first
   difference are recorded (a near-tie or a fault).
   The serving options at llama3_8b's full width and depth, on the same
   weights, each behind the HTTP frontend with 8 concurrent greedy
   requests and one of them twice more: (a) chunked prefill in chunks of
   256 tokens, through the dense engine on the prompts above and through
   the paged engine on the shared-prefix prompts (same prefix hits);
   (b) speculation with 4-token prompt-lookup drafts, dense and paged:
   two random prompts and six that repeat a seeded phrase of 2-4 tokens,
   each chosen of three by a plain engine's probe (bf16 and int8 weights)
   for the model falling into a loop of its own, which prompt lookup
   then drafts (fails without a verify step); (c) int8 weights through the dense engine, and through the
   paged engine with the int8 pool, chunked prefill and speculation
   together.  Every served token of the batch and of the repeat is held to
   the no-cache recompute of the function served (with int8 weights, the
   dequantised forward).  Launch identities: 65 RMSNorms per forward
   (prefill chunks, decode and verify steps) and 32 decode attentions per
   decode step (chunks and verify steps run the plain multi-query
   attention and launch none).  With int8 weights, the peak memory inside
   every decode step, over what was allocated before the engine, must
   stay within the int8 weights and scales, the cache, one layer's bf16
   weights and 2 GB (no whole bf16 tree).  (d) One streamed request on a
   dense engine with a metrics registry: its NDJSON token lines, joined,
   equal the blocking response's tokens for the same prompt, and GET
   /metrics parses and carries the request-phase histogram for queue,
   prefill and decode.  Each phase's line (TTFT, decode step ms, tokens
   per second and per forward, speculation counters, weight bytes, peak
   memory) is printed beside the card's name and power limit.
4. Train: runs the launcher (``kuberay_tpu_torch.train.launcher.main``)
   on llama_1b at full width and depth, batch 4 x 2048, 8 steps, bf16
   masters, on the synthetic shard; then 8 steps of make_train_step on
   one fixed batch with float32 masters.  Checks every loss and gradient
   norm is finite, the first loss is within 0.3 of ln(V) + 1/2 (the
   expected loss of unit-variance random logits, which is what the
   scaled init gives), the fixed batch's loss falls by at least 0.5, and
   the launch counts per step are exactly 32 flash forwards (16 layers,
   run again under full remat), 16 dK/dV, 16 dQ and 65 RMSNorms.  With
   ``--profile``, one more fixed-batch step runs under torch.profiler:
   device time by kernel name and the device's idle share.
   Then long-context training: llama_1b at full width and depth with
   attn_impl="ring_rdma", B 2 x S 4096 on LocalRing(4) (the sp ring's 4
   ranks on this card), 8 fixed-batch steps of make_sharded_train_fns
   with bf16 masters.  Checks the first loss is within 0.3 of ln(V) + 1/2
   and within 2e-2 of the same batch's loss with attn_impl="auto", the
   loss falls by at least 0.5, and the launch counts per step are exactly
   32 ring forwards (one a layer, run again under full remat), 160 dK/dV
   and 160 dQ (one each per causal block of the ring's 4 ranks, 16
   layers), no flash forward and 65 RMSNorms.  With ``--profile``, one more step likewise.
5. Prints the kernels' JSON line, and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Details go to chiprun_out/chip_smoke.json beside this script.  Any failure
raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import subprocess
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.ops import _build
from kuberay_tpu_torch.ops import attention as fa
from kuberay_tpu_torch.ops import decode_attention as da
from kuberay_tpu_torch.ops import paged_attention as pa
from kuberay_tpu_torch.ops import ring_attention as ra
from kuberay_tpu_torch.ops import rmsnorm as rn
from kuberay_tpu_torch.ops import xent
from kuberay_tpu_torch.parallel.mesh import LocalRing
from kuberay_tpu_torch.parallel.ring import ring_attention
from kuberay_tpu_torch.train import launcher
from kuberay_tpu_torch.train import train_step as ts
from kuberay_tpu_torch.serve.engine import (
    Request,
    ServeEngine,
    prompt_lookup_draft,
)
from kuberay_tpu_torch.serve.kv_cache import (
    forward_with_cache,
    init_kv_cache,
    quantize_kv,
)
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine
from kuberay_tpu_torch.serve.paged_kv import quant_view
from kuberay_tpu_torch.serve.server import ServeFrontend
from kuberay_tpu_torch.serve.weight_quant import make_weight_dequant_forward
from kuberay_tpu_torch.utils.metrics import MetricsRegistry

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
RMS_ATOL = 1.6e-2
# Flash and decode kernels vs plain, element by element against the element's own
# magnitude, since |out| and |grad| fall with the number of keys a row
# sees (|out| ~ 1/sqrt(r)): |k - r| <= 2^-7 |r| (one bf16 ulp: both sides
# round f32 results that differ in the last bits) + 2^-5 rms(row), the
# RMS of the element's D values (the forward rounds P to bf16 against its
# running max, the plain version against the final max, which moves out
# by up to about 1% of its row's RMS).  A tile skipped or masked wrongly
# moves a row by far more: dropping 64 of 2048 keys moves out by ~8/sqrt(r)
# of its scale, 18%.  A floor of 2^-12 of the tensor's RMS covers rows
# whose exact value is 0 (query row 0's dQ: dS = P (dP - delta), with dP
# and delta summed in other orders on the two sides).  Also the norm of
# the whole difference <= 2^-7 of the reference's.  lse: f32 on both
# sides (measured 1e-6).  The decode kernels' outputs (rows of D per slot
# and q head) are held to the same limits: a decode row over 2048 unit-
# normal keys is about 0.02 in size, so a skipped or misread tile or page
# moves it by far more than 2^-5 of its RMS.
FLASH_RTOL, FLASH_ROW_TOL, FLASH_NORM_TOL = 2 ** -7, 2 ** -5, 2 ** -7
FLASH_FLOOR = 2 ** -12
FLASH_LSE_ATOL = 1e-4
# Chunked vs dense cross entropy: f32 logsumexp over bf16 products in two
# orders (measured: loss equal, gradients within 3e-7 of 4e-5 and 3e-3).
XENT_LOSS_ATOL, XENT_GRAD_REL = 1e-3, 2e-2
D_MODEL, HQ, HKV, HD = 4096, 32, 8, 128
SLOTS, MAX_LEN = 8, 2048
PROMPT_LENS = (7, 33, 64, 200, 511, 900, 1024, 1500)
MAX_TOKENS = 32
# Paged and int8 serving: four prompts share a 512-token (32-block)
# prefix, followed by suffixes of these lengths; four stand alone.
BLOCK_SIZE, SHARED = 16, 512
SHARED_SUFFIXES = (7, 33, 200, 511)
OTHER_LENS = (64, 900, 1024, 1500)
REPEAT = 1                     # the request repeated after the batch
RECOMPUTE_MARGIN = {"bf16": 0.05, "int8": 0.1}
# The serving options' phases: chunked prefill in chunks of 256 tokens,
# speculation with 4-token drafts on prompts that repeat a phrase of a few
# tokens, chosen by a probe for the model falling into a loop of its own
# (so that prompt lookup finds drafts it agrees with: loop_prompts), int8
# weights whose
# decode steps may hold at most one layer's bf16 weights and MEM_SLACK bytes
# beyond the int8 weights, their scales and the cache.
PREFILL_CHUNK, GAMMA = 256, 4
LOOP_PERIODS, LOOP_PROBE = (2, 3, 4), 24
MEM_SLACK = 2e9
# Sequence parallelism on one card: LocalRing(4) over a 4096 sequence,
# llama_1b's heads, shards of 1024.
RING_B, RING_S, RING_SP = 2, 4096, 4
RING_HQ, RING_HKV, RING_D = 16, 8, 128
RING_STEPS = 8


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of one call without the host's launch cost:
    ``iters`` calls captured in one CUDA graph, replayed between CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Host time of one call's enqueue (the host's clock around ``iters``
    calls, no synchronisation inside): where it exceeds the device time,
    the eager time is the host's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return t


def timings(kernel, plain, library, iters: int, plain_iters: int) -> dict:
    """Eager times (CUDA events around back-to-back calls, what the eager
    paths pay, host launch cost included), the kernel's host enqueue time,
    and CUDA-graph times (device work alone) of a kernel, its plain version
    and the library call (None where no one PyTorch call computes the same
    function)."""
    return {"ms": cuda_ms(kernel, iters), "host_ms": host_ms(kernel, iters),
            "graph_ms": graph_ms(kernel, iters),
            "plain_ms": cuda_ms(plain, plain_iters),
            "plain_graph_ms": graph_ms(plain, plain_iters),
            "library_ms": library and cuda_ms(library, iters),
            "library_graph_ms": library and graph_ms(library, iters)}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def local_err(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The flash check's numbers: max abs error, the worst ratio of an
    element's error to its limit (FLASH_RTOL |r| + FLASH_ROW_TOL rms(row)
    + FLASH_FLOOR rms(tensor); <= 1 passes), the worst error in units of
    its row's RMS (rows of RMS 0 left out), the difference's norm over the
    reference's, and the reference's RMS."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    row_rms = r.square().mean(-1, keepdim=True).sqrt()
    rms = r.square().mean().sqrt()
    limit = FLASH_RTOL * r.abs() + FLASH_ROW_TOL * row_rms + FLASH_FLOOR * rms
    row_rel = torch.where(row_rms > 0, diff / row_rms, 0.0)
    return {"max_abs_err": diff.max().item(),
            "worst": (diff / limit).max().item(),
            "max_row_rel": row_rel.max().item(),
            "norm_rel": (diff.norm() / r.norm()).item(),
            "ref_rms": rms.item()}


def within_local(rec: dict) -> bool:
    """``local_err``'s numbers inside the limits."""
    return rec["worst"] <= 1.0 and rec["norm_rel"] <= FLASH_NORM_TOL


def check_rmsnorm(gen: torch.Generator) -> dict:
    """RMSNorm at decode (8 rows), ragged and prefill row counts of the 8B
    serving path, and llama_1b's training shape (4 x 2048 rows of 2048)."""
    shapes = []
    for rows, d in ((1, D_MODEL), (8, D_MODEL), (300, D_MODEL),
                    (2048, D_MODEL), (8192, 2048)):
        # Uniform inputs keep |y| < 4, where one bf16 ulp is <= 1/64.
        x = (torch.rand(rows, d, generator=gen, device="cuda") * 2 - 1
             ).bfloat16()
        w = (torch.rand(d, generator=gen, device="cuda") + 0.5
             ).bfloat16()
        err = max_err(rn.rmsnorm(x, w), rn.rmsnorm_ref(x, w))
        if not err <= RMS_ATOL:
            raise AssertionError(f"rmsnorm rows={rows} d={d}: max abs err "
                                 f"{err} > {RMS_ATOL}")
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * 2
        flops = 4 * x.numel()
        shapes.append({
            "rows": rows, "d": d, "max_abs_err": err,
            **timings(lambda: rn.rmsnorm(x, w),
                      lambda: rn.rmsnorm_ref(x, w),
                      lambda: F.rms_norm(x, (d,), w, 1e-5), 200, 200),
            **bound(nbytes, flops)})
        print(f"rmsnorm rows={rows} d={d}: {json.dumps(shapes[-1])}",
              flush=True)
    return {"shapes": shapes, "main": shapes[1], "train": shapes[-1]}


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the bf16 tensor-core peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def achieved(flops: float, t: dict) -> dict:
    """TFLOP/s of ``flops`` at a ``timings`` record's eager and graph
    times."""
    return {"tflops": flops / t["ms"] / 1e9,
            "graph_tflops": flops / t["graph_ms"] / 1e9}


# The kernels on the Hopper attention machinery (csrc/attn_fwd_sm90.cuh,
# csrc/attn_bwd_sm90.cuh), by wrapper name: their kernel's name in the
# build log, and their module and C entry point that read a block's shared
# memory from the runtime.
HOPPER = {"flash_fwd": ("flash_fwd_kernel", fa, "flash_fwd_smem_bytes"),
          "flash_bwd_dkv": ("flash_bwd_dkv_kernel", fa,
                            "flash_bwd_dkv_smem_bytes"),
          "flash_bwd_dq": ("flash_bwd_dq_kernel", fa,
                           "flash_bwd_dq_smem_bytes"),
          "ring_attention_fwd": ("ring_fwd_kernel", ra,
                                 "ring_attention_fwd_smem_bytes")}


def ptxas_report(libs) -> dict:
    """Registers, static shared memory and spills of every kernel, by
    mangled name, from the ``-Xptxas -v`` report kept beside each
    library."""
    rep, cur = {}, None
    for lib in libs:
        for ln in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", ln)
            if m:
                cur = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and cur:
                rep.setdefault(cur, {}).update(
                    spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and cur:
                # ptxas leaves "bytes smem" out where a kernel has none
                # static.
                sm = re.search(r"(\d+) bytes smem", ln)
                rep.setdefault(cur, {}).update(
                    registers=int(m.group(1)),
                    static_smem=int(sm.group(1)) if sm else 0)
    return rep


def hopper_resources(libs) -> dict:
    """For each kernel of HOPPER and head dim: registers a thread,
    static shared memory and spills, from ptxas.  Fails if a kernel is
    missing from the report or spills."""
    rep = ptxas_report(libs)
    out = {}
    for wrapper, (kernel, _, _) in HOPPER.items():
        for name, r in rep.items():
            m = re.search(kernel + r"ILi(\d+)E", name)
            if m:
                out.setdefault(wrapper, {})[f"D{m.group(1)}"] = dict(r)
        got = out.get(wrapper, {})
        if set(got) != {"D64", "D128"} or any(
                r.get("spill_stores", 1) or "registers" not in r
                for r in got.values()):
            raise AssertionError(f"{kernel}: ptxas report {got} (expected "
                                 f"D 64 and 128, registers, no spills)")
    return out


# The decode kernels' instantiations by wrapper name: the mangled-name
# pattern of each (head dim, group) in the build log, and its count
# (head dims 64 and 128, groups 1, 2, 4 and 8); the merge kernel is the
# same template in both libraries.
DECODE_KERNELS = {
    "decode_attention": r"dense_decode_kernelILi(\d+)ELi(\d+)E13__nv_bfloat16",
    "decode_attention_quant": r"dense_decode_kernelILi(\d+)ELi(\d+)EaLb1",
    "paged_decode_attention": r"paged_decode_kernelILi(\d+)ELi(\d+)EE",
    "decode_merge": r"merge_kernelILi(\d+)()EE"}


def decode_resources(libs) -> dict:
    """Registers, static shared memory and spills of every instantiation
    of the decode kernels, by wrapper and "D<d>G<g>", from ptxas.  Fails
    if an instantiation is missing from the report or any of them
    spills."""
    rep = ptxas_report(libs)
    out = {}
    for wrapper, pat in DECODE_KERNELS.items():
        got = out.setdefault(wrapper, {})
        for name, r in rep.items():
            m = re.search(pat, name)
            if m:
                got[f"D{m.group(1)}" + (f"G{m.group(2)}" if m.group(2)
                                        else "")] = dict(r)
        want = 2 if wrapper == "decode_merge" else 8
        if len(got) != want or any(r.get("spill_stores", 1)
                                   or r.get("spill_loads", 1)
                                   or "registers" not in r
                                   for r in got.values()):
            raise AssertionError(f"{wrapper}: ptxas report {got} (expected "
                                 f"{want} instantiations, no spills)")
    return out


def decode_smem(res: dict) -> None:
    """Adds to ``res`` the shared memory a block of each decode kernel
    holds at the serving shape (D 128, group 4), static and dynamic, as
    the runtime holds it once the kernel has launched there."""
    for wrapper, got in (
            ("decode_attention", da.smem_bytes(HD, HQ // HKV, False)),
            ("decode_attention_quant", da.smem_bytes(HD, HQ // HKV, True)),
            ("paged_decode_attention", pa.smem_bytes(HD, HQ // HKV))):
        if got <= 0:
            raise AssertionError(f"{wrapper}: the runtime holds {got} bytes "
                                 f"of shared memory a block")
        res[wrapper][f"D{HD}G{HQ // HKV}"]["smem_bytes"] = got


def hopper_smem(hopper: dict) -> None:
    """Adds to ``hopper`` each kernel's shared memory a block (static and
    dynamic) at D 64 and 128, as the runtime holds it once the kernel has
    launched at that D.  Fails if the runtime refuses or holds none."""
    for wrapper, (kernel, mod, entry) in HOPPER.items():
        for key, r in hopper[wrapper].items():
            got = mod._fn(entry)(int(key[1:]))
            if got <= r["static_smem"]:
                raise AssertionError(f"{kernel} at {key}: the runtime holds "
                                     f"{got} bytes of shared memory a block")
            r["smem_bytes"] = got


def check_decode(gen: torch.Generator) -> dict:
    """Decode attention at the 8B decode shape, at a cache length (1000)
    that no split divides, and on SPLIT_LENS (checks only); against the
    plain version and the split-and-merge model."""
    shapes = []
    for M, lens in ((MAX_LEN, [0, 1, 17, 100, 1023, 1025, 2047, 2048]),
                    (1000, [0, 1, 63, 64, 65, 500, 999, 1000]),
                    *((MAX_LEN, list(x)) for x in SPLIT_LENS)):
        timed = len(shapes) < 2
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(SLOTS, HQ, HD, generator=gen, device="cuda").bfloat16()
        # Four cache copies, cycled, so timed launches find the cache cold
        # in L2 as each layer's does on the serving path.
        caches = [(torch.randn(SLOTS, M, HKV, HD, generator=gen,
                               device="cuda").bfloat16(),
                   torch.randn(SLOTS, M, HKV, HD, generator=gen,
                               device="cuda").bfloat16())
                  for _ in range(4 if timed else 1)]
        ck, cv = caches[0]
        out = da.decode_attention(q, ck, cv, lens_t)
        loc = local_err(out, da.decode_attention_ref(q, ck, cv, lens_t))
        if not within_local(loc):
            raise AssertionError(f"decode M={M} lens={lens}: {loc}")
        if lens[0] == 0 and out[0].abs().max().item() != 0.0:
            raise AssertionError("decode: a lens=0 slot must give 0")
        rec = {"max_len": M, "lens": lens, "max_abs_err": loc["max_abs_err"],
               "local": loc, **split_record(
                   f"decode M={M} lens={lens}", out,
                   da.decode_attention(q, ck, cv, lens_t),
                   da.decode_attention_split_ref(q, ck, cv, lens_t),
                   da.split_partials_ref(q, ck, cv, lens_t), SLOTS, HQ, HD,
                   M, timed)}
        if timed:
            mask = lens_mask(lens_t, M)
            it = iter(range(1 << 30))

            def run(fn):
                return lambda: fn(*caches[next(it) % 4])

            live = int(sum(lens))
            nbytes = (2 * live * HKV * HD * 2 + 2 * q.numel() * 2
                      + lens_t.numel() * 4)
            flops = 4 * live * HQ * HD
            rec.update(**timings(
                run(lambda k, v: da.decode_attention(q, k, v, lens_t)),
                run(lambda k, v: da.decode_attention_ref(q, k, v, lens_t)),
                run(lambda k, v: sdpa_decode(q, k, v, mask)), 100, 20),
                **bound(nbytes, flops))
        shapes.append(rec)
        print(f"decode M={M}: {json.dumps(rec)}", flush=True)
        del caches
    torch.cuda.empty_cache()
    return {"shapes": shapes, "main": shapes[0]}


def lens_mask(lens_t: torch.Tensor, M: int) -> torch.Tensor:
    """SDPA's boolean mask [S, 1, 1, M] of each slot's live positions."""
    return (torch.arange(M, device="cuda")[None, :] < lens_t[:, None]
            )[:, None, None, :]


def sdpa_decode(q, ck, cv, mask):
    """The library yardstick of one-token attention: SDPA over a
    [S, M, Hkv, D] cache."""
    return F.scaled_dot_product_attention(
        q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)


def split_record(tag: str, out, again, split_ref, partials, S: int,
                 Hq: int, D: int, cap: int, timed: bool) -> dict:
    """The split-and-merge checks every decode shape gets: the kernel's
    output within the element-wise limits of the plain split model, two
    calls on the same inputs bit for bit the same, and the merge kernel
    alone (on the plain model's partials) within the limits of its plain
    version.  Records the split plan, the workspace's bytes and, with
    ``timed``, the merge's own time from a CUDA graph."""
    nsplit = da.split_plan(cap)
    acc, m, l = partials
    ws = da.pack_partials(acc, m, l)
    merged = da.merge_partials(ws, S, Hq, D, nsplit)
    rec = {"chunk": da.CHUNK, "nsplit": nsplit,
           "workspace_bytes": 4 * da.workspace_numel(S, Hq, D, nsplit),
           "split_model": local_err(out, split_ref),
           "merge": local_err(merged, da.merge_ref(acc, m, l, out.dtype)),
           "bit_identical": torch.equal(out, again)}
    if not (within_local(rec["split_model"]) and within_local(rec["merge"])
            and rec["bit_identical"]):
        raise AssertionError(f"{tag}: split checks {rec}")
    if timed:
        rec["merge_graph_ms"] = graph_ms(
            lambda: da.merge_partials(ws, S, Hq, D, nsplit), 100)
    return rec


# Lens beside the smoke's first shapes: on split boundaries, every slot
# full, and lens 1 beside full slots (cache length MAX_LEN, 8 slots).
C = da.CHUNK
SPLIT_LENS = ([0, 1, C - 1, C, C + 1, 2 * C, 2 * C + 1, MAX_LEN],
              [MAX_LEN] * 8, [1, MAX_LEN] * 4)


def int8_cache(gen, S, M, Hkv, D):
    """A random int8 cache in the serving layout: kq/vq [S, M, Hkv, D]
    int8, ks/vs [S, Hkv, M] float32 (quantize_kv of normal K/V)."""
    out = []
    for _ in range(2):
        x8, s = quantize_kv(torch.randn(S, M, Hkv, D, generator=gen,
                                        device="cuda"))
        out += [x8, s[..., 0].transpose(1, 2).contiguous()]
    return tuple(out)                      # kq, ks, vq, vs


def check_decode_quant(gen: torch.Generator) -> dict:
    """The int8 decode kernel at the 8B decode shape, at a cache length
    (1000) that no split divides, at D 64 with group 1, and on SPLIT_LENS;
    against the plain version, the float32 dequantisation and the
    split-and-merge model."""
    shapes = []
    for S, M, Hq, Hkv, D, lens in (
            (SLOTS, MAX_LEN, HQ, HKV, HD, [0, 1, 17, 1000, 2048, 2047, 64, 65]),
            (SLOTS, 1000, HQ, HKV, HD, [0, 1, 63, 64, 65, 500, 999, 1000]),
            (4, 512, 8, 8, 64, [0, 5, 300, 512]),
            *((SLOTS, MAX_LEN, HQ, HKV, HD, list(x)) for x in SPLIT_LENS)):
        timed = not shapes
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(S, Hq, D, generator=gen, device="cuda").bfloat16()
        caches = [int8_cache(gen, S, M, Hkv, D)
                  for _ in range(4 if timed else 1)]
        kq, ks, vq, vs = caches[0]
        out = da.decode_attention_quant(q, kq, ks, vq, vs, lens_t)
        loc = local_err(out, da.decode_attention_quant_ref(q, kq, ks, vq, vs,
                                                           lens_t))
        # The same attention with the cache dequantised in float32: only
        # the output is rounded, so this holds the kernel's own arithmetic.
        loc32 = local_err(out, da.decode_attention_ref(
            q, da.dequant_lanes(kq, ks, torch.float32),
            da.dequant_lanes(vq, vs, torch.float32), lens_t))
        if not (within_local(loc) and within_local(loc32)):
            raise AssertionError(f"int8 decode M={M} D={D} lens={lens}: "
                                 f"vs plain {loc}, vs f32 dequant {loc32}")
        if lens[0] == 0 and out[0].abs().max().item() != 0.0:
            raise AssertionError("int8 decode: a lens=0 slot must give 0")
        rec = {"S": S, "max_len": M, "Hq": Hq, "Hkv": Hkv, "D": D,
               "lens": lens, "max_abs_err": loc["max_abs_err"],
               "local": loc, "local_f32_dequant": loc32, **split_record(
                   f"int8 decode M={M} D={D} lens={lens}", out,
                   da.decode_attention_quant(q, kq, ks, vq, vs, lens_t),
                   da.decode_attention_quant_split_ref(q, kq, ks, vq, vs,
                                                       lens_t),
                   da.split_partials_ref(q, kq, vq, lens_t, ks=ks, vs=vs),
                   S, Hq, D, M, timed)}
        if timed:
            # The library's operands: each copy dequantised to bf16 once,
            # outside the timed calls.
            deq = [(da.dequant_lanes(kq, ks, torch.bfloat16),
                    da.dequant_lanes(vq, vs, torch.bfloat16))
                   for kq, ks, vq, vs in caches]
            mask = lens_mask(lens_t, M)
            it = iter(range(1 << 30))

            def run(fn, pool):
                return lambda: fn(*pool[next(it) % 4])

            live = int(sum(lens))
            nbytes = (2 * live * Hkv * (D + 4) + 2 * q.numel() * 2
                      + lens_t.numel() * 4)
            rec.update(**timings(
                run(lambda kq, ks, vq, vs: da.decode_attention_quant(
                    q, kq, ks, vq, vs, lens_t), caches),
                run(lambda kq, ks, vq, vs: da.decode_attention_quant_ref(
                    q, kq, ks, vq, vs, lens_t), caches),
                run(lambda k, v: sdpa_decode(q, k, v, mask), deq), 100, 20),
                **bound(nbytes, 4 * live * Hq * D),
                library_of="SDPA over the cache dequantised to bf16 "
                           "(the dequantisation not timed)")
            del deq
        shapes.append(rec)
        print(f"int8 decode M={M} D={D}: {json.dumps(rec)}", flush=True)
        del caches
    torch.cuda.empty_cache()
    return {"shapes": shapes, "main": shapes[0]}


def scrambled_tables(gen, S, max_blocks, num_blocks, shared):
    """Block tables [S, max_blocks] int32 over a random permutation of the
    pool, with slots 1 and 2 reading slot 0's first ``shared`` pages (as
    requests with a cached prefix do)."""
    perm = torch.randperm(num_blocks, generator=gen, device="cuda")
    tables = perm[:S * max_blocks].reshape(S, max_blocks).clone()
    tables[1:3, :shared] = tables[0, :shared]
    return tables.int().contiguous()


def check_paged(gen: torch.Generator) -> dict:
    """The paged kernel at the 8B decode shape (block size 16, pool of
    1024 blocks, scrambled tables with shared pages), at block size 8 with
    D 64, group 1, and on SPLIT_LENS at the first shape (checks only);
    against the plain version and the split-and-merge model."""
    shapes = []
    main = (SLOTS, HQ, HKV, HD, BLOCK_SIZE, SLOTS * MAX_LEN // BLOCK_SIZE,
            MAX_LEN // BLOCK_SIZE)
    for S, Hq, Hkv, D, bs, nblk, maxb, lens in (
            (*main, [0, 1, 17, 1000, 2048, 2047, 64, 65]),
            (4, 8, 8, 64, 8, 256, 64, [0, 5, 300, 512]),
            *((*main, list(x)) for x in SPLIT_LENS)):
        timed = not shapes
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(S, Hq, D, generator=gen, device="cuda").bfloat16()
        tables = scrambled_tables(gen, S, maxb, nblk, shared=10)
        pools = [tuple(torch.randn(Hkv, nblk * bs, D, generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(2)) for _ in range(4 if timed else 1)]
        pk, pv = pools[0]
        out = pa.paged_decode_attention(q, pk, pv, lens_t, tables, bs)
        loc = local_err(out, pa.paged_decode_attention_ref(q, pk, pv, lens_t,
                                                           tables, bs))
        if not within_local(loc):
            raise AssertionError(f"paged decode bs={bs} D={D} lens={lens}: "
                                 f"{loc}")
        if lens[0] == 0 and out[0].abs().max().item() != 0.0:
            raise AssertionError("paged decode: a lens=0 slot must give 0")
        kview, vview = (pa.gather_view(p, tables, bs) for p in (pk, pv))
        rec = {"S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "block_size": bs,
               "num_blocks": nblk, "lens": lens,
               "max_abs_err": loc["max_abs_err"], "local": loc,
               **split_record(
                   f"paged decode bs={bs} D={D} lens={lens}", out,
                   pa.paged_decode_attention(q, pk, pv, lens_t, tables, bs),
                   pa.paged_decode_attention_split_ref(q, pk, pv, lens_t,
                                                       tables, bs),
                   da.split_partials_ref(q, kview, vview, lens_t), S, Hq, D,
                   maxb * bs, timed)}
        del kview, vview
        if timed:
            # Gathered per-request views of each pool copy, made outside
            # the timed calls: the library's operands and the dense
            # decode kernel's.
            views = [tuple(pa.gather_view(p, tables, bs).contiguous()
                           for p in pool) for pool in pools]
            mask = lens_mask(lens_t, maxb * bs)
            it = iter(range(1 << 30))

            def run(fn, pool):
                return lambda: fn(*pool[next(it) % 4])

            live = int(sum(lens))
            pages = sum(-(-n // bs) for n in lens)
            nbytes = (2 * live * Hkv * D * 2 + 2 * q.numel() * 2
                      + pages * 4 + lens_t.numel() * 4)
            rec.update(**timings(
                run(lambda k, v: pa.paged_decode_attention(
                    q, k, v, lens_t, tables, bs), pools),
                run(lambda k, v: pa.paged_decode_attention_ref(
                    q, k, v, lens_t, tables, bs), pools),
                run(lambda k, v: sdpa_decode(q, k, v, mask), views), 100, 20),
                **bound(nbytes, 4 * live * Hq * D),
                library_of="SDPA over the gathered view (the gather not "
                           "timed)",
                dense_decode_ms=cuda_ms(run(
                    lambda k, v: da.decode_attention(q, k, v, lens_t),
                    views), 100))
            # What the paged int8 path pays per layer and decode step
            # besides its kernel: the contiguous int8 views of K and V
            # (values and scales) gathered through the tables.
            pools8 = [{"q": x8, "s": sc[..., 0]}
                      for x8, sc in map(quantize_kv, pools[0])]

            def int8_views():
                return [quant_view(p8, tables, bs, True) for p8 in pools8]
            rec.update(int8_view_ms=cuda_ms(int8_views, 50),
                       int8_view_graph_ms=graph_ms(int8_views, 50))
            del views, pools8
        shapes.append(rec)
        print(f"paged decode bs={bs} D={D}: {json.dumps(rec)}", flush=True)
        del pools
    torch.cuda.empty_cache()
    return {"shapes": shapes, "main": shapes[0]}


# (name, B, Sq, Skv, Hq, Hkv, D, causal); the first is the training path's
# shape, the last two the ring's blocks (long-context training calls the
# backward pair on each: causal on the diagonal, not causal on past
# blocks).
FLASH_SHAPES = (("llama_1b", 4, 2048, 2048, 16, 8, 128, True),
                ("llama3_8b_heads", 1, 1024, 1024, 32, 8, 128, True),
                ("ragged", 2, 1000, 1000, 16, 8, 128, True),
                ("offset", 1, 512, 1536, 16, 8, 128, True),
                ("d64_group1", 2, 1024, 1024, 12, 12, 64, True),
                # 960: the forward's 128-row tile does not divide it, the
                # backward's 64-row q steps do.
                ("tile64", 1, 960, 960, 16, 8, 128, True),
                ("d64_group8", 1, 512, 512, 16, 2, 64, True),
                ("ring_diag", 2, 1024, 1024, 16, 8, 128, True),
                ("ring_past", 2, 1024, 1024, 16, 8, 128, False))


def visible_pairs(B, Sq, Skv, Hq, causal=True) -> int:
    """(query, key) pairs the causal mask lets through, over batch and
    heads: the work this run's inputs need."""
    off = Skv - Sq
    row = (sum(min(Skv, max(0, r + off + 1)) for r in range(Sq)) if causal
           else Sq * Skv)
    return B * Hq * row


def bwd_timings(q, k, v, do, lse, delta, causal: bool) -> dict:
    """Times, TFLOP/s and bounds of the dK/dV and dQ kernels on these
    inputs, and one call of ATen's flash backward (through autograd) on the
    same inputs and dO as the pair's yardstick, with k/v expanded to the q
    heads (its dK/dV are per q head; the group sum is not in its time)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    pairs = visible_pairs(B, Sq, Skv, Hq, causal)
    io_qkv = 2 * (q.numel() + 2 * k.numel())
    rows = 4 * lse.numel()
    t = {"flash_bwd_dkv": {
            **timings(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                               causal),
                      lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   causal),
                      None, 20, 3),
            **bound(io_qkv + 2 * do.numel() + 2 * rows + 4 * k.numel(),
                    8 * pairs * D)},
         "flash_bwd_dq": {
            **timings(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                              causal),
                      lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta,
                                                  causal),
                      None, 20, 3),
            **bound(io_qkv + 4 * do.numel() + 2 * rows, 6 * pairs * D)}}
    for name, flops in (("flash_bwd_dkv", 8 * pairs * D),
                        ("flash_bwd_dq", 6 * pairs * D)):
        t[name].update(achieved(flops, t[name]))
    qs = q.transpose(1, 2).contiguous().requires_grad_()
    kx, vx = (x.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
              .contiguous().requires_grad_() for x in (k, v))
    dot = do.transpose(1, 2).contiguous()
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib_out = F.scaled_dot_product_attention(qs, kx, vx,
                                                 is_causal=causal)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qs, kx, vx), dot, retain_graph=True), 20)
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        t[name].update(library_ms=lib_ms, library_graph_ms=None,
                       library_of="flash_bwd_dkv + flash_bwd_dq")
    dkv, dq = t["flash_bwd_dkv"], t["flash_bwd_dq"]
    t["pair"] = {"ms": dkv["ms"] + dq["ms"],
                 "graph_ms": dkv["graph_ms"] + dq["graph_ms"],
                 "graph_tflops": 14 * pairs * D / (dkv["graph_ms"]
                                                   + dq["graph_ms"]) / 1e9,
                 "bound_ms": dkv["bound_ms"] + dq["bound_ms"],
                 "aten_ms": lib_ms}
    return t


def check_flash(gen: torch.Generator) -> dict:
    """The forward, dK/dV and dQ kernels against their plain versions on
    every shape of FLASH_SHAPES (the backward's plain versions get the
    kernel's own out/lse, so each kernel is checked alone), and a second
    launch of each backward kernel bit for bit against the first; times at
    the llama_1b shape, and the backward pair's at the ring's past
    block."""
    errs = {"flash_fwd": [], "flash_bwd_dkv": [], "flash_bwd_dq": []}
    shapes, timed, ring_bwd = [], {}, None
    for name, B, Sq, Skv, Hq, Hkv, D, causal in FLASH_SHAPES:
        q, do = (torch.randn(B, Sq, Hq, D, generator=gen, device="cuda"
                             ).bfloat16() for _ in range(2))
        k, v = (torch.randn(B, Skv, Hkv, D, generator=gen, device="cuda"
                            ).bfloat16() for _ in range(2))
        out, lse = fa.flash_fwd(q, k, v, causal)
        delta = fa.attention_delta(out, do)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq2 = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        rout, rlse = fa.flash_fwd_ref(q, k, v, causal)
        rdk, rdv = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal)
        rdq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, causal)
        rec = {"shape": name, "B": B, "Sq": Sq, "Skv": Skv, "Hq": Hq,
               "Hkv": Hkv, "D": D, "causal": causal,
               "lse_err": max_err(lse, rlse),
               "repeat_bitwise": all(torch.equal(a, b) for a, b in (
                   (dk, dk2), (dv, dv2), (dq, dq2)))}
        for g, r, key in ((out, rout, "out"), (dq, rdq, "dq"),
                          (dk, rdk, "dk"), (dv, rdv, "dv")):
            rec[key] = local_err(g, r)
        print(f"flash {name}: {json.dumps(rec)}", flush=True)
        if not (rec["lse_err"] <= FLASH_LSE_ATOL and rec["repeat_bitwise"]
                and all(within_local(rec[t])
                        for t in ("out", "dq", "dk", "dv"))):
            raise AssertionError(f"flash kernels disagree with the plain "
                                 f"versions or with themselves at {name}: "
                                 f"{rec}")
        errs["flash_fwd"].append(rec["out"]["max_abs_err"])
        errs["flash_bwd_dkv"].append(max(rec["dk"]["max_abs_err"],
                                         rec["dv"]["max_abs_err"]))
        errs["flash_bwd_dq"].append(rec["dq"]["max_abs_err"])
        shapes.append(rec)
        del rout, rlse, rdk, rdv, rdq, dk2, dv2, dq2
        torch.cuda.empty_cache()
        if name == "ring_past":
            ring_bwd = bwd_timings(q, k, v, do, lse, delta, causal)
            print(f"flash timings {name}: {json.dumps(ring_bwd)}",
                  flush=True)
        if timed:
            continue
        pairs = visible_pairs(B, Sq, Skv, Hq)
        io_qkv = 2 * (q.numel() + 2 * k.numel())
        rows = 4 * lse.numel()
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        timed["flash_fwd"] = {
            **timings(lambda: fa.flash_fwd(q, k, v),
                      lambda: fa.flash_fwd_ref(q, k, v),
                      lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, is_causal=True, enable_gqa=True),
                      20, 3),
            **bound(io_qkv + 2 * out.numel() + rows, 4 * pairs * D)}
        timed["flash_fwd"].update(achieved(4 * pairs * D,
                                           timed["flash_fwd"]))
        timed.update(bwd_timings(q, k, v, do, lse, delta, causal))
        # Yardsticks for the whole attention, forward and backward.
        qs, ks, vs = (t.detach().requires_grad_() for t in (qt, kt, vt))
        dot = do.transpose(1, 2).contiguous()
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        timed["fwd_bwd"] = {
            "flash_attention_ms": cuda_ms(
                lambda: fa.flash_attention(qg, kg, vg).backward(do), 10),
            "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True).backward(dot),
                10)}
        print(f"flash timings {name}: {json.dumps(timed)}", flush=True)
    return {name: {"shapes": [{"max_abs_err": e} for e in errs[name]],
                   "main": timed[name]} for name in errs} | {
        "checks": shapes, "fwd_bwd": timed["fwd_bwd"], "pair": timed["pair"],
        "ring_past_bwd": ring_bwd}


def check_xent(gen: torch.Generator) -> dict:
    """Chunked cross entropy at llama3_8b's head against the dense loss
    from f32 logits: loss, dx and dhead (bf16 inputs)."""
    T, d, V, C = 2048, D_MODEL, 128256, 16384
    x = torch.randn(T, d, generator=gen, device="cuda").bfloat16()
    head = (torch.randn(d, V, generator=gen, device="cuda") / math.sqrt(d)
            ).bfloat16()
    tgt = torch.randint(0, V, (T,), generator=gen, device="cuda")
    x.requires_grad_()
    head.requires_grad_()

    def chunked():
        loss, _ = xent.chunked_softmax_xent_loss(x, head, tgt, chunk=C)
        return (loss, *torch.autograd.grad(loss, (x, head)))

    def dense():
        logits = xent.logits_f32(x, head)
        logz = torch.logsumexp(logits, -1)
        nll = logz - logits.gather(1, tgt[:, None])[:, 0]
        loss = (nll + 1e-4 * logz ** 2).mean()
        return (loss, *torch.autograd.grad(loss, (x, head)))

    (cl, cgx, cgh), (dl, dgx, dgh) = chunked(), dense()
    rec = {"T": T, "d": d, "V": V, "chunk": C, "loss": cl.item(),
           "loss_err": abs(cl.item() - dl.item()),
           "dx_err": max_err(cgx, dgx),
           "dx_max": dgx.float().abs().max().item(),
           "dhead_err": max_err(cgh, dgh),
           "dhead_max": dgh.float().abs().max().item(),
           "chunked_ms": cuda_ms(chunked, 3, warmup=1),
           "dense_ms": cuda_ms(dense, 3, warmup=1)}
    print(f"chunked xent: {json.dumps(rec)}", flush=True)
    if not (rec["loss_err"] <= XENT_LOSS_ATOL
            and rec["dx_err"] <= XENT_GRAD_REL * rec["dx_max"]
            and rec["dhead_err"] <= XENT_GRAD_REL * rec["dhead_max"]):
        raise AssertionError(f"chunked xent disagrees with dense: {rec}")
    return rec


# (name, R held ranks, rank0, n, shard, Hq, Hkv, D, causal): a rank that
# sees 1, 2 and all 4 blocks of a causal ring (its own diagonal first,
# then the past ones), LocalRing(4)'s whole ring (the main path's call),
# not causal, a ragged shard (the 128-row tile does not divide 1000 or
# 960) and D 64 with group 1.
RING_KERNEL_CASES = (
    ("one_block", 1, 0, 4, 1024, RING_HQ, RING_HKV, RING_D, True),
    ("two_blocks", 1, 1, 4, 1024, RING_HQ, RING_HKV, RING_D, True),
    ("four_blocks", 1, 3, 4, 1024, RING_HQ, RING_HKV, RING_D, True),
    ("local_ring", 4, 0, 4, 1024, RING_HQ, RING_HKV, RING_D, True),
    ("full", 4, 0, 4, 1024, RING_HQ, RING_HKV, RING_D, False),
    ("ragged", 4, 0, 4, 1000, RING_HQ, RING_HKV, RING_D, True),
    ("tile64", 2, 1, 3, 960, RING_HQ, RING_HKV, RING_D, True),
    ("d64_group1", 4, 0, 4, 1024, 12, 12, 64, True),
    ("d64_full", 2, 2, 4, 512, 12, 12, 64, False),
)
# The staged check's cases: the blocks land in an n-slot buffer after the
# launch.
RING_STAGED = ("local_ring", "four_blocks", "d64_full")


def staged_ring(q, k, v, rank0, n, causal) -> tuple:
    """The kernel over an n-slot buffer [n, 2, B, Sl, Hkv, D] (NaN until
    written) that a side stream fills after the launch: a 1 ms sleep so
    that the kernel is waiting, then each block's copy followed by its
    arrival word, the last rank's first.  The sleep kernel is loaded
    before the launch: CUDA loads a module at a kernel's first launch
    (lazy loading) only once the running kernels have ended, which a
    waiting kernel never does."""
    buf = torch.full((n, 2) + k.shape[1:], float("nan"), device="cuda",
                     dtype=k.dtype)
    words = torch.zeros(n, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    torch.cuda._sleep(1)
    side.wait_stream(torch.cuda.current_stream())
    got = ra.ring_attention_fwd(q, buf[:, 0], buf[:, 1], rank0, n, causal,
                                words=words)
    with torch.cuda.stream(side):
        torch.cuda._sleep(2_000_000)
        for src in reversed(range(n)):
            buf[src, 0].copy_(k[src])
            buf[src, 1].copy_(v[src])
            ra.arrive(words, src)
    torch.cuda.synchronize()
    return got


def check_ring_kernel(gen: torch.Generator) -> dict:
    """The ring kernel against its plain chain on RING_KERNEL_CASES (out by
    local_err, lse atol FLASH_LSE_ATOL), a second launch bit for bit, and
    the staged cases bit for bit against the in-place launch."""
    cases = []
    for name, R, rank0, n, S, Hq, Hkv, D, causal in RING_KERNEL_CASES:
        q = torch.randn(R, RING_B, S, Hq, D, generator=gen, device="cuda"
                        ).bfloat16()
        k, v = (torch.randn(n, RING_B, S, Hkv, D, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        out, lse = ra.ring_attention_fwd(q, k, v, rank0, n, causal)
        again = ra.ring_attention_fwd(q, k, v, rank0, n, causal)
        rout, rlse = ra.ring_attention_fwd_ref(q, k, v, rank0, n, causal)
        torch.cuda.synchronize()
        rec = {"case": name, "R": R, "rank0": rank0, "n": n, "shard": S,
               "Hq": Hq, "Hkv": Hkv, "D": D, "causal": causal,
               "blocks": [len(ra.ring_blocks(rank0 + j, n, causal))
                          for j in range(R)],
               "out": local_err(out, rout), "lse_err": max_err(lse, rlse),
               "repeat_bitwise": torch.equal(out, again[0])
               and torch.equal(lse, again[1])}
        if name in RING_STAGED:
            st = staged_ring(q, k, v, rank0, n, causal)
            rec["staged_bitwise"] = torch.equal(st[0], out) and torch.equal(
                st[1], lse)
        rec["max_abs_err"] = rec["out"]["max_abs_err"]
        print(f"ring kernel {name}: {json.dumps(rec)}", flush=True)
        if not (within_local(rec["out"]) and rec["lse_err"] <= FLASH_LSE_ATOL
                and rec["repeat_bitwise"] and rec.get("staged_bitwise", True)):
            raise AssertionError(f"ring kernel disagrees with its plain chain "
                                 f"or with itself at {name}: {rec}")
        cases.append(rec)
        del q, k, v, out, lse, again, rout, rlse
        torch.cuda.empty_cache()
    return {"cases": cases}


def check_ring(gen: torch.Generator) -> dict:
    """The ring kernel's cases, then the whole ring over LocalRing(4) at
    B 2 x S 4096 against flash_attention and the plain ring (forward and
    backward), then times."""
    res = check_ring_kernel(gen)
    ring = LocalRing(RING_SP, "cuda")
    B, S, Hq, Hkv, D = RING_B, RING_S, RING_HQ, RING_HKV, RING_D
    q, do = (torch.randn(B, S, Hq, D, generator=gen, device="cuda"
                         ).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device="cuda"
                        ).bfloat16() for _ in range(2))

    def fwd_bwd(fn):
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = fn(qg, kg, vg)
        out.backward(do)
        return {"out": out.detach(), "dq": qg.grad, "dk": kg.grad,
                "dv": vg.grad}

    reset_counts()
    got = fwd_bwd(lambda a, b, c: ring_attention(a, b, c, ring, impl="rdma"))
    torch.cuda.synchronize()
    whole = {"launches": train_counts()}
    # Element by element against flash_attention (the same bf16 rounding
    # of P and dS); the forward likewise against the plain ring.  The
    # gradients against the plain ring run in float32 from the same bf16
    # values, in norm only: the kernels round dS to bf16, and dQ = dS K
    # cancels (each row of dS sums to 0), so a row whose dQ is small
    # against its dS differs from the exact gradient by more than the
    # element limits, as flash_attention's does.  The worst element
    # ratios are recorded.
    ref = fwd_bwd(fa.flash_attention)
    torch.cuda.synchronize()
    whole["flash_attention"] = {t: local_err(got[t], ref[t]) for t in got}
    del ref
    with torch.no_grad():
        plain = ring_attention(q, k, v, ring, impl="ppermute")
    whole["plain_ring"] = {"out": local_err(got["out"], plain)}
    del plain
    ref = fwd_bwd(lambda a, b, c: ring_attention(
        a.float(), b.float(), c.float(), ring, impl="ppermute").to(a.dtype))
    torch.cuda.synchronize()
    whole["plain_ring_f32"] = {t: local_err(got[t], ref[t])
                               for t in ("dq", "dk", "dv")}
    del ref
    torch.cuda.empty_cache()
    print(f"ring whole B={B} S={S}: {json.dumps(whole)}", flush=True)
    blocks = RING_SP * (RING_SP + 1) // 2
    want = {"ring_attention_fwd": 1, "flash_bwd_dkv": blocks,
            "flash_bwd_dq": blocks, "flash_fwd": 0, "rmsnorm": 0}
    if whole["launches"] != want or not (
            all(within_local(e) for e in whole["flash_attention"].values())
            and within_local(whole["plain_ring"]["out"])
            and all(e["norm_rel"] <= FLASH_NORM_TOL
                    for e in whole["plain_ring_f32"].values())):
        raise AssertionError(f"the kernel ring disagrees or launched "
                             f"otherwise than {want}: {whole}")
    res["whole"] = whole
    res["shapes"] = [{"max_abs_err": c["max_abs_err"]} for c in res["cases"]]
    del got

    # Times: the kernel over the ring's shards (one ring forward, the unit
    # the TPU kernel computes), its plain chain and SDPA over the whole
    # sequence; then ring_attention's forward (the shards' copies
    # included) and flash_fwd over the whole sequence.
    qs, ks, vs = (ring.shard(t) for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = visible_pairs(B, S, S, Hq)
    with torch.no_grad():
        res["main"] = {
            **timings(
                lambda: ra.ring_attention_fwd(qs, ks, vs, 0, RING_SP),
                lambda: ra.ring_attention_fwd_ref(qs, ks, vs, 0, RING_SP),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), 20, 3),
            **bound(2 * (2 * q.numel() + 2 * k.numel()) + 4 * B * Hq * S,
                    4 * pairs * D),
            "library_of": "SDPA over the whole sequence (causal, GQA)",
            "shape": {"B": B, "S": S, "sp": RING_SP, "Hq": Hq, "Hkv": Hkv,
                      "D": D}}
        res["main"].update(achieved(4 * pairs * D, res["main"]))
        rdma = lambda: ring_attention(q, k, v, ring, impl="rdma")  # noqa
        res["ring_attention"] = {
            "ms": cuda_ms(rdma, 20), "host_ms": host_ms(rdma, 20),
            "graph_ms": graph_ms(rdma, 20),
            "plain_ms": cuda_ms(
                lambda: ring_attention(q, k, v, ring, impl="ppermute"), 3),
            "flash_fwd_ms": cuda_ms(lambda: fa.flash_fwd(q, k, v), 20),
            "flash_fwd_graph_ms": graph_ms(lambda: fa.flash_fwd(q, k, v), 20)}
    print(f"ring timings: kernel {json.dumps(res['main'])}; "
          f"ring_attention {json.dumps(res['ring_attention'])}", flush=True)
    del q, k, v, do, qs, ks, vs, qt, kt, vt
    torch.cuda.empty_cache()
    return res


def train_ring(seed: int = 0, profile: bool = False) -> dict:
    """llama_1b at full width and depth with the kernel ring over
    LocalRing(4): 8 steps of make_sharded_train_fns on one fixed batch of
    B 2 x S 4096 (bf16 masters), and with ``profile`` one more under
    torch.profiler."""
    cfg = dataclasses.replace(llama.CONFIGS["llama_1b"],
                              attn_impl="ring_rdma")
    L = cfg.n_layers
    blocks = RING_SP * (RING_SP + 1) // 2        # causal blocks a layer
    per_step = {"ring_attention_fwd": 2 * L,      # remat: fwd twice
                "flash_fwd": 0, "flash_bwd_dkv": L * blocks,
                "flash_bwd_dq": L * blocks, "rmsnorm": 2 * 2 * L + 1}
    tc = ts.TrainConfig(learning_rate=3e-4, warmup_steps=1,
                        decay_steps=RING_STEPS)
    init, step, shardings = ts.make_sharded_train_fns(
        cfg, tc, LocalRing(RING_SP, "cuda"))
    torch.cuda.reset_peak_memory_stats()
    state = init(torch.Generator(device="cuda").manual_seed(seed))
    raw = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (RING_B, RING_S + 1))
    batch = {"tokens": torch.tensor(raw[:, :-1], dtype=torch.int32,
                                    device="cuda"),
             "targets": torch.tensor(raw[:, 1:], dtype=torch.int32,
                                     device="cuda")}
    with torch.no_grad():
        flash_loss = float(llama.loss_fn(
            dataclasses.replace(cfg, attn_impl="auto"), state["params"],
            batch["tokens"], batch["targets"])[1]["loss"])
    run = {"loss": [], "grad_norm": [], "step_ms": []}
    reset_counts()
    for _ in range(RING_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        run["loss"].append(float(m["loss"]))
        run["grad_norm"].append(float(m["grad_norm"]))
        run["step_ms"].append((time.perf_counter() - t0) * 1e3)
    launches = train_counts()
    if profile:
        run["profile"] = profile_step(step, state, batch)
    want = {k: n * RING_STEPS for k, n in per_step.items()}
    expect = math.log(cfg.vocab_size) + 0.5
    run.update(model="llama_1b", attn_impl=cfg.attn_impl, batch=RING_B,
               seq=RING_S, sp=RING_SP, shardings=shardings,
               first_loss_auto=flash_loss, launches=launches,
               launches_per_step=per_step,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    steady = sorted(run["step_ms"][1:])
    run["step_ms_median_steady"] = steady[len(steady) // 2]
    print(f"train ring: {json.dumps(run)}", flush=True)
    losses = run["loss"]
    if not all(math.isfinite(x) for x in losses + run["grad_norm"]) or \
            abs(losses[0] - expect) > 0.3 or \
            abs(losses[0] - flash_loss) > 2e-2 or \
            losses[-1] > losses[0] - 0.5 or launches != want:
        raise AssertionError(f"ring training failed (first loss expected "
                             f"within 0.3 of {expect:.3f} and 2e-2 of "
                             f"{flash_loss:.4f}; launches {want}): {run}")
    del state, batch
    torch.cuda.empty_cache()
    return run


def post(url: str, body: dict, timeout: float = 600.0):
    req = urllib.request.Request(
        f"{url}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), json.load(resp)


def serve_counts() -> dict:
    return {"rmsnorm": rn.launches, "decode_attention": da.launches,
            "decode_attention_quant": da.launches_quant,
            "paged_decode_attention": pa.launches}


def decode_peaks(engine) -> dict:
    """Wrap ``engine._decode_call`` to record the peak device memory
    inside each decode step (the peak statistics are reset before each);
    ``phase`` keeps the peak of everything around them.  Read the phase's
    peak through ``phase_peak``; delete the instance's ``_decode_call``
    afterwards."""
    peaks = {"phase": 0, "decode": 0}
    real = engine._decode_call

    def decode_call(*args):
        peaks["phase"] = max(peaks["phase"], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        out = real(*args)
        peaks["decode"] = max(peaks["decode"],
                              torch.cuda.max_memory_allocated())
        return out

    engine._decode_call = decode_call
    return peaks


def phase_peak(peaks: dict) -> int:
    return max(peaks["phase"], peaks["decode"],
               torch.cuda.max_memory_allocated())


def drive(engine, prompts, repeat: int, same_as_batch: bool) -> dict:
    """The engine behind ServeFrontend on 127.0.0.1: every prompt POSTed
    at once (greedy, MAX_TOKENS new tokens each), then prompts[repeat]
    twice more.  The two repeats run the same computation and must give
    the same tokens; with ``same_as_batch`` they must also equal the
    batch's (a dense engine prefills a prompt the same way each time; a
    paged engine prefills past however much of it was cached, and bf16
    matmuls of other shapes round differently; speculation verifies other
    drafts beside other requests).  Launch counts are set to 0 just
    before and read just after; RMSNorm must have run 2 L + 1 times a
    forward (prefill chunks, decode and verify steps)."""
    fe = ServeFrontend(engine)
    srv, url = fe.serve_background("127.0.0.1", 0)
    results, errors = {}, []
    peaks = decode_peaks(engine)

    def client(i):
        try:
            results[i] = post(url, {"prompt_tokens": prompts[i],
                                    "max_tokens": MAX_TOKENS,
                                    "temperature": 0.0})
        except Exception as e:              # reported below, then raised
            errors.append(f"request {i}: {e!r}")

    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        batch_s = time.perf_counter() - t0
        batch_stats = fe.stats()
        again = [post(url, {"prompt_tokens": prompts[repeat],
                            "max_tokens": MAX_TOKENS, "temperature": 0.0})
                 for _ in range(2)]
        launches = serve_counts()
        stats = fe.stats()
    finally:
        srv.shutdown()
        srv.server_close()
        fe.close()
        del engine._decode_call         # the wrapper (a reference cycle)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve requests failed: {errors}")
    vocab = engine.cfg.vocab_size
    for i, (status, headers, body) in sorted(results.items()):
        n = len(body["tokens"])
        if status != 200 or not (
                n == MAX_TOKENS or (body["finish_reason"] == "eos"
                                    and 0 < n <= MAX_TOKENS)):
            raise AssertionError(f"request {i}: status {status}, body {body}")
        if not headers.get("X-TPU-Queue-Depth", "").isdigit():
            raise AssertionError(f"request {i}: no load headers {headers}")
        if body["prompt_len"] != len(prompts[i]) or \
                not all(0 <= t < vocab for t in body["tokens"]):
            raise AssertionError(f"request {i}: bad body {body}")
    first = results[repeat][2]["tokens"]
    tokens = [r[2]["tokens"] for r in again]
    if any(r[0] != 200 for r in again) or tokens[0] != tokens[1] or (
            same_as_batch and tokens[0] != first):
        raise AssertionError(f"repeats differ: {tokens} (batch: {first})")
    check_rmsnorm_launches(engine, launches, stats)
    generated = stats["decode_tokens"] + stats["verify_tokens"]
    forwards = stats["decode_steps"] + stats["verify_steps"]
    return {"batch_wall_s": batch_s,
            "ttft_ms": [results[i][2]["ttft_ms"] for i in sorted(results)],
            "decode_tokens_per_s": stats["decode_tokens"] / stats["decode_s"],
            "decode_step_ms": 1e3 * stats["decode_s"] / stats["decode_steps"],
            "tokens_per_s": generated / (stats["decode_s"]
                                         + stats["verify_s"]),
            "tokens_per_forward": generated / forwards,
            "max_memory_allocated_gb": phase_peak(peaks) / 1e9,
            "decode_peak_memory_gb": peaks["decode"] / 1e9,
            "launches": launches, "engine": stats,
            "engine_after_batch": batch_stats,
            "tokens": [results[i][2]["tokens"] for i in sorted(results)],
            "repeat_tokens": tokens[0],
            "repeat_equals_batch": tokens[0] == first}


def check_rmsnorm_launches(engine, launches: dict, stats: dict) -> None:
    """2 L + 1 RMSNorms a forward: every prefill (each chunk counted),
    decode step and verify step; at least one decode step."""
    forwards = stats["prefills"] + stats["decode_steps"] + \
        stats["verify_steps"]
    if stats["decode_steps"] == 0 or \
            launches["rmsnorm"] != (2 * engine.cfg.n_layers + 1) * forwards:
        raise AssertionError(f"rmsnorm launches {launches} (stats {stats})")


def expect_decode_kernel(run: dict, kernel: str, n_layers: int) -> None:
    """Every decode step launched ``kernel`` once per layer and no other
    decode-attention kernel ran."""
    steps = run["engine"]["decode_steps"]
    want = {k: 0 for k in ("decode_attention", "decode_attention_quant",
                           "paged_decode_attention")}
    want[kernel] = n_layers * steps
    got = {k: run["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"decode launches {got} != expected {want} "
                             f"(stats {run['engine']})")


def serve(cfg, params, seed: int = 0) -> dict:
    """llama3_8b at full width through the dense bf16 engine behind the
    HTTP frontend."""
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                         device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    run = drive(engine, prompts, repeat=0, same_as_batch=True)
    expect_decode_kernel(run, "decode_attention", cfg.n_layers)
    ref = check_against_recompute(cfg, params, prompts[0],
                                  run["tokens"][0][:8])
    del engine
    torch.cuda.empty_cache()
    return {"model": "llama3_8b", "params": cfg.num_params(),
            "setup_s": setup_s, **run, "recompute_check": ref}


def shared_prefix_prompts(vocab: int, seed: int):
    """Four prompts that share one SHARED-token prefix, then four that
    share nothing."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, SHARED).tolist()
    return ([prefix + rng.integers(0, vocab, n).tolist()
             for n in SHARED_SUFFIXES]
            + [rng.integers(0, vocab, n).tolist() for n in OTHER_LENS])


def serve_cached(cfg, params, kv_quant: str, paged: bool,
                 seed: int = 1) -> dict:
    """llama3_8b through the paged engine (bf16 or int8 pool) or the
    dense engine with the int8 cache, behind the HTTP frontend, on
    shared-prefix traffic."""
    t0 = time.perf_counter()
    if paged:
        engine = PagedServeEngine(cfg, params, max_slots=SLOTS,
                                  max_len=MAX_LEN, block_size=BLOCK_SIZE,
                                  device="cuda", kv_quant=kv_quant)
        kernel = "paged_decode_attention" if kv_quant == "none" \
            else "decode_attention_quant"
    else:
        engine = ServeEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                             device="cuda", kv_quant=kv_quant)
        kernel = "decode_attention_quant"
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = shared_prefix_prompts(cfg.vocab_size, seed)
    run = drive(engine, prompts, repeat=REPEAT, same_as_batch=not paged)
    expect_decode_kernel(run, kernel, cfg.n_layers)
    out = {"paged": paged, "kv_quant": kv_quant, "setup_s": setup_s, **run}
    if paged:
        out.update(check_prefix_hits(run, prompts))
    # The repeat was served past a cached prefix (paged) and through the
    # kernel of the phase; so was the batch's request, unless it was the
    # first of the sharers admitted.  Every served token is checked.
    margin = RECOMPUTE_MARGIN["int8" if kv_quant == "int8" else "bf16"]
    batch, again = run["tokens"][REPEAT], run["repeat_tokens"]
    out["recompute_check"] = {
        "batch": check_against_recompute(cfg, params, prompts[REPEAT], batch,
                                         margin, other=again),
        "repeat": check_against_recompute(cfg, params, prompts[REPEAT],
                                          again, margin)}
    print(f"recompute {'paged' if paged else 'dense'} {kv_quant}: "
          f"{json.dumps(out['recompute_check'])}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return out


def check_against_recompute(cfg, params, prompt, served,
                            margin_frac: float = RECOMPUTE_MARGIN["bf16"],
                            other=None, forward=forward_with_cache) -> dict:
    """Greedy tokens served through the cache (prefill + decode kernel)
    vs one no-cache bf16 forward of prompt + served tokens (multi-token
    plain attention): each served token must be the reference's argmax, or
    within ``margin_frac`` of the largest |logit| below its max logit.
    With ``other`` (tokens served for the same prompt another time), the
    first position where the two differ and the reference's logits of
    both tokens there (the prefixes before it are the same, so one forward
    gives both).  ``forward``: the model function served (int8 weights
    compute another function than bf16 ones)."""
    seq = torch.tensor([prompt + served], device="cuda")
    T = seq.shape[1]
    cache = init_kv_cache(cfg, 1, T, "cuda")
    with torch.no_grad():
        logits, _ = forward(cfg, params, seq, cache,
                            torch.zeros(1, dtype=torch.long, device="cuda"))
    rows = logits[0, len(prompt) - 1:T - 1]                 # predicts served
    if not torch.isfinite(rows).all():
        raise AssertionError("recompute logits are not finite")
    served_t = torch.tensor(served, device="cuda")
    gap = rows.max(-1).values - rows.gather(-1, served_t[:, None])[:, 0]
    margin = margin_frac * rows.abs().max().item()
    agree = int((rows.argmax(-1) == served_t).sum())
    if gap.max().item() > margin:
        raise AssertionError(f"served tokens are not the recompute's greedy "
                             f"choices: gaps {gap.tolist()} > {margin}")
    out = {"tokens": len(served), "argmax_agree": agree,
           "max_gap": gap.max().item(), "margin": margin}
    if other is not None:
        i = next((i for i, (a, b) in enumerate(zip(served, other))
                  if a != b), None)
        out["divergence"] = None if i is None else {
            "index": i, "served": served[i], "other": other[i],
            "served_logit": rows[i, served[i]].item(),
            "other_logit": rows[i, other[i]].item(),
            "max_logit": rows[i].max().item(),
            "gap": (rows[i, served[i]] - rows[i, other[i]]).item()}
    return out


def lookup_agreement(prompt, generated, gamma: int = GAMMA) -> int:
    """How many of ``generated`` (a plain greedy run after ``prompt``)
    prompt lookup would have drafted and the model agreed with, step by
    step as the speculative engine accepts: after each emitted token, the
    draft from the history, its agreeing prefix taken, then the next
    token."""
    n = j = 0
    while j < len(generated):
        draft = prompt_lookup_draft(prompt + generated[:j + 1], gamma)
        k = 0
        while k < len(draft) and j + 1 + k < len(generated) and \
                draft[k] == generated[j + 1 + k]:
            k += 1
        n += k
        j += k + 1
    return n


def loop_prompts(cfg, params, seed: int):
    """Prompts on which prompt lookup drafts and the model agrees, for
    the speculation phases.  Random weights repeat a long random phrase
    no more than any text: after it, the model's tokens are not in the
    prompt, so nothing drafts (at llama3_8b: repeats of 16- and 48-token
    phrases, prompts quoting their own continuation, the one-token map's
    fixed points and cycles; PERF.md).  After a long repeat of a
    phrase of a few tokens, though, the model often falls into a short
    loop of its own, as language models do on repetitive text, and
    prompt lookup then drafts what it says next.  For each length of
    PROMPT_LENS[2:], LOOP_PERIODS seeded phrases are repeated to it and
    probed by plain dense engines, in bf16 and with int8 weights, for
    LOOP_PROBE greedy tokens; the phrase whose run lookup would have
    drafted most of (``lookup_agreement``, the smaller of the two) serves,
    after two random prompts."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    lens = PROMPT_LENS[2:]
    cands = [[(phrase * (n // p + 1))[:n] for p in LOOP_PERIODS
              for phrase in [rng.integers(0, cfg.vocab_size, p).tolist()]]
             for n in lens]
    flat = [c for per_len in cands for c in per_len]
    scores = []
    for weight_quant in ("none", "int8"):
        engine = ServeEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                             device="cuda", weight_quant=weight_quant)
        for k, prompt in enumerate(flat):
            engine.add_request(Request(str(k), prompt,
                                       max_new_tokens=LOOP_PROBE))
        got = {int(r.request_id): r.tokens for r in engine.run()}
        del engine
        torch.cuda.empty_cache()
        scores.append([lookup_agreement(flat[k], got[k])
                       for k in range(len(flat))])
    both = [min(a, b) for a, b in zip(*scores)]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS[:2]]
    chosen = []
    for i, per_len in enumerate(cands):
        ks = range(i * len(LOOP_PERIODS), (i + 1) * len(LOOP_PERIODS))
        best = max(ks, key=lambda k: both[k])
        prompts.append(flat[best])
        chosen.append({"len": lens[i],
                       "period": LOOP_PERIODS[best - ks.start],
                       "agreed_bf16_int8": [scores[0][best],
                                            scores[1][best]]})
    return prompts, {"chosen": chosen, "seconds": time.perf_counter() - t0}


def weight_bytes(params) -> dict:
    """Bytes of the quantised leaves (int8 values and float32 scales) and
    of the same leaves in bf16."""
    int8 = bf16 = 0
    for leaf in [params["lm_head"], *params["layers"].values()]:
        if isinstance(leaf, dict):
            int8 += sum(t.numel() * t.element_size() for t in leaf.values())
            bf16 += leaf["q8"].numel() * 2
    return {"int8_and_scales": int8, "bf16": bf16}


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def serve_option(name: str, cfg, params, smi: str, paged: bool,
                 prompts, repeat: int, same_as_batch: bool,
                 seed_note: str, shared_prefix: bool = False,
                 **options) -> dict:
    """llama3_8b at full width and depth through the dense or paged engine
    with the serving options (``prefill_chunk``, ``speculative``,
    ``weight_quant``, ``kv_quant``) behind the HTTP frontend: ``drive``'s
    checks, the decode kernel's launch identity (32 a decode step; prefill
    chunks and verify steps run the plain multi-query attention and launch
    none), at least one verify step with speculation, every served token
    of the batch and of the repeat against the no-cache recompute of the
    function served, with int8 weights the decode steps' memory bound,
    and on ``shared_prefix`` traffic the prefix hits."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if paged:
        engine = PagedServeEngine(cfg, params, max_slots=SLOTS,
                                  max_len=MAX_LEN, block_size=BLOCK_SIZE,
                                  device="cuda", **options)
    else:
        engine = ServeEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                             device="cuda", **options)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kv8 = options.get("kv_quant") == "int8"
    kernel = "decode_attention_quant" if kv8 else (
        "paged_decode_attention" if paged else "decode_attention")
    run = drive(engine, prompts, repeat=repeat, same_as_batch=same_as_batch)
    expect_decode_kernel(run, kernel, cfg.n_layers)
    out = {"phase": name, "paged": paged, "prompts": seed_note,
           "options": options, "setup_s": setup_s, **run}
    if shared_prefix:
        out.update(check_prefix_hits(run, prompts))
    if options.get("speculative"):
        spec = {k: run["engine"][k]
                for k in ("drafted", "accepted", "verify_steps")}
        out["spec"] = spec
        if spec["verify_steps"] == 0:
            raise AssertionError(f"{name}: no verify step ({run['engine']})")
    forward, served_params = forward_with_cache, params
    if options.get("weight_quant") == "int8":
        forward = make_weight_dequant_forward(forward_with_cache)
        served_params = engine.params
        wb = weight_bytes(engine.params)
        cache_bytes = tree_bytes(engine.cache)
        layer_bf16 = sum(v["q8"][0].numel() * 2
                         for v in engine.params["layers"].values()
                         if isinstance(v, dict))
        limit = wb["int8_and_scales"] + cache_bytes + layer_bf16 + MEM_SLACK
        used = torch.cuda.memory_allocated() - base
        decode_peak = run["decode_peak_memory_gb"] * 1e9 - base
        out["memory"] = {
            "weights_int8_and_scales": wb["int8_and_scales"],
            "weights_bf16": wb["bf16"], "cache": cache_bytes,
            "one_layer_bf16": layer_bf16, "engine_resident": used,
            "decode_peak_over_base": decode_peak, "decode_limit": limit}
        if decode_peak > limit:
            raise AssertionError(f"{name}: decode steps peaked at "
                                 f"{decode_peak} bytes > {limit}")
    margin = RECOMPUTE_MARGIN["int8" if kv8 else "bf16"]
    checks = [check_against_recompute(cfg, served_params, p, t, margin,
                                      forward=forward)
              for p, t in zip(prompts, run["tokens"])]
    checks.append(check_against_recompute(
        cfg, served_params, prompts[repeat], run["repeat_tokens"], margin,
        other=run["tokens"][repeat], forward=forward))
    out["recompute_check"] = {
        "tokens": sum(c["tokens"] for c in checks),
        "argmax_agree": sum(c["argmax_agree"] for c in checks),
        "max_gap": max(c["max_gap"] for c in checks),
        "margin": min(c["margin"] for c in checks),
        "repeat_divergence": checks[-1]["divergence"]}
    report(name, out, smi)
    del engine
    torch.cuda.empty_cache()
    return out


def report(name: str, run: dict, smi: str) -> None:
    """One line of the phase's serving numbers beside the card."""
    keep = ("ttft_ms", "decode_step_ms", "decode_tokens_per_s",
            "tokens_per_s", "tokens_per_forward", "max_memory_allocated_gb",
            "decode_peak_memory_gb", "spec", "memory", "recompute_check",
            "prefix_hit_tokens_batch", "prefix_hit_tokens_repeat")
    print(f"{name} [{smi}]: " + json.dumps(
        {k: run[k] for k in keep if k in run}), flush=True)


def check_prefix_hits(run: dict, prompts) -> dict:
    """The paged phases' prefix hits on shared-prefix traffic: admissions
    run one at a time, each publishing its full prompt blocks, so the
    three later sharers hit the whole prefix; the repeats hit every full
    block of the prompt."""
    batch_hits = run["engine_after_batch"]["prefix_hit_tokens"]
    repeat_hits = (run["engine"]["prefix_hit_tokens"] - batch_hits) // 2
    full = len(prompts[REPEAT]) // BLOCK_SIZE * BLOCK_SIZE
    print(f"prefix hits: batch {batch_hits}, repeat {repeat_hits}",
          flush=True)
    if batch_hits != (len(SHARED_SUFFIXES) - 1) * SHARED or \
            repeat_hits != full:
        raise AssertionError(f"prefix hits: batch {batch_hits} != "
                             f"{(len(SHARED_SUFFIXES) - 1) * SHARED} or "
                             f"repeat {repeat_hits} != {full}")
    return {"prefix_hit_tokens_batch": batch_hits,
            "prefix_hit_tokens_repeat": repeat_hits}


def serve_options(cfg, params, smi: str) -> dict:
    """The serving options at llama3_8b: (a) chunked prefill, dense and
    paged; (b) speculation, dense and paged; (c) int8 weights, dense, and
    paged with the int8 cache, chunked prefill and speculation."""
    rng_prompts = [np.random.default_rng(0).integers(0, cfg.vocab_size, n)
                   .tolist() for n in PROMPT_LENS]
    shared = shared_prefix_prompts(cfg.vocab_size, 1)
    loops, chosen = loop_prompts(cfg, params, 2)
    print(f"speculation prompts: {json.dumps(chosen)}", flush=True)
    out = {}
    out["serve_chunked_dense"] = serve_option(
        "serve_chunked_dense", cfg, params, smi, False, rng_prompts, 0, True,
        "random, seed 0", prefill_chunk=PREFILL_CHUNK)
    out["serve_chunked_paged"] = serve_option(
        "serve_chunked_paged", cfg, params, smi, True, shared, REPEAT, False,
        "shared prefix, seed 1", shared_prefix=True,
        prefill_chunk=PREFILL_CHUNK)
    for paged in (False, True):
        name = f"serve_spec_{'paged' if paged else 'dense'}"
        out[name] = serve_option(name, cfg, params, smi, paged, loops, 7,
                                 False, "looping repeats, seed 2",
                                 speculative=GAMMA)
        out[name]["loop_prompts"] = chosen
    out["serve_wq_dense"] = serve_option(
        "serve_wq_dense", cfg, params, smi, False, rng_prompts, 0, True,
        "random, seed 0", weight_quant="int8")
    out["serve_wq_combo"] = serve_option(
        "serve_wq_combo", cfg, params, smi, True, loops, 7, False,
        "looping repeats, seed 2", weight_quant="int8", kv_quant="int8",
        prefill_chunk=PREFILL_CHUNK, speculative=GAMMA)
    return out


def serve_surface(cfg, params, smi: str, seed: int = 3) -> dict:
    """(d) The serve surface at llama3_8b: one streamed request on a dense
    engine with a metrics registry, whose NDJSON token lines, joined, must
    equal the blocking response's tokens for the same prompt (and pass the
    recompute); then GET /metrics must parse, and carry the
    request-phase histogram's buckets for queue, prefill and decode."""
    engine = ServeEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                         device="cuda", metrics=MetricsRegistry())
    fe = ServeFrontend(engine)
    srv, url = fe.serve_background("127.0.0.1", 0)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, 200).tolist()
    try:
        reset_counts()
        req = urllib.request.Request(
            f"{url}/v1/completions", data=json.dumps({
                "prompt_tokens": prompt, "max_tokens": MAX_TOKENS,
                "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            ctype = resp.headers["Content-Type"]
            docs = [json.loads(line) for line in resp]
        _, _, body = post(url, {"prompt_tokens": prompt,
                                "max_tokens": MAX_TOKENS})
        launches = serve_counts()
        stats = fe.stats()
        with urllib.request.urlopen(f"{url}/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
        fe.close()
    lines, final = docs[:-1], docs[-1]
    streamed = [t for d in lines for t in d["tokens"]]
    if ctype != "application/x-ndjson" or \
            any(set(d) != {"tokens"} for d in lines) or \
            final.get("num_tokens") != len(streamed) or \
            streamed != body["tokens"]:
        raise AssertionError(f"stream {docs} != blocking {body}")
    check_rmsnorm_launches(engine, launches, stats)
    expect_decode_kernel({"engine": stats, "launches": launches},
                         "decode_attention", cfg.n_layers)
    series = {}
    for line in metrics.splitlines():
        if line.startswith("#") or not line:
            continue
        m = re.fullmatch(r'([a-z_]+)(\{[^}]*\})? (\S+)', line)
        if m is None:
            raise AssertionError(f"/metrics line does not parse: {line!r}")
        series[m[1] + (m[2] or "")] = float(m[3])
    for phase in ("queue", "prefill", "decode"):
        key = ("tpu_serve_request_duration_seconds_bucket"
               f'{{phase="{phase}",le="+Inf"}}')
        if series.get(key) != 2.0:
            raise AssertionError(f"/metrics: {key} = {series.get(key)}")
    out = {"phase": "serve_surface", "stream_lines": len(lines),
           "tokens": streamed, "ttft_ms": [body["ttft_ms"]],
           "decode_step_ms": 1e3 * stats["decode_s"] / stats["decode_steps"],
           "decode_tokens_per_s": stats["decode_tokens"] / stats["decode_s"],
           "metrics_series": len(series), "launches": launches,
           "engine": stats,
           "recompute_check": check_against_recompute(cfg, params, prompt,
                                                      streamed)}
    report("serve_surface", out, smi)
    del engine
    torch.cuda.empty_cache()
    return out


def reset_counts() -> None:
    rn.launches = da.launches = da.launches_quant = pa.launches = 0
    fa.fwd_launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
    ra.launches = 0


def train_counts() -> dict:
    return {"flash_fwd": fa.fwd_launches,
            "flash_bwd_dkv": fa.bwd_dkv_launches,
            "flash_bwd_dq": fa.bwd_dq_launches, "rmsnorm": rn.launches,
            "ring_attention_fwd": ra.launches}


TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 2048


def profile_step(step, state, batch) -> dict:
    """One more step under torch.profiler: device time by kernel name, and
    the union of the kernels' intervals against the step's host-clock wall
    time, so the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step(state, batch)
        float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, spans = {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a) / 1e3
        spans.append((a, b))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    busy_ms = busy / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_ms_total": sum(by_name.values()),
            "kernel_events": len(spans),
            "idle_share": (1 - busy_ms / wall_ms) if spans else None,
            "top_kernels_ms": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:25]}


def train(seed: int = 0, profile: bool = False) -> dict:
    """llama_1b at full width and depth: the launcher on the synthetic
    shard (bf16 masters), then 8 steps on one fixed batch with f32
    masters (and with ``profile``, one more under torch.profiler)."""
    cfg = llama.CONFIGS["llama_1b"]
    L = cfg.n_layers
    per_step = {"flash_fwd": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L,
                "rmsnorm": 2 * 2 * L + 1,          # full remat: fwd twice
                "ring_attention_fwd": 0}
    argv = ["--model", "llama_1b", "--batch", str(TRAIN_BATCH), "--seq-len",
            str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--warmup", "1",
            "--log-every", "1", "--seed", str(seed)]
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = launcher.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = train_counts()
    print(buf.getvalue(), end="", flush=True)
    steps = [re.fullmatch(r"step (\d+) loss (\S+) tok/s (\d+)", ln)
             for ln in buf.getvalue().splitlines() if ln.startswith("step ")]
    if rc != 0 or len(steps) != TRAIN_STEPS or not all(steps):
        raise AssertionError(f"launcher: rc {rc}, output {buf.getvalue()!r}")
    losses = [float(m.group(2)) for m in steps]
    tok_s = [float(m.group(3)) for m in steps]
    expect = math.log(cfg.vocab_size) + 0.5
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - expect) > 0.3:
        raise AssertionError(f"launcher losses {losses} (first expected "
                             f"within 0.3 of {expect:.3f})")
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"train launches {launches} != {want}")
    launcher_peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    run = {"argv": argv, "wall_s": wall_s, "losses": losses, "tok_s": tok_s,
           "step_ms": [tokens / t * 1e3 for t in tok_s],
           "launches": launches, "launches_per_step": per_step,
           "max_memory_allocated_gb": launcher_peak}

    # One fixed batch, f32 masters: the loss must fall.
    tc = ts.TrainConfig(learning_rate=3e-4, warmup_steps=1,
                        decay_steps=TRAIN_STEPS, param_dtype="float32")
    opt = ts.make_optimizer(tc)
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_train_state(
        cfg, opt, torch.Generator(device="cuda").manual_seed(seed),
        tc.param_dtype, "cuda")
    step = ts.make_train_step(cfg, tc, opt)
    raw = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    batch = {"tokens": torch.tensor(raw[:, :-1], dtype=torch.int32,
                                    device="cuda"),
             "targets": torch.tensor(raw[:, 1:], dtype=torch.int32,
                                     device="cuda")}
    fixed = {"loss": [], "grad_norm": [], "step_ms": []}
    reset_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        fixed["loss"].append(float(m["loss"]))
        fixed["grad_norm"].append(float(m["grad_norm"]))
        fixed["step_ms"].append((time.perf_counter() - t0) * 1e3)
    fixed_launches = train_counts()
    fixed["launches"] = fixed_launches
    fixed["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if profile:
        fixed["profile"] = profile_step(step, state, batch)
    print(f"fixed batch (f32 masters): {json.dumps(fixed)}", flush=True)
    vals = fixed["loss"] + fixed["grad_norm"]
    if not all(math.isfinite(x) for x in vals) or \
            fixed["loss"][-1] > fixed["loss"][0] - 0.5 or \
            fixed_launches != want:
        raise AssertionError(f"fixed-batch training failed: {fixed}")
    del state, batch
    torch.cuda.empty_cache()
    steady = sorted(run["step_ms"][1:])
    run["step_ms_median_steady"] = steady[len(steady) // 2]
    return {"model": "llama_1b", "params": cfg.num_params(),
            "launcher": run, "fixed_batch": fixed}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more fixed-batch training step of "
                         "each training phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {[p.name for p in libs]} in {build_s:.2f} s", flush=True)
    hopper = hopper_resources(libs)
    print(f"hopper attention kernels (ptxas): {json.dumps(hopper)}",
          flush=True)
    decode_res = decode_resources(libs)
    print(f"decode kernels (ptxas): {json.dumps(decode_res)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rms = check_rmsnorm(gen)
    dec = check_decode(gen)
    decq = check_decode_quant(gen)
    paged = check_paged(gen)
    decode_smem(decode_res)
    for name, res in (("decode_attention", dec),
                      ("decode_attention_quant", decq),
                      ("paged_decode_attention", paged)):
        t = res["main"]
        print(f"{name}: {t['graph_ms']:.5f} ms graph (SDPA "
              f"{t['library_graph_ms']:.5f}), {t['ms']:.5f} eager, bound "
              f"{t['bound_ms']:.5f}; chunk {t['chunk']}, {t['nsplit']} "
              f"splits, workspace {t['workspace_bytes']} bytes, merge "
              f"{t['merge_graph_ms']:.5f} ms; resources "
              f"{json.dumps(decode_res[name]['D128G4'])}", flush=True)
    flash = check_flash(gen)
    xe = check_xent(gen)
    ring = check_ring(gen)
    hopper_smem(hopper)
    rbwd = flash["ring_past_bwd"]
    for name, t, kernel in (
            ("flash_fwd", flash["flash_fwd"]["main"], "flash_fwd"),
            ("flash_bwd_dkv", flash["flash_bwd_dkv"]["main"],
             "flash_bwd_dkv"),
            ("flash_bwd_dq", flash["flash_bwd_dq"]["main"], "flash_bwd_dq"),
            ("flash_bwd_dkv, ring past block", rbwd["flash_bwd_dkv"],
             "flash_bwd_dkv"),
            ("flash_bwd_dq, ring past block", rbwd["flash_bwd_dq"],
             "flash_bwd_dq"),
            ("ring forward", ring["main"], "ring_attention_fwd")):
        print(f"{name}: {t['ms']:.4f} ms eager ({t['host_ms']:.4f} ms of "
              f"host enqueue), {t['graph_ms']:.4f} ms graph; "
              f"{t['tflops']:.1f} / {t['graph_tflops']:.1f} TFLOP/s "
              f"({t['graph_tflops'] / (BF16_FLOPS / 1e12):.3f} of "
              f"{BF16_FLOPS / 1e12:.0f}); bound {t['bound_ms']:.4f}; "
              f"resources {json.dumps(hopper[kernel])}", flush=True)
    for name, t in (("llama_1b", flash["pair"]), ("ring past block",
                                                  rbwd["pair"])):
        print(f"flash backward pair, {name}: {t['ms']:.4f} ms eager, "
              f"{t['graph_ms']:.4f} ms graph ({t['graph_tflops']:.1f} "
              f"TFLOP/s), bound {t['bound_ms']:.4f}; ATen's flash "
              f"backward {t['aten_ms']:.4f} ms eager", flush=True)
    torch.cuda.empty_cache()
    # One llama3_8b tree (16 GB of bf16 weights) serves every serve phase.
    cfg = llama.CONFIGS["llama3_8b"]
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    srv = serve(cfg, params)
    cached = {"serve_paged": serve_cached(cfg, params, "none", paged=True),
              "serve_int8_paged": serve_cached(cfg, params, "int8",
                                               paged=True),
              "serve_int8_dense": serve_cached(cfg, params, "int8",
                                               paged=False)}
    for name, run in {"serve": srv, **cached}.items():
        print(f"{name}: " + json.dumps(
            {k: v for k, v in run.items()
             if k not in ("engine", "engine_after_batch", "tokens")}),
            flush=True)
    options = serve_options(cfg, params, smi)
    options["serve_surface"] = serve_surface(cfg, params, smi)
    del params
    torch.cuda.empty_cache()
    trn = train(profile=args.profile)
    print(f"train: {json.dumps(trn)}", flush=True)
    trn_ring = train_ring(profile=args.profile)
    by_path = {"serve": srv["launches"],
               **{name: run["launches"] for name, run in cached.items()},
               **{name: run["launches"] for name, run in options.items()},
               "train": trn["launcher"]["launches"],
               "train_ring": trn_ring["launches"]}

    def entry(name, route, source, replaces, res):
        m = res["main"]
        paths = {p: c[name] for p, c in by_path.items() if c.get(name)}
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": sum(paths.values()),
                "launches_by_path": paths,
                "max_abs_err": max(s["max_abs_err"] for s in res["shapes"]),
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"],
                **({"library_of": m["library_of"]} if "library_of" in m
                   else {}),
                **({"graph_ms": m["graph_ms"], "tflops": m["tflops"],
                    "graph_tflops": m["graph_tflops"],
                    "resources": hopper[name]}
                   if name in hopper else {}),
                **({"graph_ms": m["graph_ms"],
                    "library_graph_ms": m["library_graph_ms"],
                    "chunk": m["chunk"], "nsplit": m["nsplit"],
                    "merge_graph_ms": m["merge_graph_ms"],
                    "resources": decode_res[name][f"D{HD}G{HQ // HKV}"]}
                   if name in decode_res else {})}

    kernels = {"kernels": [
        entry("rmsnorm", "triton", "kuberay_tpu_torch/ops/rmsnorm.py",
              "kuberay_tpu/ops/rmsnorm.py:27", rms),
        entry("decode_attention", "cuda",
              "kuberay_tpu_torch/csrc/decode_attention.cu",
              "kuberay_tpu/ops/decode_attention.py:150", dec),
        entry("decode_attention_quant", "cuda",
              "kuberay_tpu_torch/csrc/decode_attention.cu",
              "kuberay_tpu/ops/decode_attention.py:150", decq),
        entry("paged_decode_attention", "cuda",
              "kuberay_tpu_torch/csrc/paged_attention.cu",
              "kuberay_tpu/ops/paged_attention.py:69", paged),
        *(entry(name, "cuda", "kuberay_tpu_torch/csrc/flash_attention.cu",
                f"kuberay_tpu/ops/attention.py:{line}", flash[name])
          for name, line in (("flash_fwd", 70), ("flash_bwd_dkv", 172),
                             ("flash_bwd_dq", 222))),
        entry("ring_attention_fwd", "cuda",
              "kuberay_tpu_torch/csrc/ring_attention.cu",
              "kuberay_tpu/parallel/ring_pallas.py:72", ring),
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": kind, "nvidia_smi": smi, "torch": torch.__version__,
        "build_s": build_s, "hopper_resources": hopper,
        "decode_resources": decode_res,
        "build_log": {p.name: p.with_suffix(".log").read_text()
                      for p in libs},
        "rmsnorm": rms, "decode_attention": dec,
        "decode_attention_quant": decq, "paged_decode_attention": paged,
        "flash": flash, "chunked_xent": xe, "ring": ring, "serve": srv,
        **cached, **options, "train": trn, "train_ring": trn_ring,
        **kernels}, indent=1))
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
