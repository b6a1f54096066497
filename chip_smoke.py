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
   RMSNorm's forward (the CUDA kernel of ``csrc/rmsnorm.cu``) at every
   serving and training row count, then at odd cases (``RMS_ODD``: rows 0
   and 1, d 4100 and 1000, f16, f32, a weight dtype unlike x's, an x view
   not 16-byte aligned, a row past the register path), each also a second
   call bit for bit, with its launch plan and its instantiation's
   registers, shared memory and spills from ptxas (a spill in any of the
   36 instantiations fails the run).
   RMSNorm's backward (``rmsnorm_bwd``: the Triton row kernel and the
   partials sum) at every training shape (8192, 4096, 2048 and 300 rows
   of 2048, 4096 x 4096, 64 x 8192), dx and dw against ``rmsnorm_bwd_ref``
   in the flash kernels' element-wise and norm limits, two calls bit for
   bit, dx alone, dw alone, a strided and an expanded g; timed beside the
   plain chain (autograd through ``rmsnorm_ref``) and ``F.rms_norm``'s
   backward, the partials sum alone beside ``sum``; an empty Triton
   kernel's and an empty CUDA kernel's time and host enqueue (the launch
   floors) beside the 8-row forward's.
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
   64, the ring's two block shapes (B 2, shards of 1024, llama_1b's
   heads; causal on the diagonal, not causal on past blocks) and a
   pipeline stage's microbatch (B 1, S 2048, 16 / 8): out and lse
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
   forward; the bf16 paged engine's decode steps and its prefills from
   cache position 0 are CUDA graph replays, each counted as the launches
   it replays, and every decode step and prefill of every phase with an
   int8 pool or weights, Mixtral, tp or the dense engine, and every
   prefill past a cached prefix, is eager), and all
   32 of the batch's and of the repeat's tokens against
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
   KV tiers (``serve_tiers``): the same weights through
   PagedServeEngine(block_size=16, 384 blocks, host_blocks=512) behind the
   frontend: 8 prompts of 519-1500 tokens (4 share a 512-token prefix),
   32 new tokens each; the same wave again while its blocks are on the
   card; the demotions still queued drained; 6 unrelated 1500-token
   prompts that cannibalise every block of the first wave; the first wave
   again.  The repeat must promote from the host tier and prefill fewer
   tokens than the first wave, its tokens must equal the warm wave's bit
   for bit, and the first wave's and the repeat's tokens must pass the
   no-cache recompute.  Prints demotions per step, device-to-host and
   host-to-device ms a block.  Disaggregated serving (``serve_disagg``):
   two PagedServeEngines sharing the weights, each behind its frontend;
   the gateway's calls in its order (prefill replica for one token,
   ``/v1/kv/resident`` on the decode replica, ``/v1/kv/export`` past the
   resident blocks, ``/v1/kv/import``, then the prompt and its first
   token on the decode replica) for prompts of 519, 1023 (sharing the
   first's prefix) and 1500 tokens: the imported blocks' prefix hits, the
   prefill replica's own tokens for the same body, the recompute, a
   second handoff that sends nothing, the seven load headers; prints the
   bytes and export and import ms a block.
   Mixtral (``mixtral_serve``): mixtral_8x7b at its published widths
   (d 4096, 32/8 heads of 128, d_ff 14336, 8 experts top-2, vocab 32000,
   RoPE theta 1e6) and 8 of its 32 layers (seeded random bf16, about 23.8
   GB; the full depth does not fit one card), through the dense bf16
   engine on the serve prompts, the paged engine on the shared-prefix
   prompts and the dense engine with int8 weights, as the serving options
   above: 17 RMSNorms a forward, 8 decode-kernel launches a decode step,
   8 host syncs of the grouped expert FFN a forward; rows per expert.
   ``mixtral_train``: ``mixtral.loss_fn`` forward and backward (no
   optimizer) at the same widths, 4 layers, B 2 x S 2048, full remat,
   chunked CE 8192, three steps: finite loss and gradients, the aux
   losses, 8 flash forwards, 4 dK/dV, 4 dQ, 17 RMSNorms and 9 RMSNorm
   backwards (each a row kernel and a partials sum) a step.
   Tensor-parallel serving (``serve_tp``, on the llama3_8b weights
   before they are freed): the bf16, int8 and paged decode kernels at a
   tp rank's local head counts, 16 q / 4 kv heads (tp=2) and 2 / 1
   (tp=16: tp=8 x tpr=2), S 8, M 2048, lens 0..2048, against their plain
   versions (element-wise limits) and timed beside SDPA with their
   bounds and split plans; ptxas' resources of the group-2
   instantiations.  Then the server as a process group on this card
   (``python -c`` + ``runpy`` of ``kuberay_tpu_torch.serve.server``,
   each rank's launch counts, weight bytes and peak memory printed at
   exit): two ranks at ``--tp 2 --dist-backend gloo`` (the worker env,
   LOCAL_RANK 0, collectives staged through pinned host memory), seed 0's
   weights drawn into each rank's shards, 8 slots x 2048, dense bf16,
   paged bf16 (4 of 8 prompts share a 256-token prefix: 768 prefix-hit
   tokens) and dense int8 KV, each on 8 concurrent greedy requests of
   7-512 tokens with 32 new: every served token within the no-cache
   recompute's margin of the whole tree, each rank's weights within 1%
   of half the tree's bytes, each rank 65 RMSNorms a forward and 32
   launches of the variant's decode kernel a decode step, the follower's
   replay equal to rank 0's device calls, and both ranks exiting 0 after
   SIGTERM, the drain and STOP; a one-rank NCCL group (``--tp 1
   --dist-backend nccl``, the lockstep engine) on the serve phase's
   prompts, its tokens bit for bit the serve phase's; a follower killed
   (SIGKILL) mid-decode, after which rank 0's ``/healthz`` must answer
   503 within TP_MISS + 5 s and the pending request 503 (every wait
   bounded).  The ranks' launches go into ``launches_by_path`` as
   ``serve_tp``.
   The KV tiers and the block transfer under tp (``serve_tp_tiers``):
   the server as two ranks at ``--tp 2 --paged --num-blocks 192
   --host-blocks 512`` on gloo (rank 0 holds the tier store; every block
   copy is a plan the follower replays, its kv heads gathered to or
   scattered from rank 0 through the host), through ``serve_tiers``'
   waves on serve_tp's paged prompts: the first wave, the warm wave,
   requests of 48 decode steps until no demotion is queued, an evicting
   wave of 6 prompts of 1200 tokens, the first wave again, which must
   promote from the host tier, prefill fewer tokens than the first wave
   and give the warm wave's tokens; every token within the no-cache
   recompute's margin of the whole tree.  Then a one-process paged
   replica with the same tiers: a prompt handed from the group to the
   replica and one from the replica to the group over ``/v1/kv/*`` (each
   receiver's prefix hits cover the imported blocks, its tokens pass the
   recompute), and the group's export of a third prompt held to the
   replica's export of it and to a float32 forward's K/V of it, layer by
   layer, within 20% of the layer's largest |value| (sound bf16 exports
   read under 5%, a head in the wrong place or missing about 100%).  The follower must replay every plan rank 0
   broadcast (the block plans among them), both ranks launch 65
   RMSNorms a forward and 32 paged decode attentions a decode step;
   prints the demotion, promotion, export and import ms a block (rank
   0's, host-staged) beside the card's name and power limit.
4. Train: runs the launcher (``kuberay_tpu_torch.train.launcher.main``)
   on llama_1b at full width and depth, batch 4 x 2048, 8 steps, bf16
   masters, on the synthetic shard; then 8 steps of make_train_step on
   one fixed batch with float32 masters.  Checks every loss and gradient
   norm is finite, the first loss is within 0.3 of ln(V) + 1/2 (the
   expected loss of unit-variance random logits, which is what the
   scaled init gives), the fixed batch's loss falls by at least 0.5, and
   the launch counts per step are exactly 32 flash forwards (16 layers,
   run again under full remat), 16 dK/dV, 16 dQ, 65 RMSNorms and 33
   RMSNorm backwards (a row kernel and a partials sum each).  With
   ``--profile``, one more fixed-batch step runs under torch.profiler:
   device time by kernel name, the device's idle share, and one device
   kernel of each RMSNorm backward kernel's name a launch.
   Then long-context training: llama_1b at full width and depth with
   attn_impl="ring_rdma", B 2 x S 4096 on LocalRing(4) (the sp ring's 4
   ranks on this card), 8 fixed-batch steps of make_sharded_train_fns
   with bf16 masters.  Checks the first loss is within 0.3 of ln(V) + 1/2
   and within 2e-2 of the same batch's loss with attn_impl="auto", the
   loss falls by at least 0.5, and the launch counts per step are exactly
   32 ring forwards (one a layer, run again under full remat), 160 dK/dV
   and 160 dQ (one each per causal block of the ring's 4 ranks, 16
   layers), no flash forward, 65 RMSNorms and 33 RMSNorm backwards.  With
   ``--profile``, one more step likewise.
5. Train to serve (``train_to_serve``): llama_1b, 4 x 2048, bf16 masters,
   checkpoints in a temporary directory whose free space (printed) must
   hold three saves of about 6.85 GB, with a coordinator recorder on
   127.0.0.1 at the dashboard port.  (a) The library: 2 steps,
   ``CheckpointWriter.save_async(state, 2)`` (a host clone kept aside), 2
   more steps while it writes, ``save_async(state, 4)``, ``close()``;
   ``restore(dir, 2)`` into another seed's fresh state equals the clone
   bit for bit, its integer leaves included.  (b) The launcher with
   ``--steps 6 --checkpoint-dir`` resumes at 4, prints steps 5-6 only,
   feeds the seed's first two batches again (the JAX launcher's loader
   restarts from its seed too), launches the ``train`` phase's per-step
   counts twice, leaves steps 2, 4 and 6 on disk, posts heartbeats and
   ``train_step`` events for steps 5-6 to the recorder and serves the
   five ``tpu_train_*`` gauges on ``/metrics`` (``TPU_PEAK_TFLOPS=989``).
   (c) ``python -m kuberay_tpu_torch.serve.server --checkpoint-dir
   --coordinator auto`` as a process (its kernel launch counts printed at
   exit): RUNNING at the recorder once it serves; 8 concurrent greedy
   requests (7-1500 tokens, 32 new), each served token within the
   no-cache recompute's margin of the restored params, which equal step
   6's params bit for bit and differ from seed 0's in every matrix (not
   the norms: their bf16 ones stay 1.0 under such small updates);
   exactly 33 RMSNorms a forward and 16 decode attentions a decode step;
   after SIGTERM, STOPPED, then ``drained=True``.  Prints the bytes of a
   save, ``save_async``'s return (the snapshot), the commits, the steps
   with a write in flight against the launcher's steady step, restore and
   ``load_params_for_serving`` seconds, the server's start to its first
   token and the heartbeats, beside the card's name and power limit.
6. The entry points, the bench and the profiler hook:
   ``profile`` (after the serve phases, on the same llama3_8b weights):
   ``ProfileHook.start_profile(duration_s=120)`` around eight dense bf16
   decode steps of 8 slots (the serve prompts, prefilled before the
   capture), stopped after them; the Chrome trace must hold CUDA kernels
   named after the decode kernel and RMSNorm, exactly 65 RMSNorms and 32
   decode attentions a step launched; prints the ten longest device
   operations, the longest gaps between device operations and the
   device's idle share over the capture.  ``bench`` (after ``train``):
   ``python -m kuberay_tpu_torch.bench`` as a process; its JSON line has
   the JAX bench's keys and its median step (CUDA events) lies within 10%
   of the ``train`` phase's steady launcher step at the same shape.
   ``entry``: ``entry()``'s llama_1b forward at 1 x 512 on its all-zero
   tokens against the plain forward (attn_impl="xla") on the same params,
   element by element (``local_err``), 33 RMSNorms and 16 flash forwards
   a call; on seeded random tokens, no further from the float32 plain
   forward than ENTRY_F32_FACTOR times the bf16 plain forward is.
7. ``mesh_train``: the launcher over a real process group on this card,
   llama_1b's full width at 4 of its 16 layers, B 4 x S 2048, float32
   masters and bf16 compute, 2 steps at lr 2e-5 without warm-up: one
   process (the reference), a one-rank NCCL group (``--dist-backend
   nccl``: NCCL's initialisation and a barrier, then the sharded step
   over a mesh of ones), then fsdp=2, tp=2 and dp=2 (two slices of one
   worker), each two ranks on gloo with the collectives staged through
   pinned host buffers (``HostStagedGloo``, named in rank 0's output).
   Each run's losses (its lead's ``train_step`` events at a coordinator
   recorder) are held to the reference's within MESH_LOSS_ATOL, and
   each param leaf's change over the run (its sharded checkpoint, read
   back whole by ``load_params_for_serving``, less the seed's params)
   to the reference's change within MESH_DELTA_RTOL of its norm; every
   rank launches 8 flash forwards, 4 dK/dV, 4 dQ, 17 RMSNorms and 9
   RMSNorm backwards a step.  Prints each rank's peak memory, the step
   times, the launches and the readings.
8. ``pipeline``: ``parallel/pipeline.py::pipeline_apply`` over llama_1b's
   16 layers (``llama._layer``) at full width as 2 stages of 8, one
   process a stage sharing the card over gloo (the hops through pinned
   host memory), B 4 x S 2048 in 4 microbatches, bf16, forward and
   backward of ``(out.float() ** 2).sum()``: each rank's output bit for
   bit the same layers applied microbatch by microbatch in its process,
   its stage's gradients within 2^-7 in norm of that run's (the other
   stage's rows zero), 32 flash forwards, 32 dK/dV, 32 dQ, 64 RMSNorms
   and 64 RMSNorm backwards a rank a step; prints the launches and step
   ms.
   ``bench_profile``: ``python -m kuberay_tpu_torch.bench --profile-out
   PATH`` as a process: its stdout line with the bench's keys, and a
   ``tpu-profile/v1`` document with one ``train`` record a timed step,
   each of ``dispatch`` and ``host-fetch``, and the bench's meta.  The
   bench, here and in ``bench``, prints its kernel launches at exit,
   held to the launcher's per step for its warm-up and timed steps.
9. Prints each phase's wall seconds and the total, then the kernels'
   JSON line, and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Details go to chiprun_out/chip_smoke.json beside this script.  Any failure
raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from kuberay_tpu_torch import entry as entry_mod
from kuberay_tpu_torch.models import llama, mixtral
from kuberay_tpu_torch.ops import _build
from kuberay_tpu_torch.ops import attention as fa
from kuberay_tpu_torch.ops import decode_attention as da
from kuberay_tpu_torch.ops import launches as counters
from kuberay_tpu_torch.ops import paged_attention as pa
from kuberay_tpu_torch.ops import ring_attention as ra
from kuberay_tpu_torch.ops import rmsnorm as rn
from kuberay_tpu_torch.ops import xent
from kuberay_tpu_torch.parallel.mesh import LocalRing
from kuberay_tpu_torch.parallel.ring import ring_attention
from kuberay_tpu_torch.runtime import profiler as profiler_mod
from kuberay_tpu_torch.runtime.profiler import ProfileHook
from kuberay_tpu_torch.train import checkpoint as ckpt
from kuberay_tpu_torch.train import launcher
from kuberay_tpu_torch.train import train_step as ts
from kuberay_tpu_torch.train.data import TokenShardLoader, synthetic_shard
from kuberay_tpu_torch.serve.engine import (
    Request,
    ServeEngine,
    prompt_lookup_draft,
)
from kuberay_tpu_torch.serve.kv_cache import (
    _cached_attention,
    base_forward_for,
    forward_with_cache,
    init_kv_cache,
    quantize_kv,
)
from kuberay_tpu_torch.serve.paged_engine import PagedServeEngine
from kuberay_tpu_torch.serve.paged_kv import quant_view
from kuberay_tpu_torch.serve.server import ServeFrontend
from kuberay_tpu_torch.serve.weight_quant import make_weight_dequant_forward
from kuberay_tpu_torch.utils.constants import PORT_DASHBOARD
from kuberay_tpu_torch.utils.httpjson import JsonHandler, serve_background
from kuberay_tpu_torch.utils.metrics import MetricsRegistry

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
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
# KV tiers (serve_tiers): a pool of TIER_BLOCKS blocks that holds the
# first wave whole (its 8 prompts and their decode blocks take about 355),
# so its warm repeat and its promoted repeat prefill the same tails; a
# host tier of TIER_HOST blocks; an evicting wave of EVICT_LENS prompts of
# one new token each, which needs more blocks than the pool has.
TIER_BLOCKS, TIER_HOST = 384, 512
TIER_OTHER_LENS = (600, 900, 1024, 1500)
EVICT_LENS = (1500,) * 6
# Disaggregated serving (serve_disagg): two paged replicas with host tiers
# (so every KV load header is sent), the gateway's calls in its order.
DISAGG_HOST, DISAGG_LONG = 256, 1500
# Mixtral: mixtral_8x7b's published widths at MIXTRAL_SERVE_LAYERS of its
# 32 layers for serving (about 23.8 GB of bf16 weights; the full depth's
# 93 GB does not fit one card) and MIXTRAL_TRAIN_LAYERS for the training
# step (weights and their gradients), B 2 x S 2048.
MIXTRAL_SERVE_LAYERS, MIXTRAL_TRAIN_LAYERS = 8, 4
MIXTRAL_B, MIXTRAL_S, MIXTRAL_STEPS = 2, 2048, 3
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


def graph_ms(fn, iters: int, stream=None) -> float:
    """Mean device time of one call without the host's launch cost:
    ``iters`` calls captured in one CUDA graph, replayed between CUDA
    events.  ``stream``: warm up and capture on it (an autograd graph
    built on that stream, so that its backward may be captured)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


# RMSNorm's forward beyond the main shapes: (name, rows, d, x dtype, w
# dtype, offset in values of x's start into a larger buffer).  Row counts
# 0 and 1, widths no 16-byte unit divides (4100, and 1000 at 300 rows),
# f16, f32, weights in another dtype than x's (float32 masters' casts),
# an x view not 16-byte aligned, and a row past the register path (40000
# values: the kernel's loop).  Drawn from a generator of their own, so
# the later checks' inputs stay as they were.
RMS_ODD = (("rows0", 0, 4096, torch.bfloat16, torch.bfloat16, 0),
           ("rows1_d1000", 1, 1000, torch.bfloat16, torch.bfloat16, 0),
           ("d4100", 8, 4100, torch.bfloat16, torch.bfloat16, 0),
           ("d1000", 300, 1000, torch.bfloat16, torch.bfloat16, 0),
           ("f16", 8, 4096, torch.float16, torch.float16, 0),
           ("f32", 300, 2048, torch.float32, torch.float32, 0),
           ("x_bf16_w_f32", 8, 4096, torch.bfloat16, torch.float32, 0),
           ("x_f32_w_bf16", 64, 2048, torch.float32, torch.bfloat16, 0),
           ("x_f16_w_bf16", 8, 4096, torch.float16, torch.bfloat16, 0),
           ("offset", 8, 4096, torch.bfloat16, torch.bfloat16, 3),
           ("d40000", 2, 40000, torch.bfloat16, torch.bfloat16, 0))
RMS_SEED = 16
# The forward kernel's instantiations in the build log: x and w dtype
# codes, values a unit, units a thread in registers.
RMS_KERNEL = r"rmsnorm_fwd_kernelILi(\d)ELi(\d)ELi(\d+)ELi(\d+)E"


def rms_resources(libs) -> dict:
    """Registers, static shared memory and spills of every instantiation
    of the RMSNorm forward kernel, by ``rms_plan``'s variant key, from
    ptxas.  Fails unless all 36 (3 x dtypes, 3 w dtypes, 2 unit widths, 2
    register depths) are there without a spill."""
    out = {}
    for name, r in ptxas_report(libs).items():
        m = re.search(RMS_KERNEL, name)
        if m:
            out["x{}w{}v{}n{}".format(*m.groups())] = dict(r)
    if len(out) != 36 or any(r.get("spill_stores", 1) or
                             r.get("spill_loads", 1) or "registers" not in r
                             for r in out.values()):
        raise AssertionError(f"rmsnorm_fwd_kernel: ptxas report {out} "
                             f"(expected 36 instantiations, no spills)")
    return out


def rms_plan(x: torch.Tensor, w: torch.Tensor) -> dict:
    """The plan ``rmsnorm_fwd`` launches for x and w (after a call), and
    the kernel instantiation it runs (one CTA a row)."""
    entry = rn.plans()[(x.shape, x.dtype, w.shape, w.dtype, x.device,
                        w.device)]
    args = rn.launch_args(entry, x.data_ptr(), w.data_ptr(), 0)
    plan = dict(zip(("x_dtype", "w_dtype", "vec", "threads", "nv", "pdl"),
                    args))
    nv = plan["nv"]
    plan["variant"] = "x{}w{}v{}n{}".format(
        args[0], args[1], args[2], 1 if nv <= 1 else rn.MAX_NV)
    return plan


def check_rmsnorm(gen: torch.Generator, res: dict) -> dict:
    """RMSNorm at decode (8 rows), ragged and prefill row counts of the 8B
    serving path, llama_1b's at entry() (512 rows), at a pipeline
    microbatch (2048 rows) and at mesh_train's halved batch (4096 rows),
    and llama_1b's training shape (4 x 2048 rows of 2048): the CUDA
    kernel against ``rmsnorm_ref`` within RMS_ATOL, a second call bit for
    bit, timed beside the plain version and ``F.rms_norm``, with its plan
    and its instantiation's registers (``res``, from ``rms_resources``);
    the same checks (untimed) at every RMS_ODD case; then the backward at
    every training shape (``check_rmsnorm_bwd``) and the launch floor:
    empty Triton and CUDA kernels beside the 8-row forward."""
    shapes = []
    for rows, d in ((1, D_MODEL), (8, D_MODEL), (300, D_MODEL),
                    (2048, D_MODEL), (512, 2048), (2048, 2048),
                    (4096, 2048), (8192, 2048)):
        # Uniform inputs keep |y| < 4, where one bf16 ulp is <= 1/64.
        x = (torch.rand(rows, d, generator=gen, device="cuda") * 2 - 1
             ).bfloat16()
        w = (torch.rand(d, generator=gen, device="cuda") + 0.5
             ).bfloat16()
        y = rn.rmsnorm(x, w)
        err = max_err(y, rn.rmsnorm_ref(x, w))
        if not err <= RMS_ATOL or not bits_equal(y, rn.rmsnorm(x, w)):
            raise AssertionError(f"rmsnorm rows={rows} d={d}: max abs err "
                                 f"{err} > {RMS_ATOL}, or two calls differ")
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * 2
        flops = 4 * x.numel()
        plan = rms_plan(x, w)
        shapes.append({
            "rows": rows, "d": d, "max_abs_err": err, "plan": plan,
            "resources": res[plan["variant"]],
            **timings(lambda: rn.rmsnorm(x, w),
                      lambda: rn.rmsnorm_ref(x, w),
                      lambda: F.rms_norm(x, (d,), w, 1e-5), 200, 200),
            **bound(nbytes, flops)})
        print(f"rmsnorm rows={rows} d={d}: {json.dumps(shapes[-1])}",
              flush=True)
    odd = check_rmsnorm_odd(res)
    bwd, dw_sum = check_rmsnorm_bwd(gen)
    floor = launch_floor()
    floor["rmsnorm_8_rows_graph_ms"] = shapes[1]["graph_ms"]
    floor["rmsnorm_8_rows_host_ms"] = shapes[1]["host_ms"]
    print(f"launch floor: {json.dumps(floor)}", flush=True)
    return {"shapes": shapes, "main": shapes[1], "train": shapes[-1],
            "odd": odd, "bwd": bwd, "dw_sum": dw_sum, "launch_floor": floor,
            "resources": rn.resources()}


def check_rmsnorm_odd(res: dict) -> list:
    """The forward at every RMS_ODD case against ``rmsnorm_ref`` within
    RMS_ATOL, in x's dtype and shape, one launch a call with rows, a
    second call bit for bit; each case's plan and registers."""
    gen = torch.Generator(device="cuda").manual_seed(RMS_SEED)
    out = []
    for name, rows, d, xdt, wdt, off in RMS_ODD:
        base = torch.rand(rows * d + off, generator=gen, device="cuda")
        x = (base * 2 - 1).to(xdt)[off:].view(rows, d)
        w = (torch.rand(d, generator=gen, device="cuda") + 0.5).to(wdt)
        before = counters.snapshot()["rmsnorm"]
        y = rn.rmsnorm(x, w)
        launched = counters.snapshot()["rmsnorm"] - before
        err = max_err(y, rn.rmsnorm_ref(x, w)) if rows else 0.0
        if y.dtype != xdt or y.shape != x.shape or not err <= RMS_ATOL or \
                launched != (1 if rows else 0) or \
                not bits_equal(y, rn.rmsnorm(x, w)):
            raise AssertionError(f"rmsnorm {name}: {y.dtype} "
                                 f"{tuple(y.shape)}, max abs err {err}, "
                                 f"{launched} launches, or two calls "
                                 f"differ")
        rec = {"name": name, "rows": rows, "d": d, "max_abs_err": err}
        if rows:
            rec["plan"] = rms_plan(x, w)
            rec["resources"] = res[rec["plan"]["variant"]]
        out.append(rec)
        print(f"rmsnorm {name}: {json.dumps(rec)}", flush=True)
    return out


# RMSNorm's backward at every training shape: llama_1b's step (B 4 x S
# 2048), mesh_train's halved batch, a pipeline microbatch, a ragged row
# count, mixtral_train's d 4096 (B 2 x S 2048) and llama3_70b's d 8192.
RMS_BWD_SHAPES = ((8192, 2048), (4096, 2048), (2048, 2048), (300, 2048),
                  (4096, 4096), (64, 8192))


def rms_bwd_inputs(gen: torch.Generator, rows: int, d: int) -> tuple:
    """bf16 x (uniform in [-1, 1]), w (in [0.5, 1.5]) and g (normal)."""
    x = (torch.rand(rows, d, generator=gen, device="cuda") * 2 - 1
         ).bfloat16()
    w = (torch.rand(d, generator=gen, device="cuda") + 0.5).bfloat16()
    g = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    return x, w, g


def rms_bwd_check(x, w, g) -> dict:
    """``rmsnorm_bwd`` against ``rmsnorm_bwd_ref``: dx and dw within
    ``local_err``'s limits, two calls bit for bit, one row-kernel and one
    partials-sum launch a call; dx alone and dw alone, g read through the
    strides of a wider buffer and g expanded from one row (stride 0), each
    within the same limits, the strided g with no copy."""
    before = counters.snapshot("rmsnorm_bwd", "rmsnorm_bwd_dw")
    dx, dw = rn.rmsnorm_bwd(x, w, g)
    dx2, dw2 = rn.rmsnorm_bwd(x, w, g)
    launched = [k - before[n] for n, k in counters.snapshot(*before).items()]
    rx, rw = rn.rmsnorm_bwd_ref(x, w, g)
    only_dx = rn.rmsnorm_bwd(x, w, g, need_dw=False)
    only_dw = rn.rmsnorm_bwd(x, w, g, need_dx=False)
    wide = torch.zeros(x.shape[0], 2 * x.shape[1], dtype=g.dtype,
                       device=g.device)
    wide[:, :x.shape[1]] = g
    copies = counters.snapshot()["rmsnorm_bwd_g_copies"]
    strided = rn.rmsnorm_bwd(x, w, wide[:, :x.shape[1]])
    strided_copies = counters.snapshot()["rmsnorm_bwd_g_copies"] - copies
    expanded = g[:1].expand_as(g)
    ex, ew = rn.rmsnorm_bwd(x, w, expanded)
    rex, rew = rn.rmsnorm_bwd_ref(x, w, expanded)
    torch.cuda.synchronize()
    rec = {"dx": local_err(dx, rx), "dw": local_err(dw, rw),
           "bits_equal": bits_equal(dx, dx2) and bits_equal(dw, dw2),
           "launches": launched,
           "dx_alone": local_err(only_dx[0], rx),
           "dw_alone": local_err(only_dw[1], rw),
           "alone_none": only_dx[1] is None and only_dw[0] is None,
           "strided": {"dx": local_err(strided[0], rx),
                       "dw": local_err(strided[1], rw),
                       "bits_equal": bits_equal(strided[0], dx) and
                       bits_equal(strided[1], dw),
                       "copies": strided_copies},
           "expanded": {"dx": local_err(ex, rex), "dw": local_err(ew, rew)}}
    rec["max_abs_err"] = max(rec["dx"]["max_abs_err"],
                             rec["dw"]["max_abs_err"])
    errs = [rec["dx"], rec["dw"], rec["dx_alone"], rec["dw_alone"],
            rec["strided"]["dx"], rec["strided"]["dw"],
            rec["expanded"]["dx"], rec["expanded"]["dw"]]
    rec["ok"] = all(within_local(e) for e in errs) and rec["bits_equal"] \
        and launched == [2, 2] and rec["alone_none"] and \
        strided_copies == 0
    return rec


def rms_bwd_bound(x: torch.Tensor) -> dict:
    """x and g read and dx written once, w read and dw written once; 11
    float32 operations an element against the card's float32 rate."""
    return bound(3 * x.numel() * x.element_size() + 2 * x.shape[-1] * 2,
                 11 * x.numel(), F32_FLOPS)


def rms_bwd_timings(x, w, g) -> dict:
    """``timings`` of the backward: the wrapper (both launches); the plain
    chain, autograd through ``rmsnorm_ref`` with its recompute (the port's
    backward before its kernel); ``F.rms_norm``'s backward alone after
    one forward, that forward and its leaves made on the stream its
    graph is captured on."""
    d = x.shape[-1]

    def kernel():
        return rn.rmsnorm_bwd(x, w, g)

    def plain():
        xx, ww = (t.detach().requires_grad_() for t in (x, w))
        with torch.enable_grad():
            return torch.autograd.grad(rn.rmsnorm_ref(xx, ww), (xx, ww), g)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.enable_grad():
        xx, ww = (t.detach().requires_grad_() for t in (x, w))
        y = F.rms_norm(xx, (d,), ww, 1e-5)
    torch.cuda.current_stream().wait_stream(side)

    def library():
        return torch.autograd.grad(y, (xx, ww), g, retain_graph=True)

    return {"ms": cuda_ms(kernel, 200), "host_ms": host_ms(kernel, 200),
            "graph_ms": graph_ms(kernel, 200),
            "plain_ms": cuda_ms(plain, 20),
            "plain_graph_ms": graph_ms(plain, 20),
            "library_ms": cuda_ms(library, 200),
            "library_graph_ms": graph_ms(library, 200, side),
            "library_of": "F.rms_norm's backward (torch.autograd.grad "
                          "after one forward)"}


def check_rmsnorm_bwd(gen: torch.Generator) -> tuple:
    """``rms_bwd_check`` at every RMS_BWD_SHAPES shape (fails unless
    ok); times of the wrapper (both launches), of the plain chain (autograd
    through ``rmsnorm_ref``, the recompute included: the port's backward
    before its kernel) and of ``F.rms_norm``'s backward after one forward,
    eagerly and from a CUDA graph, with the bound; the partials sum alone
    at each shape's [P, d] against its plain version."""
    shapes, sums = [], []
    for rows, d in RMS_BWD_SHAPES:
        x, w, g = rms_bwd_inputs(gen, rows, d)
        rec = rms_bwd_check(x, w, g)
        if not rec["ok"]:
            raise AssertionError(f"rmsnorm_bwd rows={rows} d={d}: {rec}")
        rec.update(rows=rows, d=d, plan=rn.bwd_plan(rows, x.device),
                   **rms_bwd_timings(x, w, g), **rms_bwd_bound(x))
        rec["bound_share"] = rec["bound_ms"] / rec["graph_ms"]
        shapes.append(rec)
        print(f"rmsnorm_bwd rows={rows} d={d}: {json.dumps(rec)}",
              flush=True)
        parts = torch.randn(rec["plan"][0], d, generator=gen, device="cuda")
        got = rn.rmsnorm_dw_sum(parts, torch.bfloat16)
        want = parts.sum(0).bfloat16()
        err = local_err(got, want)
        if not within_local(err) or \
                not bits_equal(got, rn.rmsnorm_dw_sum(parts, torch.bfloat16)):
            raise AssertionError(f"rmsnorm_dw_sum {tuple(parts.shape)}: "
                                 f"{err}")
        sums.append({"parts": rec["plan"][0], "d": d, **err,
                     **timings(lambda: rn.rmsnorm_dw_sum(parts,
                                                         torch.bfloat16),
                               lambda: parts.sum(0).bfloat16(), None,
                               200, 200),
                     **bound(parts.numel() * 4 + d * 2, parts.numel(),
                             F32_FLOPS)})
        del x, w, g, parts
    torch.cuda.empty_cache()
    return {"shapes": shapes, "main": shapes[0]}, \
        {"shapes": sums, "main": sums[0]}


def _empty_kernel_body(x_ptr):
    pass


def launch_floor() -> dict:
    """An empty Triton kernel of one program and an empty CUDA kernel of
    one warp launched through ctypes as the RMSNorm forward is: their
    time from a CUDA graph and eagerly, and their host enqueue, the least
    any launch costs by either route."""
    import triton
    kernel = triton.jit(_empty_kernel_body)
    x = torch.empty(1, device="cuda")
    launch = lambda: kernel[(1,)](x)  # noqa: E731
    empty = rn._fn("rmsnorm_empty")

    def launch_cuda():
        err = empty(torch._C._cuda_getCurrentRawStream(0))
        if err:
            raise RuntimeError(f"empty kernel launch failed: cudaError {err}")

    return {"empty_triton_graph_ms": graph_ms(launch, 200),
            "empty_triton_ms": cuda_ms(launch, 200),
            "empty_triton_host_ms": host_ms(launch, 200),
            "empty_cuda_graph_ms": graph_ms(launch_cuda, 200),
            "empty_cuda_ms": cuda_ms(launch_cuda, 200),
            "empty_cuda_host_ms": host_ms(launch_cuda, 200)}


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over ``peak`` (the bf16 tensor-core peak unless named),
    whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
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
# shape; "entry" is entry()'s forward; "mesh_rows" and "mesh_tp2" are
# mesh_train's local shapes (dp=2 or fsdp=2: half the rows; tp=2: half
# the heads); "ring_diag" and "ring_past" are the ring's blocks
# (long-context training calls the backward pair on each: causal on the
# diagonal, not causal on past blocks); "pipeline_mb" is a pipeline
# stage's microbatch (B 4 in 4 microbatches of 1).
FLASH_SHAPES = (("llama_1b", 4, 2048, 2048, 16, 8, 128, True),
                ("llama3_8b_heads", 1, 1024, 1024, 32, 8, 128, True),
                ("ragged", 2, 1000, 1000, 16, 8, 128, True),
                ("offset", 1, 512, 1536, 16, 8, 128, True),
                ("d64_group1", 2, 1024, 1024, 12, 12, 64, True),
                # 960: the forward's 128-row tile does not divide it, the
                # backward's 64-row q steps do.
                ("tile64", 1, 960, 960, 16, 8, 128, True),
                ("d64_group8", 1, 512, 512, 16, 2, 64, True),
                ("entry", 1, 512, 512, 16, 8, 128, True),
                ("mesh_rows", 2, 2048, 2048, 16, 8, 128, True),
                ("mesh_tp2", 4, 2048, 2048, 8, 4, 128, True),
                ("ring_diag", 2, 1024, 1024, 16, 8, 128, True),
                ("ring_past", 2, 1024, 1024, 16, 8, 128, False),
                ("pipeline_mb", 1, 2048, 2048, 16, 8, 128, True),
                # Serving prefills at Mistral-7B's heads: the smallest
                # buckets (below the forward's 128-row q tile), the
                # largest, and a chunk past a cached prefix (Sq < Skv).
                ("serve_b32", 1, 32, 32, 32, 8, 128, True),
                ("serve_b64", 1, 64, 64, 32, 8, 128, True),
                ("serve_b4096", 1, 4096, 4096, 32, 8, 128, True),
                ("serve_offset", 1, 512, 1536, 32, 8, 128, True))


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

    counters.clear()
    got = fwd_bwd(lambda a, b, c: ring_attention(a, b, c, ring, impl="rdma"))
    torch.cuda.synchronize()
    whole = {"launches": counters.snapshot(*TRAIN_KERNELS)}
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
            "flash_bwd_dq": blocks, "flash_fwd": 0, "rmsnorm": 0,
            "rmsnorm_bwd": 0, "rmsnorm_bwd_dw": 0}
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
                "flash_bwd_dq": L * blocks, "rmsnorm": 2 * 2 * L + 1,
                "rmsnorm_bwd": 2 * L + 1, "rmsnorm_bwd_dw": 2 * L + 1}
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
    counters.clear()
    for _ in range(RING_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        run["loss"].append(float(m["loss"]))
        run["grad_norm"].append(float(m["grad_norm"]))
        run["step_ms"].append((time.perf_counter() - t0) * 1e3)
    launches = counters.snapshot(*TRAIN_KERNELS)
    run.update(counters.snapshot("rmsnorm_bwd_g_copies"))
    if profile:
        run["profile"] = profile_step(step, state, batch)
        check_profiled(run, per_step, "train ring")
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


# The kernels a serving forward launches, and a training step's, by their
# names in ``ops/launches.py`` (``counters`` here).
SERVE_KERNELS = ("rmsnorm", "decode_attention", "decode_attention_quant",
                 "paged_decode_attention", "flash_fwd")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "rmsnorm",
                 "rmsnorm_bwd", "rmsnorm_bwd_dw", "ring_attention_fwd")


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


def count_fresh_prefills(engine) -> dict:
    """Wrap ``engine._prefill_logits`` to count the prefills (chunks
    counted) that start at cache position 0, the ones a graphed engine
    replays (``["n"]``); delete the instance's ``_prefill_logits``
    afterwards."""
    fresh = {"n": 0}
    real = engine._prefill_logits

    def prefill_logits(padded, slot, real_len, start_pos=0):
        fresh["n"] += start_pos == 0
        return real(padded, slot, real_len, start_pos)

    engine._prefill_logits = prefill_logits
    return fresh


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
    fresh = count_fresh_prefills(engine)

    def client(i):
        try:
            results[i] = post(url, {"prompt_tokens": prompts[i],
                                    "max_tokens": MAX_TOKENS,
                                    "temperature": 0.0})
        except Exception as e:              # reported below, then raised
            errors.append(f"request {i}: {e!r}")

    try:
        torch.cuda.reset_peak_memory_stats()
        counters.clear()
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
        launches = counters.snapshot(*SERVE_KERNELS)
        stats = fe.stats()
    finally:
        srv.shutdown()
        srv.server_close()
        fe.close()
        del engine._decode_call         # the wrappers (reference cycles)
        del engine._prefill_logits
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
    check_flash_prefills(engine, launches, stats)
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
            "fresh_prefills": fresh["n"],
            "engine_after_batch": batch_stats,
            "tokens": [results[i][2]["tokens"] for i in sorted(results)],
            "ids": [results[i][2]["id"] for i in sorted(results)],
            "repeat_tokens": tokens[0], "repeat_id": again[0][2]["id"],
            "repeat_equals_batch": tokens[0] == first}


def check_rmsnorm_launches(engine, launches: dict, stats: dict) -> None:
    """2 L + 1 RMSNorms a forward: every prefill (each chunk counted),
    decode step and verify step; at least one decode step."""
    forwards = stats["prefills"] + stats["decode_steps"] + \
        stats["verify_steps"]
    if stats["decode_steps"] == 0 or \
            launches["rmsnorm"] != (2 * engine.cfg.n_layers + 1) * forwards:
        raise AssertionError(f"rmsnorm launches {launches} (stats {stats})")


def check_flash_prefills(engine, launches: dict, stats: dict) -> None:
    """Every prefill (each chunk counted) over a bf16 cache was routed to
    the flash forward kernel and none over the int8 cache
    (``prefill_kernel``, counted by the forwards where they take the
    route), and the kernel's own counter saw L launches for each of them.
    Verify steps (rows at different offsets) launch none."""
    want = stats["prefills"] if engine.kv_quant == "none" else 0
    if stats["prefill_kernel"] != want or \
            launches["flash_fwd"] != engine.cfg.n_layers * want:
        raise AssertionError(f"flash prefill launches {launches} (stats "
                             f"{stats})")


def expect_decode_kernel(run: dict, kernel: str, n_layers: int,
                         graphed: bool) -> None:
    """Every decode step launched ``kernel`` once per layer and no other
    decode-attention kernel ran (a graph replay counts the launches it
    replays); where ``graphed`` (a bf16 paged engine in one process, with
    the dense FFN and unquantised weights) every decode step was a CUDA
    graph replay, elsewhere none was."""
    steps = run["engine"]["decode_steps"]
    want = {k: 0 for k in ("decode_attention", "decode_attention_quant",
                           "paged_decode_attention")}
    want[kernel] = n_layers * steps
    got = {k: run["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"decode launches {got} != expected {want} "
                             f"(stats {run['engine']})")
    replays = run["engine"]["decode_graph_steps"]
    if replays != (steps if graphed else 0):
        raise AssertionError(f"{replays} decode graph replays of {steps} "
                             f"decode steps (graphed {graphed})")


def expect_prefill_graphs(run: dict, graphed: bool) -> None:
    """Where ``graphed`` every prefill from cache position 0
    (``fresh_prefills``, chunks counted) was a CUDA graph replay, and
    elsewhere none was; a prefill past a cached prefix, or a later chunk,
    is never one."""
    replays = run["engine"]["prefill_graph_steps"]
    want = run["fresh_prefills"] if graphed else 0
    if replays != want:
        raise AssertionError(f"{replays} prefill graph replays, {want} "
                             f"expected (graphed {graphed}; stats "
                             f"{run['engine']})")


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
    expect_decode_kernel(run, "decode_attention", cfg.n_layers, False)
    expect_prefill_graphs(run, False)
    ref = check_against_recompute(cfg, params, prompts[0],
                                  run["tokens"][0][:8])
    del engine
    torch.cuda.empty_cache()
    return {"model": "llama3_8b", "params": cfg.num_params(),
            "setup_s": setup_s, **run, "recompute_check": ref}


def shared_prefix_prompts(vocab: int, seed: int, other=None):
    """Four prompts that share one SHARED-token prefix, then prompts of the
    ``other`` lengths (default OTHER_LENS) that share nothing."""
    other = OTHER_LENS if other is None else other
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, SHARED).tolist()
    return ([prefix + rng.integers(0, vocab, n).tolist()
             for n in SHARED_SUFFIXES]
            + [rng.integers(0, vocab, n).tolist() for n in other])


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
    expect_decode_kernel(run, kernel, cfg.n_layers,
                         paged and kv_quant == "none")
    expect_prefill_graphs(run, paged and kv_quant == "none")
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


class RouteRecorder:
    """The experts a Mixtral engine chose for every row it served.

    Wraps the engine's model calls (``_prefill_forward``,
    ``_decode_forward``, and ``_admit`` for the request being prefilled)
    to note which request and position each row of the call is, and
    ``mixtral.route`` to keep each layer's top-k expert ids on the device
    (no sync while serving).  ``close`` counts the rows each expert ran
    (``rows_per_expert``, idle slots' rows included, as the grouped FFN
    runs them); ``experts(rid, seq)`` then gives, per layer,
    the [len(seq), K] ids the serving chose for the positions of ``seq``
    (the request's own rows, or the rows of another request whose cached
    blocks it reused, matched by token prefix), -1 where no row was
    served.  ``close`` restores everything."""

    def __init__(self, engine):
        self.engine, self.calls, self.ctx = engine, [], None
        self._req = None
        self._real = {n: getattr(engine, n) for n in
                      ("_admit", "_prefill_forward", "_decode_forward")}
        self._route = mixtral.route
        engine._admit = self._admit
        engine._prefill_forward = self._prefill_forward
        engine._decode_forward = self._decode_forward
        mixtral.route = self.route

    def _admit(self, req, slot):
        self._req = req
        return self._real["_admit"](req, slot)

    def _prefill_forward(self, tokens, slot, start, real_len, logits_index):
        s0 = int(start[0])
        req = self._req
        self.ctx = {"rows": [(req.request_id, req.prompt_tokens, s0 + j)
                             for j in range(real_len)], "layers": []}
        self.calls.append(self.ctx)
        return self._real["_prefill_forward"](tokens, slot, start, real_len,
                                              logits_index)

    def _decode_forward(self, tokens, lens, mask, token_mask=None):
        e = self.engine
        self.ctx = {"rows": [
            None if r is None else
            (r.request_id, list(r.prompt_tokens) + e.generated[i],
             int(e.lens[i])) for i, r in enumerate(e.active)],
            "layers": []}
        self.calls.append(self.ctx)
        return self._real["_decode_forward"](tokens, lens, mask, token_mask)

    def route(self, cfg, xt, router):
        out = self._route(cfg, xt, router)
        if self.ctx is not None:
            self.ctx["layers"].append(out[3])
        return out

    def close(self):
        for n in self._real:
            delattr(self.engine, n)
        mixtral.route = self._route
        self.by_req, self.by_prefix = {}, {}
        rows = torch.zeros(self.engine.cfg.n_experts, dtype=torch.long)
        for call in self.calls:
            ids = [t.cpu() for t in call["layers"]]
            for t in ids:
                rows += torch.bincount(t.flatten(), minlength=len(rows))
            for row, info in enumerate(call["rows"]):
                if info is None:
                    continue
                rid, seq, pos = info
                chosen = [t[row].tolist() for t in ids]
                self.by_req[(rid, pos)] = chosen
                self.by_prefix.setdefault(tuple(seq[:pos + 1]), chosen)
        self.calls = []
        self.rows_per_expert = rows.tolist()

    def experts(self, rid, seq, n_layers: int, K: int):
        out = torch.full((n_layers, len(seq), K), -1, dtype=torch.long)
        for pos in range(len(seq)):
            chosen = self.by_req.get((rid, pos)) or \
                self.by_prefix.get(tuple(seq[:pos + 1]))
            if chosen is not None:
                out[:, pos] = torch.tensor(chosen)
        return out


def check_against_recompute(cfg, params, prompt, served,
                            margin_frac: float = RECOMPUTE_MARGIN["bf16"],
                            other=None, forward=forward_with_cache,
                            experts=None) -> dict:
    """Greedy tokens served through the cache (prefill + decode kernel)
    vs one no-cache bf16 forward of prompt + served tokens (multi-token
    plain attention, ``_cached_attention``, not the served prefill's flash
    kernel): each served token must be the reference's argmax, or
    within ``margin_frac`` of the largest |logit| below its max logit.
    With ``other`` (tokens served for the same prompt another time), the
    first position where the two differ and the reference's logits of
    both tokens there (the prefixes before it are the same, so one forward
    gives both).  ``forward``: the model function served (int8 weights
    compute another function than bf16 ones).  ``experts`` (Mixtral: [L,
    T, K] expert ids the serving chose, -1 where none, from
    ``RouteRecorder``): the recompute routes each row to those experts,
    weighted by its own router probabilities.  Without it the recompute
    would be another function: a token whose top-k experts nearly tie
    goes to other experts in calls whose products round differently,
    which moves its output by an expert's share (my chip runs 1-3, PR 11:
    served tokens up to 4.4 below the recompute's best where the margin
    is 0.23).  How often the recompute's own routing agrees with the
    served one is reported (``routing_agreement``)."""
    seq = torch.tensor([prompt + served], device="cuda")
    T = seq.shape[1]
    cache = init_kv_cache(cfg, 1, T, "cuda")
    real_route, route_agree = mixtral.route, []

    def route(cfg_, xt, router):
        logits, probs, topw, topi = real_route(cfg_, xt, router)
        forced = experts[len(route_agree)].to(topi.device)
        own = forced[:, 0] < 0
        route_agree.append((forced.sort(-1).values == topi.sort(-1).values)
                           .all(-1)[~own])
        topi = torch.where(own[:, None], topi, forced)
        topw = probs.gather(-1, topi)
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
        return logits, probs, topw, topi

    if experts is not None:
        if (experts[:, :T - 1] < 0).any():
            raise AssertionError("the serving's experts were not recorded "
                                 "for every row of the sequence")
        mixtral.route = route
    try:
        with torch.no_grad():
            logits, _ = forward(cfg, params, seq, cache,
                                torch.zeros(1, dtype=torch.long,
                                            device="cuda"),
                                attention=_cached_attention)
    finally:
        mixtral.route = real_route
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
    if route_agree:
        out["routing_agreement"] = torch.cat(route_agree).float().mean().item()
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
    chunks launch the flash forward, 32 a chunk over a bf16 cache, and
    verify steps run the plain multi-query attention and launch
    neither), at least one verify step with speculation, every served token
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
    moe_cfg = isinstance(cfg, mixtral.MixtralConfig)
    recorder = RouteRecorder(engine) if moe_cfg else None
    try:
        run = drive(engine, prompts, repeat=repeat,
                    same_as_batch=same_as_batch)
    finally:
        if recorder is not None:
            recorder.close()
    graphed = paged and not kv8 and not moe_cfg and \
        options.get("weight_quant", "none") == "none"
    expect_decode_kernel(run, kernel, cfg.n_layers, graphed)
    expect_prefill_graphs(run, graphed)
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
    if moe_cfg:
        out["moe"] = moe_counts(cfg, run["engine"], recorder)
    family = base_forward_for(cfg) or forward_with_cache
    forward, served_params = family, params
    if options.get("weight_quant") == "int8":
        forward = make_weight_dequant_forward(family)
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
    def experts(rid, prompt, served):
        if recorder is None:
            return None
        return recorder.experts(rid, prompt + served, cfg.n_layers,
                                cfg.top_k)

    checks = [check_against_recompute(cfg, served_params, p, t, margin,
                                      forward=forward,
                                      experts=experts(rid, p, t))
              for p, t, rid in zip(prompts, run["tokens"], run["ids"])]
    rt = run["repeat_tokens"]
    checks.append(check_against_recompute(
        cfg, served_params, prompts[repeat], rt, margin,
        other=run["tokens"][repeat], forward=forward,
        experts=experts(run["repeat_id"], prompts[repeat], rt)))
    out["recompute_check"] = {
        "tokens": sum(c["tokens"] for c in checks),
        "argmax_agree": sum(c["argmax_agree"] for c in checks),
        **({"routing_agreement": min(c["routing_agreement"]
                                     for c in checks)} if moe_cfg else {}),
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
            "prefix_hit_tokens_batch", "prefix_hit_tokens_repeat", "moe")
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
        counters.clear()
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
        launches = counters.snapshot(*SERVE_KERNELS)
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
    check_flash_prefills(engine, launches, stats)
    expect_decode_kernel({"engine": stats, "launches": launches},
                         "decode_attention", cfg.n_layers, False)
    expect_prefill_graphs({"engine": stats}, False)
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


def post_json(url: str, path: str, body: dict, timeout: float = 600.0):
    """(status, headers, JSON body, response bytes) of one POST."""
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read()
        return resp.status, dict(resp.headers), json.loads(raw), len(raw)


def post_batch(url: str, prompts, max_tokens: int) -> list:
    """Every prompt POSTed at once (greedy); the bodies in prompt order."""
    results, errors = {}, []

    def client(i):
        try:
            results[i] = post(url, {"prompt_tokens": prompts[i],
                                    "max_tokens": max_tokens,
                                    "temperature": 0.0})
        except Exception as e:              # reported below, then raised
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads) or \
            any(results[i][0] != 200 or len(results[i][2]["tokens"])
                != max_tokens for i in results):
        raise AssertionError(f"batch failed: {errors} {results}")
    return [results[i][2] for i in range(len(prompts))]


def timed_method(obj, name: str, log: list, sync: bool = False):
    """Replace ``obj.name`` by a wrapper that appends (result, ms) to
    ``log``, the device synchronised after the call when ``sync`` (a write
    on the stream is timed to its end).  Delete ``obj.name`` after."""
    real = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        log.append((out, (time.perf_counter() - t0) * 1e3))
        return out

    setattr(obj, name, wrapper)


def prefilled(stats: dict) -> int:
    """Prompt tokens the paged engine ran through prefill past its cache
    (full blocks; partial tails are not counted by either side)."""
    return stats["prefix_query_tokens"] - stats["prefix_hit_tokens"]


def serve_tiers(cfg, params, smi: str, seed: int = 5) -> dict:
    """llama3_8b at full width and depth through PagedServeEngine with a
    host KV tier, behind the HTTP frontend: a first wave of 8 prompts (4
    share a 512-token prefix), the same wave again while its blocks are
    on the device (the warm wave), the demotions still queued drained, an
    evicting wave of unrelated prompts that cannibalises every block of
    the first wave, then the first wave once more.  That repeat must
    promote from the host tier (tier_fetch_blocks > 0) and prefill fewer
    tokens than the first wave; its tokens must equal the warm wave's bit
    for bit (the promoted rows are the device rows' bf16 values, and both
    waves prefill the same tails); the first wave's and the repeat's
    tokens must pass the no-cache recompute.  The first wave prefilled
    whole prompts, so its tokens may leave the repeat's where bf16
    products of other shapes round differently (recorded, not held)."""
    engine = PagedServeEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                              block_size=BLOCK_SIZE, num_blocks=TIER_BLOCKS,
                              host_blocks=TIER_HOST, device="cuda")
    pumps, promotions = [], []
    fresh = count_fresh_prefills(engine)
    timed_method(engine, "_pump_demotions", pumps)
    timed_method(engine, "_promote_from_tiers", promotions, sync=True)
    fe = ServeFrontend(engine)
    srv, url = fe.serve_background("127.0.0.1", 0)
    prompts = shared_prefix_prompts(cfg.vocab_size, seed, TIER_OTHER_LENS)
    rng = np.random.default_rng(seed + 1)
    evict = [rng.integers(0, cfg.vocab_size, n).tolist() for n in EVICT_LENS]

    def stats():
        return fe.call_engine(lambda e: dict(e.stats))

    def resident():
        return fe.call_engine(lambda e: [e.resident_prefix_blocks(p)
                                         for p in prompts])

    waves = {}
    try:
        counters.clear()
        s0 = stats()
        for name, batch, n in (("first", prompts, MAX_TOKENS),
                               ("warm", prompts, MAX_TOKENS)):
            before, n_pumps = stats(), len(pumps)
            t0 = time.perf_counter()
            tokens = [b["tokens"] for b in post_batch(url, batch, n)]
            after = stats()
            waves[name] = {
                "wall_s": time.perf_counter() - t0, "tokens": tokens,
                "prefilled": prefilled(after) - prefilled(before),
                "demoted_by_steps": sum(o for o, _ in pumps[n_pumps:]),
                "resident_blocks": resident()}
        pending = stats()["pending_demotions"]
        n_pumps = len(pumps)
        drained = fe.call_engine(lambda e: e._pump_demotions(limit=1 << 20))
        drain_ms = pumps[n_pumps][1]
        post_batch(url, evict, 1)
        waves["evict"] = {"resident_blocks": resident(),
                          "host_blocks_used": stats()["host_blocks_used"]}
        before = stats()
        n_prom = len(promotions)
        t0 = time.perf_counter()
        tokens = [b["tokens"] for b in post_batch(url, prompts, MAX_TOKENS)]
        after = stats()
        waves["repeat"] = {
            "wall_s": time.perf_counter() - t0, "tokens": tokens,
            "prefilled": prefilled(after) - prefilled(before),
            "tier_fetch_blocks": after["tier_fetch_blocks"]
            - before["tier_fetch_blocks"],
            "promotions": [(n, ms) for n, ms in promotions[n_prom:] if n]}
        launches = counters.snapshot(*SERVE_KERNELS)
        final = fe.stats()
    finally:
        srv.shutdown()
        srv.server_close()
        fe.close()
        del engine._pump_demotions, engine._promote_from_tiers
        del engine._prefill_logits
    if any(waves["evict"]["resident_blocks"]):
        raise AssertionError(f"the evicting wave left first-wave blocks on "
                             f"the device: {waves['evict']}")
    rep, first, warm = waves["repeat"], waves["first"], waves["warm"]
    if rep["tier_fetch_blocks"] <= 0 or \
            rep["prefilled"] >= first["prefilled"]:
        raise AssertionError(f"no promotion from the host tier: {rep} "
                             f"(first wave prefilled {first['prefilled']})")
    if rep["tokens"] != warm["tokens"]:
        raise AssertionError(f"promoted repeat {rep['tokens']} != warm "
                             f"wave {warm['tokens']}")
    check_rmsnorm_launches(engine, launches, final)
    check_flash_prefills(engine, launches, final)
    expect_decode_kernel({"engine": final, "launches": launches},
                         "paged_decode_attention", cfg.n_layers, True)
    expect_prefill_graphs({"engine": final, "fresh_prefills": fresh["n"]},
                          True)
    checks = [check_against_recompute(cfg, params, p, t, other=r)
              for p, t, r in zip(prompts, first["tokens"], rep["tokens"])]
    checks += [check_against_recompute(cfg, params, p, t)
               for p, t in zip(prompts, rep["tokens"])]
    step_pumps = [(o, ms) for o, ms in pumps if o and o <= 4]
    prom_blocks = sum(n for n, _ in rep["promotions"])
    out = {
        "phase": "serve_tiers", "num_blocks": TIER_BLOCKS,
        "host_blocks": TIER_HOST, "prompt_lens": [len(p) for p in prompts],
        "evict_lens": list(EVICT_LENS), "launches": launches,
        "engine": final, "waves": {k: {kk: vv for kk, vv in v.items()
                                       if kk != "tokens"}
                                   for k, v in waves.items()},
        "pending_before_drain": pending, "drained": drained,
        "drain_ms": drain_ms,
        "demotions_per_step": [o for o, _ in pumps],
        "d2h_ms_per_block": {
            "steps": (sum(ms for _, ms in step_pumps)
                      / max(1, sum(o for o, _ in step_pumps))),
            "drain": drain_ms / max(1, drained)},
        "promotions_per_admission": [n for n, _ in rep["promotions"]],
        "h2d_ms_per_block": (sum(ms for _, ms in rep["promotions"])
                             / max(1, prom_blocks)),
        "first_equals_repeat": sum(a == b for a, b in
                                   zip(first["tokens"], rep["tokens"])),
        "warm_equals_first": sum(a == b for a, b in
                                 zip(first["tokens"], warm["tokens"])),
        "recompute_check": {
            "tokens": sum(c["tokens"] for c in checks),
            "argmax_agree": sum(c["argmax_agree"] for c in checks),
            "max_gap": max(c["max_gap"] for c in checks),
            "divergence": [c["divergence"] for c in checks[:len(prompts)]]},
        "decode_step_ms": 1e3 * final["decode_s"] / final["decode_steps"]}
    print(f"serve_tiers [{smi}]: " + json.dumps(
        {k: out[k] for k in ("waves", "pending_before_drain", "drained",
                             "drain_ms", "demotions_per_step",
                             "d2h_ms_per_block", "promotions_per_admission",
                             "h2d_ms_per_block", "first_equals_repeat",
                             "warm_equals_first", "decode_step_ms")}),
        flush=True)
    del engine
    torch.cuda.empty_cache()
    return out


def handoff(src_url: str, dst_url: str, prompt, dst_stats) -> dict:
    """The gateway's two hops from ``src`` to ``dst``
    (kuberay_tpu/serve/gateway.py's two-hop forward): the prompt on src for
    one token, ``resident`` on dst, ``export`` on src past the resident
    blocks, ``import`` on dst, then the prompt and its first token on dst
    (``body``).  ``dst_stats()`` reads dst's engine stats."""
    t0 = time.perf_counter()
    _, _, hop1, _ = post_json(src_url, "/v1/completions", {
        "prompt_tokens": prompt, "max_tokens": 1})
    hop1_s = time.perf_counter() - t0
    _, _, res, _ = post_json(dst_url, "/v1/kv/resident",
                             {"prompt_tokens": prompt})
    t1 = time.perf_counter()
    _, _, exp, nbytes = post_json(src_url, "/v1/kv/export", {
        "prompt_tokens": prompt, "skip_blocks": res["resident_blocks"],
        "max_blocks": 0})
    t2 = time.perf_counter()
    _, _, imp, _ = post_json(dst_url, "/v1/kv/import", {
        "prompt_tokens": prompt, "blocks": exp["blocks"]})
    t3 = time.perf_counter()
    hits0 = dst_stats()["prefix_hit_tokens"]
    body = {"prompt_tokens": prompt + hop1["tokens"],
            "max_tokens": MAX_TOKENS - 1}
    _, headers, dec, _ = post_json(dst_url, "/v1/completions", body)
    handoff_s = time.perf_counter() - t0
    sent = len(exp["blocks"])
    return {"prompt_len": len(prompt), "blocks": len(prompt) // BLOCK_SIZE,
            "resident": res["resident_blocks"], "sent": sent,
            "import": imp, "export_bytes": nbytes,
            "export_http_ms_per_block": (t2 - t1) * 1e3 / max(1, sent),
            "import_http_ms_per_block": (t3 - t2) * 1e3 / max(1, sent),
            "decode_hits": dst_stats()["prefix_hit_tokens"] - hits0,
            "handoff_s": handoff_s, "prefill_hop_s": hop1_s,
            "hop1_ttft_ms": hop1["ttft_ms"], "body": body,
            "tokens": hop1["tokens"] + dec["tokens"],
            "load_headers": {k: v for k, v in headers.items()
                             if k.startswith("X-TPU-")}}


def serve_disagg(cfg, params, smi: str, seed: int = 6) -> dict:
    """The disaggregated prefill -> decode handoff at llama3_8b: two
    PagedServeEngines sharing one params tree, each behind its own
    ServeFrontend, driven with the gateway's calls over HTTP in its order
    (kuberay_tpu/serve/gateway.py's two-hop forward): the prompt on the
    prefill replica for one token, ``resident`` on the decode replica,
    ``export`` on the prefill replica past the resident blocks,
    ``import`` on the decode replica, then the prompt and its first token
    on the decode replica.  Checks, per prompt: the decode replica's
    prefix hits cover the resident and imported blocks; its tokens equal
    the prefill replica's own for the same body; the whole answer passes
    the no-cache recompute; a second handoff sends nothing and skips every
    block.  The second prompt shares the first's 512-token prefix, so its
    probe finds those blocks resident and the export sends the rest."""
    kw = dict(max_slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK_SIZE,
              host_blocks=DISAGG_HOST, device="cuda")
    engines = {"prefill": PagedServeEngine(cfg, params, **kw),
               "decode": PagedServeEngine(cfg, params, **kw)}
    xfer = {"export": [], "import": []}
    fresh = [count_fresh_prefills(e) for e in engines.values()]
    timed_method(engines["prefill"], "export_kv_blocks", xfer["export"])
    timed_method(engines["decode"], "import_kv_blocks", xfer["import"],
                 sync=True)
    fes = {k: ServeFrontend(e) for k, e in engines.items()}
    served = {k: fe.serve_background("127.0.0.1", 0) for k, fe in fes.items()}
    pf, de = served["prefill"][1], served["decode"][1]
    rng = np.random.default_rng(seed + 1)
    shared = shared_prefix_prompts(cfg.vocab_size, seed)
    prompts = [shared[0], shared[3],
               rng.integers(0, cfg.vocab_size, DISAGG_LONG).tolist()]
    rows = []
    try:
        counters.clear()
        for prompt in prompts:
            row = handoff(pf, de, prompt, lambda: fes["decode"].call_engine(
                lambda e: dict(e.stats)))
            _, _, own, _ = post_json(pf, "/v1/completions", row.pop("body"))
            _, _, res2, _ = post_json(de, "/v1/kv/resident",
                                      {"prompt_tokens": prompt})
            _, _, exp2, _ = post_json(pf, "/v1/kv/export", {
                "prompt_tokens": prompt,
                "skip_blocks": res2["resident_blocks"]})
            row.update(equals_prefill_replica=row["tokens"][1:]
                       == own["tokens"],
                       second={"resident": res2["resident_blocks"],
                               "sent": len(exp2["blocks"])})
            rows.append(row)
        launches = counters.snapshot(*SERVE_KERNELS)
        stats = {k: fe.stats() for k, fe in fes.items()}
    finally:
        for srv, _ in served.values():
            srv.shutdown()
            srv.server_close()
        for fe in fes.values():
            fe.close()
        for e, name in ((engines["prefill"], "export_kv_blocks"),
                        (engines["decode"], "import_kv_blocks")):
            delattr(e, name)
        for e in engines.values():
            del e._prefill_logits
    for row, prompt in zip(rows, prompts):
        want = {"imported": row["blocks"] - row["resident"],
                "skipped": row["resident"]}
        if row["sent"] != row["blocks"] - row["resident"] or \
                row["import"] != want or \
                row["decode_hits"] < row["blocks"] * BLOCK_SIZE or \
                not row["equals_prefill_replica"] or \
                row["second"] != {"resident": row["blocks"], "sent": 0}:
            raise AssertionError(f"disaggregated handoff: {row}")
        if len(row["load_headers"]) != 7:
            raise AssertionError(f"load headers: {row['load_headers']}")
        row["recompute_check"] = check_against_recompute(
            cfg, params, prompt, row.pop("tokens"))
    if rows[1]["resident"] != SHARED // BLOCK_SIZE:
        raise AssertionError(f"the shared prefix was not resident: {rows}")
    both = {k: sum(st[k] for st in stats.values())
            for k in ("prefills", "prefill_kernel", "decode_steps",
                      "verify_steps", "decode_graph_steps",
                      "prefill_graph_steps")}
    check_rmsnorm_launches(engines["decode"], launches, both)
    check_flash_prefills(engines["decode"], launches, both)
    expect_decode_kernel({"engine": both, "launches": launches},
                         "paged_decode_attention", cfg.n_layers, True)
    expect_prefill_graphs({"engine": both,
                           "fresh_prefills": sum(f["n"] for f in fresh)},
                          True)
    engine_ms = {k: [(len(o) if isinstance(o, list) else o["imported"], ms)
                     for o, ms in v] for k, v in xfer.items()}
    out = {"phase": "serve_disagg", "handoffs": rows, "launches": launches,
           "engine": both, "engine_ms": engine_ms}
    print(f"serve_disagg [{smi}]: " + json.dumps(
        {"handoffs": [{k: v for k, v in r.items()
                       if k != "recompute_check"} for r in rows],
         "engine_ms_per_block": {
             k: [ms / max(1, n) for n, ms in v] for k, v in
             engine_ms.items()}}), flush=True)
    del engines, fes
    torch.cuda.empty_cache()
    return out


def mixtral_serve(smi: str, seed: int = 0) -> dict:
    """mixtral_8x7b at its published widths, MIXTRAL_SERVE_LAYERS of its
    32 layers, seeded random bf16 weights, through serve_option: the
    dense bf16 engine on the serve prompts (repeats bit for bit), the
    paged engine on shared-prefix traffic (prefix hits, every token
    against the no-cache recompute) and int8 weights on the dense engine
    once; 2 L + 1 RMSNorms a forward, L decode-kernel launches a decode
    step, L host syncs of the grouped FFN a forward."""
    cfg = dataclasses.replace(mixtral.CONFIGS["mixtral_8x7b"],
                              n_layers=MIXTRAL_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {"layers": cfg.n_layers, "params": cfg.num_params(),
           "weight_bytes": tree_bytes(params), "init_s": init_s}
    print(f"mixtral_serve: {cfg.n_layers} layers, {out['params']} params, "
          f"{out['weight_bytes']} bytes, init {init_s:.1f} s", flush=True)
    rng_prompts = [np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    shared = shared_prefix_prompts(cfg.vocab_size, 1)
    out["mixtral_dense"] = serve_option(
        "mixtral_dense", cfg, params, smi, False, rng_prompts, 0, True,
        "random, seed 0")
    out["mixtral_paged"] = serve_option(
        "mixtral_paged", cfg, params, smi, True, shared, REPEAT, False,
        "shared prefix, seed 1", shared_prefix=True)
    out["mixtral_wq_dense"] = serve_option(
        "mixtral_wq_dense", cfg, params, smi, False, rng_prompts, 0, True,
        "random, seed 0", weight_quant="int8")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mixtral_train(smi: str, seed: int = 0) -> dict:
    """mixtral.loss_fn forward and backward (no optimizer: no entry point
    trains Mixtral) at mixtral_8x7b's published widths,
    MIXTRAL_TRAIN_LAYERS layers, B 2 x S 2048, full remat, the config's
    chunked CE (8192).  Checks the loss, the aux losses and every
    gradient are finite and each step launches 2 L flash forwards (the
    layer again under remat), L dK/dV, L dQ and 4 L + 1 RMSNorms."""
    cfg = dataclasses.replace(mixtral.CONFIGS["mixtral_8x7b"],
                              n_layers=MIXTRAL_TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = mixtral.init_params(cfg, gen, "cuda")
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    raw = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (MIXTRAL_B, MIXTRAL_S + 1))
    tokens = torch.tensor(raw[:, :-1], device="cuda")
    targets = torch.tensor(raw[:, 1:], device="cuda")
    per_step = train_per_step(cfg.n_layers)
    steps = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MIXTRAL_STEPS):
        for leaf in param_leaves(params):
            leaf.grad = None
        counters.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, m = mixtral.loss_fn(cfg, params, tokens, targets)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = counters.snapshot(*TRAIN_KERNELS)
        finite = all(bool(torch.isfinite(leaf.grad).all())
                     for leaf in param_leaves(params))
        steps.append({"ms": ms, **{k: v.item() for k, v in m.items()},
                      "grads_finite": finite, "launches": launches,
                      **counters.snapshot("rmsnorm_bwd_g_copies",
                                          "moe_host_syncs")})
        if launches != per_step or not finite or \
                not all(math.isfinite(v) for k, v in steps[-1].items()
                        if isinstance(v, float)):
            raise AssertionError(f"mixtral training step: {steps[-1]} "
                                 f"(launches expected {per_step})")
    out = {"layers": cfg.n_layers, "params": cfg.num_params(),
           "batch": [MIXTRAL_B, MIXTRAL_S], "steps": steps,
           "launches": steps[-1]["launches"],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"mixtral_train [{smi}]: " + json.dumps(
        {"step_ms": [s["ms"] for s in steps],
         "total_loss": steps[-1]["total_loss"],
         "aux_load_balance": steps[-1]["aux_load_balance"],
         "aux_router_z": steps[-1]["aux_router_z"],
         "launches_per_step": per_step,
         "max_memory_allocated_gb": out["max_memory_allocated_gb"]}),
        flush=True)
    del params, loss, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def param_leaves(params) -> list:
    """The tensors of a params tree, in a fixed order."""
    return [params["embed"], params["lm_head"], params["final_norm"],
            *(params["layers"][k] for k in sorted(params["layers"]))]


def moe_counts(cfg, stats: dict, recorder) -> dict:
    """The grouped MoE FFN's host syncs since ``counters.clear()`` and the
    rows each expert ran (``RouteRecorder``); fails unless every forward
    (prefill chunk, decode and verify step) synced exactly once a layer
    (the group sizes)."""
    forwards = stats["prefills"] + stats["decode_steps"] + \
        stats["verify_steps"]
    syncs = counters.snapshot()["moe_host_syncs"]
    out = {"host_syncs": syncs, "forwards": forwards,
           "host_syncs_per_forward": syncs / max(forwards, 1),
           "rows_per_expert": recorder.rows_per_expert}
    print(f"moe: {json.dumps(out)}", flush=True)
    if syncs != cfg.n_layers * forwards:
        raise AssertionError(f"moe host syncs {out} != {cfg.n_layers} a "
                             f"forward")
    return out


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
    by_name, spans, named = {}, [], dict.fromkeys(RMS_BWD_KERNELS, 0)
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a) / 1e3
        spans.append((a, b))
        for key, kernel in RMS_BWD_KERNELS.items():
            named[key] += kernel in ev.name
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
            "kernels_by_name": named,
            "top_kernels_ms": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:25]}


# The backward's kernels by their name in a profile, by launch counter.
RMS_BWD_KERNELS = {"rmsnorm_bwd": "_rmsnorm_bwd_body",
                   "rmsnorm_bwd_dw": "_rmsnorm_dw_body"}


def check_profiled(run: dict, per_step: dict, what: str) -> None:
    """A profiled step's device kernels named after the backward's, one
    each a launch the step counts."""
    named = run["profile"]["kernels_by_name"]
    if any(named[k] != per_step[k] for k in RMS_BWD_KERNELS):
        raise AssertionError(f"{what}: profiled kernels {named}, expected "
                             f"{ {k: per_step[k] for k in RMS_BWD_KERNELS} }")


def train_per_step(L: int) -> dict:
    """Kernel launches of one llama training step through the launcher."""
    return {"flash_fwd": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L,
            "rmsnorm": 2 * 2 * L + 1,              # full remat: fwd twice
            "rmsnorm_bwd": 2 * L + 1, "rmsnorm_bwd_dw": 2 * L + 1,
            "ring_attention_fwd": 0}


def train(seed: int = 0, profile: bool = False) -> dict:
    """llama_1b at full width and depth: the launcher on the synthetic
    shard (bf16 masters), then 8 steps on one fixed batch with f32
    masters (and with ``profile``, one more under torch.profiler)."""
    cfg = llama.CONFIGS["llama_1b"]
    per_step = train_per_step(cfg.n_layers)
    argv = ["--model", "llama_1b", "--batch", str(TRAIN_BATCH), "--seq-len",
            str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--warmup", "1",
            "--log-every", "1", "--seed", str(seed)]
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    counters.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = launcher.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counters.snapshot(*TRAIN_KERNELS)
    copies = counters.snapshot()["rmsnorm_bwd_g_copies"]
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
           "rmsnorm_bwd_g_copies": copies,
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
    counters.clear()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        fixed["loss"].append(float(m["loss"]))
        fixed["grad_norm"].append(float(m["grad_norm"]))
        fixed["step_ms"].append((time.perf_counter() - t0) * 1e3)
    fixed_launches = counters.snapshot(*TRAIN_KERNELS)
    fixed["launches"] = fixed_launches
    fixed.update(counters.snapshot("rmsnorm_bwd_g_copies"))
    fixed["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if profile:
        fixed["profile"] = profile_step(step, state, batch)
        check_profiled(fixed, per_step, "train")
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


# The train-to-serve handoff (llama_1b, the launcher's flags of ``train``):
# the library's saves at steps 2 and 4, the launcher resuming at 4 to
# step HANDOFF_STEPS, the server on that checkpoint.  A save holds params,
# mu and nu in bf16, about 6.85 GB; three are kept on disk.
HANDOFF_STEPS = 6
HANDOFF_APP = "handoff"
HANDOFF_JOB = "train-to-serve"
# The server as ``python -m``, its kernel launch counts printed at exit.
SERVE_WITH_COUNTS = (
    "import atexit, json, runpy\n"
    "from kuberay_tpu_torch.ops import launches as counters\n"
    "atexit.register(lambda: print('kernel launches ' + json.dumps(\n"
    "    counters.snapshot('rmsnorm', 'decode_attention',\n"
    "        'decode_attention_quant', 'paged_decode_attention')),\n"
    "    flush=True))\n"
    "runpy.run_module('kuberay_tpu_torch.serve.server', run_name='__main__',\n"
    "                 alter_sys=True)\n")


class CoordinatorRecorder:
    """The head coordinator's API as far as the pods use it, on 127.0.0.1
    at the dashboard port (where ``TPU_COORDINATOR_ADDRESS`` leads):
    records the posted events and the serve apps' statuses in order."""

    def __init__(self):
        self.events, self.statuses = [], []
        rec = self

        class Handler(JsonHandler):
            def do_POST(self):
                if self.path != "/api/events":
                    return self._send(404, {"message": "unknown path"})
                events = self._body().get("events", [])
                rec.events.extend(events)
                return self._send(200, {"recorded": len(events)})

            def do_PUT(self):
                parts = self.path.strip("/").split("/")
                if parts[:3] != ["api", "serve", "applications"] or \
                        len(parts) != 5 or parts[4] != "status":
                    return self._send(404, {"message": "unknown path"})
                rec.statuses.append((parts[3], self._body()["status"]))
                return self._send(200, {})

        self.srv, self.url = serve_background(ThreadingHTTPServer(
            ("127.0.0.1", PORT_DASHBOARD), Handler), "coordinator-recorder")

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()


@contextlib.contextmanager
def env_vars(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def handoff_library(cfg, ckpt_dir: Path, shard: Path, commits: list,
                    seed: int) -> dict:
    """(a) Two steps, ``save_async(state, 2)`` (a host clone of the state
    kept aside), two more steps while it writes, ``save_async(state, 4)``,
    ``close()``; then ``restore(dir, 2)`` into another seed's fresh state
    must equal the clone bit for bit, the integer leaves included."""
    tc = ts.TrainConfig(learning_rate=3e-4, warmup_steps=1,
                        decay_steps=HANDOFF_STEPS)
    opt = ts.make_optimizer(tc)
    state = ts.init_train_state(
        cfg, opt, torch.Generator(device="cuda").manual_seed(seed), "",
        "cuda")
    step = ts.make_train_step(cfg, tc, opt)
    loader = TokenShardLoader(str(shard), TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    if loader.backend != "native":
        raise AssertionError(f"the loader ran on {loader.backend}")
    writer = ckpt.CheckpointWriter(str(ckpt_dir))
    fed, step_ms, spans, losses = [], [], [], []
    for i in range(4):
        if i == 2:
            clone = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                     for k, v in tree_items(state)}
            t0 = time.perf_counter()
            writer.save_async(state, 2)
            snapshot_ms = (time.perf_counter() - t0) * 1e3
        batch = launcher.device_batch(loader.next(), torch.device("cuda"))
        fed.append(batch["tokens"][:, :8].clone())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step_ms.append((t1 - t0) * 1e3)
        spans.append((t0, t1))
    # The wait for step 2's commit, then step 4's snapshot into the
    # pinned buffers step 2's made.
    t0 = time.perf_counter()
    writer.wait()
    t1 = time.perf_counter()
    writer.save_async(state, 4)
    t2 = time.perf_counter()
    wait2_ms, snapshot4_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    t0 = time.perf_counter()
    writer.close()
    close_s = time.perf_counter() - t0
    loader.close()
    del state, writer, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"handoff losses {losses}")
    template = ts.init_train_state(
        cfg, opt, torch.Generator(device="cuda").manual_seed(seed + 1), "",
        "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ckpt.restore(str(ckpt_dir), 2, template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = dict(tree_items(restored))
    if set(got) != set(clone) or got["step"] != 2 or \
            got["opt_state.count"] != 2:
        raise AssertionError(f"restored step 2: keys {sorted(got)}, step "
                             f"{got.get('step')}")
    bad = [k for k, v in clone.items() if isinstance(v, torch.Tensor)
           and not bits_equal(got[k].cpu(), v)]
    if bad:
        raise AssertionError(f"restore of step 2 differs from the state "
                             f"saved: {bad}")
    del restored, template, got, clone
    gc.collect()
    torch.cuda.empty_cache()
    commit2 = next(c for c in commits if c[0] == 2)
    # How much of step 2's write ran under steps 3 and 4.
    overlap_s = max(0.0, min(commit2[2], spans[3][1])
                    - max(commit2[1], spans[2][0]))
    return {"losses": losses, "step_ms": step_ms,
            "snapshot_ms": snapshot_ms, "commit2_wait_ms": wait2_ms,
            "snapshot4_ms": snapshot4_ms,
            "close_s": close_s, "restore_s": restore_s,
            "commit_s": {c[0]: c[2] - c[1] for c in commits},
            "write_under_steps_s": overlap_s, "fed": fed}


def handoff_launcher(cfg, ckpt_dir: Path, recorder: CoordinatorRecorder,
                     fed_before: list, seed: int) -> dict:
    """(b) The launcher with --checkpoint-dir resumes at step 4, trains
    5-6 on the seed's first batches again (the JAX launcher's loader
    restarts from its seed too), saves step 6; its heartbeats and
    train_step events reach the recorder and its /metrics serves the
    five gauges."""
    per_step = train_per_step(cfg.n_layers)
    argv = ["--model", "llama_1b", "--batch", str(TRAIN_BATCH), "--seq-len",
            str(TRAIN_SEQ), "--steps", str(HANDOFF_STEPS), "--warmup", "1",
            "--log-every", "1", "--seed", str(seed), "--checkpoint-dir",
            str(ckpt_dir)]
    mport = free_port()
    fed, final = [], {}
    real_make = launcher.make_train_step

    def make_train_step(*args, **kwargs):
        step_fn = real_make(*args, **kwargs)

        def step(state, batch):
            fed.append(batch["tokens"][:, :8].clone())
            state, metrics = step_fn(state, batch)
            final["params"] = {k: v.clone()
                               for k, v in tree_items(state["params"])}
            return state, metrics

        return step

    scrapes, done = [], threading.Event()

    def scrape():
        while not done.wait(0.02):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{mport}/metrics",
                        timeout=2) as r:
                    scrapes.append(r.read().decode())
            except OSError:
                pass                    # not up yet, or closed: try again

    poller = threading.Thread(target=scrape, daemon=True)
    buf = io.StringIO()
    launcher.make_train_step = make_train_step
    poller.start()
    try:
        with env_vars(TPU_COORDINATOR_ADDRESS="127.0.0.1:8476",
                      TPU_PEAK_TFLOPS="989", TPU_JOB_ID=HANDOFF_JOB,
                      TPU_TRAIN_METRICS_PORT=str(mport)):
            counters.clear()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = launcher.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = counters.snapshot(*TRAIN_KERNELS)
    finally:
        launcher.make_train_step = real_make
        done.set()
        poller.join(timeout=10)
    print(buf.getvalue(), end="", flush=True)
    steps = [re.fullmatch(r"step (\d+) loss (\S+) tok/s (\d+)", ln)
             for ln in buf.getvalue().splitlines() if ln.startswith("step ")]
    if rc != 0 or not all(steps) or [int(m.group(1)) for m in steps] != [
            5, 6] or not all(math.isfinite(float(m.group(2)))
                             for m in steps):
        raise AssertionError(f"launcher resume: rc {rc}, output "
                             f"{buf.getvalue()!r}")
    want = {k: n * 2 for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"resumed launcher launches {launches} != "
                             f"{want}")
    if len(fed) != 2 or not all(torch.equal(a, b)
                                for a, b in zip(fed, fed_before[:2])):
        raise AssertionError("the resumed launcher did not feed the seed's "
                             "first two batches")
    on_disk = sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit())
    if on_disk != [2, 4, 6] or ckpt.latest_step(str(ckpt_dir)) != 6:
        raise AssertionError(f"checkpoint steps on disk {on_disk}")
    mine = [e for e in recorder.events if e.get("job_id") == HANDOFF_JOB]
    beats = [e["args"] for e in mine if e["name"] == "step_heartbeat"]
    logs = [e["args"]["step"] for e in mine if e["name"] == "train_step"]
    if [b["step"] for b in beats] != [5, 6] or logs != [5, 6] or any(
            b["n_params"] != cfg.num_params() or b["device_count"] != 1
            or b["peak_tflops"] != 989.0 for b in beats):
        raise AssertionError(f"coordinator events {mine}")
    gauges = {}
    for text in scrapes:
        for ln in text.splitlines():
            m = re.fullmatch(r"(tpu_train_\w+) (\S+)", ln)
            if m:
                gauges[m.group(1)] = float(m.group(2))
    if set(gauges) != {n for n, _ in launcher.TRAIN_GAUGES} or \
            gauges["tpu_train_step"] < 5 or not gauges["tpu_train_mfu"] > 0:
        raise AssertionError(f"/metrics gauges {gauges} ({len(scrapes)} "
                             f"scrapes)")
    return {"argv": argv, "wall_s": wall_s,
            "losses": [float(m.group(2)) for m in steps],
            "tok_s": [float(m.group(3)) for m in steps],
            "launches": launches, "launches_per_step": per_step,
            "heartbeats": beats, "metrics": gauges,
            "metrics_scrapes": len(scrapes), "params": final["params"]}


def handoff_server(cfg, ckpt_dir: Path, recorder: CoordinatorRecorder,
                   trained: dict, seed: int) -> dict:
    """(c) ``python -m kuberay_tpu_torch.serve.server --checkpoint-dir``
    as a process: RUNNING once it serves, 8 greedy requests each held to
    the no-cache recompute of the restored params, which must be step 6's
    bit for bit and not seed 0's; after SIGTERM, STOPPED, then
    ``drained=True``."""
    port = free_port()
    cmd = [sys.executable, "-c", SERVE_WITH_COUNTS, "--model", "llama_1b",
           "--checkpoint-dir", str(ckpt_dir), "--coordinator", "auto",
           "--app-name", HANDOFF_APP, "--host", "127.0.0.1", "--port",
           str(port), "--max-slots", str(SLOTS), "--max-len", str(MAX_LEN)]
    lines = []
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cmd, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ,
                            TPU_COORDINATOR_ADDRESS="127.0.0.1:8476"))

    def read():
        for ln in proc.stdout:
            lines.append(ln.rstrip("\n"))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        deadline = time.perf_counter() + 300
        while not any(ln.startswith("serving llama_1b") for ln in lines):
            if proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError("server did not come up: "
                                     + "\n".join(lines[-40:]))
            time.sleep(0.05)
        serving_s = time.perf_counter() - t0
        running = list(recorder.statuses)
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in PROMPT_LENS]
        results, errors = {}, []

        def client(i):
            sent = time.perf_counter() - t0
            try:
                results[i] = (sent, post(f"http://127.0.0.1:{port}", {
                    "prompt_tokens": prompts[i], "max_tokens": MAX_TOKENS,
                    "temperature": 0.0}))
            except Exception as e:          # reported below, then raised
                errors.append(f"request {i}: {e!r}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=30) as r:
            stats = json.load(r)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=180)
        reader.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print("\n".join(lines), flush=True)
    if errors or len(results) != len(prompts) or rc != 0:
        raise AssertionError(f"server: rc {rc}, errors {errors}")
    if running != [(HANDOFF_APP, "RUNNING")] or recorder.statuses != [
            (HANDOFF_APP, "RUNNING"), (HANDOFF_APP, "STOPPED")] or \
            "serve: drained=True" not in lines:
        raise AssertionError(f"app statuses {recorder.statuses} (at "
                             f"serving: {running})")
    counted = [ln for ln in lines if ln.startswith("kernel launches ")]
    launches = json.loads(counted[-1][len("kernel launches "):])
    forwards = stats["prefills"] + stats["decode_steps"] + \
        stats["verify_steps"]
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * forwards,
            "decode_attention": cfg.n_layers * stats["decode_steps"],
            "decode_attention_quant": 0, "paged_decode_attention": 0}
    if stats["decode_steps"] == 0 or launches != want:
        raise AssertionError(f"server launches {launches} != {want} "
                             f"(stats {stats})")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = ckpt.load_params_for_serving(str(ckpt_dir), dtype=cfg.dtype,
                                          device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    got = dict(tree_items(params))
    if set(got) != set(trained) or not all(
            bits_equal(got[k], v) for k, v in trained.items()):
        raise AssertionError("the served params are not step 6's")
    # Every matrix moved; the norms' bf16 ones stay 1.0 under updates of
    # lr 3e-4 (bf16's step at 1 is 2^-7).
    seed0 = dict(tree_items(llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")))
    same = [k for k, v in seed0.items() if not k.endswith("norm")
            and bits_equal(got[k], v)]
    if same:
        raise AssertionError(f"served matrices equal seed 0's: {same}")
    del seed0
    checks = []
    for i in sorted(results):
        status, _, body = results[i][1]
        n = len(body["tokens"])
        if status != 200 or not (
                n == MAX_TOKENS or (body["finish_reason"] == "eos"
                                    and 0 < n <= MAX_TOKENS)):
            raise AssertionError(f"request {i}: status {status}, {body}")
        checks.append(check_against_recompute(cfg, params, prompts[i],
                                              body["tokens"]))
    first_token_s = min(sent + body["ttft_ms"] / 1e3
                        for sent, (_, _, body) in results.values())
    del params
    torch.cuda.empty_cache()
    return {"serving_s": serving_s, "first_token_s": first_token_s,
            "load_params_for_serving_s": load_s,
            "ttft_ms": [results[i][1][2]["ttft_ms"] for i in sorted(results)],
            "engine": stats, "launches": launches, "statuses":
            recorder.statuses, "recompute_check": checks}


def train_to_serve(smi: str, steady_ms: float, seed: int = 0) -> dict:
    """The handoff at llama_1b, 4 x 2048, bf16 masters: (a) the library,
    (b) the launcher's resume, (c) the server on the checkpoint, all
    reporting to a coordinator recorder.  Checkpoints go to a temporary
    directory whose free space must hold three saves."""
    cfg = llama.CONFIGS["llama_1b"]
    save_bytes = 3 * 2 * cfg.num_params()       # params, mu, nu in bf16
    tmp = Path(tempfile.mkdtemp(prefix="train-to-serve-"))
    recorder, commits = None, []
    real_commit = ckpt._commit

    def timed_commit(directory, state, step, keep):
        t0 = time.perf_counter()
        real_commit(directory, state, step, keep)
        commits.append((step, t0, time.perf_counter()))

    try:
        free = shutil.disk_usage(tmp).free
        print(f"train_to_serve: {free} bytes free in {tmp} for three saves "
              f"of about {save_bytes}", flush=True)
        if free < 3.1 * save_bytes:
            raise AssertionError(f"{tmp} has {free} bytes free, three saves "
                                 f"need {3 * save_bytes}")
        ckpt._commit = timed_commit
        recorder = CoordinatorRecorder()
        shard = tmp / "shard.bin"
        synthetic_shard(str(shard), 2_000_000, cfg.vocab_size, seed)
        ckpt_dir = tmp / "ckpt"
        lib = handoff_library(cfg, ckpt_dir, shard, commits, seed)
        saved_bytes = sum(f.stat().st_size
                          for f in (ckpt_dir / "2").iterdir())
        run = handoff_launcher(cfg, ckpt_dir, recorder, lib.pop("fed"), seed)
        srv = handoff_server(cfg, ckpt_dir, recorder, run.pop("params"),
                             seed)
    finally:
        ckpt._commit = real_commit
        if recorder is not None:
            recorder.close()
        shutil.rmtree(tmp)
    out = {"model": "llama_1b", "params": cfg.num_params(),
           "save_bytes": saved_bytes, "free_bytes": free, "library": lib,
           "launcher": run, "server": srv, "steady_step_ms": steady_ms,
           "heartbeats": len(run["heartbeats"])}
    print(f"train_to_serve ({smi}): a save {saved_bytes} bytes; save_async "
          f"returned in {lib['snapshot_ms']:.1f} ms (the snapshot, pinned "
          f"buffers allocated; step 4's {lib['snapshot4_ms']:.1f} into them, "
          f"after {lib['commit2_wait_ms']:.1f} ms waiting for step 2's "
          f"commit), commits "
          f"{json.dumps(lib['commit_s'])} s, {lib['write_under_steps_s']:.2f}"
          f" s of step 2's under steps 3-4; steps "
          f"{[round(x, 1) for x in lib['step_ms']]} ms (3-4 with the write "
          f"in flight) against the launcher's steady {steady_ms:.1f}; "
          f"restore {lib['restore_s']:.2f} s, load_params_for_serving "
          f"{srv['load_params_for_serving_s']:.2f} s; server up in "
          f"{srv['serving_s']:.1f} s, first token at "
          f"{srv['first_token_s']:.1f} s; {out['heartbeats']} heartbeats",
          flush=True)
    return out



# ---------------------------------------------------------------------------
# The entry points, the bench, the profiler hook, and the launcher
# over a process group on this card.
# ---------------------------------------------------------------------------

# The JAX bench's line (bench.py:320-339): the port's bench prints the same
# keys.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL_KEYS = {"model", "params", "batch", "seq", "steps",
                     "achieved_tflops", "mfu_note", "loss", "device"}
BENCH_TOLERANCE = 0.10


# ``python -m kuberay_tpu_torch.bench`` with its kernel launch counts and
# the backward's g copies printed to stderr at exit.
BENCH_WITH_COUNTS = (
    "import atexit, json, runpy, sys\n"
    "from kuberay_tpu_torch.ops import launches as counters\n"
    "atexit.register(lambda: print('kernel launches ' + json.dumps(\n"
    "    counters.snapshot('flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq',\n"
    "                      'rmsnorm', 'rmsnorm_bwd', 'rmsnorm_bwd_dw',\n"
    "                      'rmsnorm_bwd_g_copies')), file=sys.stderr,\n"
    "    flush=True))\n"
    "runpy.run_module('kuberay_tpu_torch.bench', run_name='__main__',\n"
    "                 alter_sys=True)\n")


def run_bench(args: list, what: str) -> tuple:
    """The bench as a process with ``args``: (its stdout's last line, its
    launch counts, its wall seconds, its stderr).  Fails unless it exits 0
    and launched the training kernels exactly as the launcher's steps do,
    for its warm-up and timed steps."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", BENCH_WITH_COUNTS, *args],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    wall_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"{what}: rc {out.returncode}\n{out.stdout}\n"
                             f"{out.stderr[-4000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    counts = json.loads([ln for ln in out.stderr.splitlines()
                         if ln.startswith("kernel launches ")][-1]
                        [len("kernel launches "):])
    per_step = train_per_step(llama.CONFIGS["llama_1b"].n_layers)
    steps = 1 + line["detail"]["steps"]                # the warm-up too
    want = {k: per_step[k] * steps for k in counts if k in per_step}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"{what}: launches {counts} != {want}")
    return line, counts, wall_s, out.stderr


def bench(train_step_ms: float, smi: str) -> dict:
    """``python -m kuberay_tpu_torch.bench`` as a process: its JSON line
    (the JAX bench's keys), its launches exactly the launcher's a step,
    and its median step (CUDA events) within 10% of the ``train`` phase's
    steady launcher step at the same shape."""
    line, counts, wall_s, _ = run_bench([], "bench")
    print(f"bench: {json.dumps(line)}", flush=True)
    d = line["detail"]
    if set(line) != BENCH_KEYS or set(d) != BENCH_DETAIL_KEYS:
        raise AssertionError(f"bench keys {sorted(line)} / {sorted(d)}")
    step_ms = d["batch"] * d["seq"] / line["value"] * 1e3
    rel = step_ms / train_step_ms - 1
    run = {"line": line, "step_ms": step_ms,
           "train_phase_step_ms": train_step_ms, "relative": rel,
           "launches": counts, "wall_s": wall_s, "card": smi}
    print(f"bench step {step_ms:.2f} ms (CUDA events) against the train "
          f"phase's steady {train_step_ms:.2f} ms (host clock): {rel:+.3f}; "
          f"{smi}", flush=True)
    if (d["model"], d["batch"], d["seq"]) != ("llama_1b", TRAIN_BATCH,
                                               TRAIN_SEQ) or \
            not math.isfinite(d["loss"]) or abs(rel) > BENCH_TOLERANCE:
        raise AssertionError(f"bench disagrees with the train phase: {run}")
    return run


# entry()'s forward on random tokens is held to a float32 plain forward,
# no further than the bf16 plain forward is (by this factor): through 16
# layers bf16 rounding moves the logits by ~3% of their norm on either
# path, past local_err's limits for one kernel.
ENTRY_F32_FACTOR = 1.5


def entry_phase(smi: str, seed: int = 8) -> dict:
    """``entry()`` on the card: its forward (llama_1b, 1 x 512, seed-0
    params) on its own all-zero tokens, with 33 RMSNorms and 16 flash
    forwards a call, held against the plain forward (attn_impl="xla") on
    the same params element by element (``local_err``); and on seeded
    random tokens of the same shape (on all-zero tokens every V row is the
    same, so the attention weights cannot show), held to the float32
    plain forward: its norm-relative and worst row-relative distances at
    most ENTRY_F32_FACTOR times the bf16 plain forward's."""
    cfg = llama.CONFIGS["llama_1b"]
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    fn, (params, tokens) = entry_mod.entry()
    counters.clear()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    launches = counters.snapshot(*TRAIN_KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = torch.randint(0, cfg.vocab_size, tuple(tokens.shape),
                         generator=gen, device="cuda", dtype=tokens.dtype)
    with torch.no_grad():
        plain = llama.forward(plain_cfg, params, tokens)
        rec = local_err(logits, plain)
        del plain
        got = fn(params, rand)
        plain = llama.forward(plain_cfg, params, rand)
        exact = llama.forward(
            dataclasses.replace(plain_cfg, dtype=torch.float32),
            ts.tree_map(lambda t: t.float(), params), rand)
        rand_rec = {"kernel_vs_f32": local_err(got, exact),
                    "plain_vs_f32": local_err(plain, exact),
                    "kernel_vs_plain": local_err(got, plain)}
        del plain, exact
    ms = cuda_ms(lambda: fn(params, tokens), 5, warmup=1)
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dkv": 0,
            "flash_bwd_dq": 0, "rmsnorm": 2 * cfg.n_layers + 1,
            "rmsnorm_bwd": 0, "rmsnorm_bwd_dw": 0, "ring_attention_fwd": 0}
    run = {"shape": list(logits.shape), "dtype": str(logits.dtype),
           "vs_plain": rec, "random_tokens": rand_rec,
           "launches": launches, "forward_ms": ms, "card": smi}
    print(f"entry: {json.dumps(run)}", flush=True)
    k, p = rand_rec["kernel_vs_f32"], rand_rec["plain_vs_f32"]
    if logits.shape != (1, 512, cfg.vocab_size) or \
            logits.dtype != torch.float32 or got.shape != logits.shape or \
            not bool(torch.isfinite(logits).all()) or \
            not bool(torch.isfinite(got).all()) or \
            not within_local(rec) or launches != want or \
            not all(k[m] <= ENTRY_F32_FACTOR * p[m]
                    for m in ("norm_rel", "max_row_rel")):
        raise AssertionError(f"entry: {run} (launches expected {want})")
    del params, logits, got
    torch.cuda.empty_cache()
    return run


PROFILE_STEPS = 8
DECODE_KERNEL = "dense_decode_kernel"
RMSNORM_KERNEL = "rmsnorm_fwd_kernel"


def profile_phase(cfg, params, smi: str, seed: int = 7) -> dict:
    """``ProfileHook.start_profile(duration_s=...)`` around eight llama3_8b
    dense decode steps (8 slots of the serve prompts, prefilled before the
    capture): the Chrome trace must hold CUDA kernels named after the
    decode kernel and RMSNorm; prints the ten longest device operations
    and the longest gaps between device operations (where the device waits
    for the host) with the device's idle share over the capture."""
    engine = ServeEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                         device="cuda")
    rng = np.random.default_rng(seed)
    for i, n in enumerate(PROMPT_LENS):
        engine.add_request(Request(f"p{i}", rng.integers(
            0, cfg.vocab_size, n).tolist(), max_new_tokens=64))
    engine.step()                         # every prefill, one decode
    engine.step()
    torch.cuda.synchronize()
    hook = ProfileHook(tempfile.mkdtemp(prefix="profiles-"))
    before = engine.stats["decode_steps"]
    counters.clear()
    started = hook.start_profile(duration_s=120.0)
    if "trace_dir" not in started:
        raise AssertionError(f"profile start: {started}")
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stopped = hook.stop_profile()
    counts = counters.snapshot("rmsnorm", "decode_attention")
    steps = engine.stats["decode_steps"] - before
    del engine
    torch.cuda.empty_cache()
    if stopped.get("trace_dir") != started["trace_dir"]:
        raise AssertionError(f"profile stop: {stopped}")
    trace = json.loads((Path(stopped["trace_dir"]) /
                        profiler_mod.TRACE_FILE).read_text())
    kernels = sorted((e for e in trace["traceEvents"]
                      if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    names = [e["name"] for e in kernels]
    top = sorted(kernels, key=lambda e: -e["dur"])[:10]
    # Gaps between device operations: (ms, the kernel before, the kernel
    # after), the time the device waited for the host's next launch.
    gaps, busy, end, last = [], 0.0, None, ""
    for e in kernels:
        a, b = e["ts"], e["ts"] + e["dur"]
        if end is not None and a > end:
            gaps.append(((a - end) / 1e3, last[:60], e["name"][:60]))
        busy += max(0.0, b - max(a, end if end is not None else a))
        if end is None or b >= end:
            end, last = b, e["name"]
    span = (end - kernels[0]["ts"]) if kernels else 0.0
    run = {"decode_steps": steps, "wall_ms": wall_ms,
           "kernel_events": len(kernels),
           "decode_kernels": sum(DECODE_KERNEL in n for n in names),
           "rmsnorm_kernels": sum(RMSNORM_KERNEL in n for n in names),
           "top_device_ops_ms": [(e["name"][:80], e["dur"] / 1e3)
                                 for e in top],
           "longest_gaps_ms": sorted(gaps, reverse=True)[:10],
           "device_span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1 - busy / span if span else None,
           "launches": counts, "trace_dir": stopped["trace_dir"],
           "card": smi}
    print(f"profile: {json.dumps(run)}", flush=True)
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * PROFILE_STEPS,
            "decode_attention": cfg.n_layers * PROFILE_STEPS}
    if steps != PROFILE_STEPS or counts != want or \
            not run["decode_kernels"] or not run["rmsnorm_kernels"]:
        raise AssertionError(f"profile: {run} (launches expected {want})")
    return run


# mesh_train: llama_1b's full width at MESH_LAYERS of its 16 layers (two
# ranks' states and activations share the card), B 4 x S 2048, float32
# masters with bf16 compute, MESH_STEPS steps at MESH_LR with no warm-up.
# The losses are held absolutely: at this init the loss sits near
# ln(vocab) whatever a layout computes, so a limit relative to it would
# hold nothing.  Each param leaf's change from the seed's params is held
# to the reference's change as ||d - d_ref|| / ||d_ref||: Adam's first
# steps move an element by about lr in the sign of its summed gradient,
# so the change is that sign pattern.  An element whose gradient lies
# within bf16 noise of zero may flip between two sound layouts; a
# gradient not summed over dp or fsdp, or not reduced over tp in the
# backward, flips a large share of them.  The limits stand well above
# the sound runs' readings and below a planted fault's (PERF.md).
MESH_LAYERS, MESH_STEPS, MESH_LR = 4, 2, "2e-5"
MESH_LOSS_ATOL, MESH_DELTA_RTOL = 2e-3, 0.25
# The reference's own change is Adam's size, at most MESH_ADAM_MAX lr an
# element a step: seed params that differed from the launcher's would be
# off by the params' own scale.
MESH_ADAM_MAX = 4.0
MESH_RANK = (
    "import dataclasses, json, sys, torch\n"
    "from kuberay_tpu_torch.models import llama\n"
    "from kuberay_tpu_torch.ops import launches as counters\n"
    "from kuberay_tpu_torch.train import launcher\n"
    "llama.CONFIGS['llama_1b_cut'] = dataclasses.replace(\n"
    "    llama.CONFIGS['llama_1b'], n_layers=int(sys.argv[1]))\n"
    "rc = launcher.main(sys.argv[2:])\n"
    "print('rank result ' + json.dumps({'rc': rc,\n"
    "    'peak_gb': torch.cuda.max_memory_allocated() / 1e9,\n"
    "    **counters.snapshot('flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq',\n"
    "                        'rmsnorm', 'rmsnorm_bwd', 'rmsnorm_bwd_dw',\n"
    "                        'rmsnorm_bwd_g_copies')}), flush=True)\n")
# (name, launcher flags, per-rank env): fsdp and tp on one slice of two
# workers (fsdp absorbs what --tp leaves), dp as two slices of one worker.
MESH_LAYOUTS = (
    ("fsdp2", ["--tp", "1"], "slice"),
    ("tp2", ["--tp", "2"], "slice"),
    ("dp2", ["--tp", "1"], "slices"),
)


def _rank_env(kind: str, rank: int, name: str) -> dict:
    env = {"TPU_COORDINATOR_ADDRESS": "127.0.0.1",
           "TPU_TRAIN_METRICS_PORT": "0", "TPU_JOB_ID": f"mesh-{name}",
           "PYTHONPATH": str(ROOT)}
    if kind == "slice":
        env.update({"TPU_WORKER_HOSTNAMES": "127.0.0.1,127.0.0.1",
                    "TPU_NUM_PROCESSES": "2", "TPU_WORKER_ID": str(rank)})
    elif kind == "slices":
        env.update({"TPU_WORKER_HOSTNAMES": "127.0.0.1",
                    "TPU_NUM_PROCESSES": "1", "TPU_WORKER_ID": "0",
                    "MEGASCALE_NUM_SLICES": "2",
                    "MEGASCALE_SLICE_ID": str(rank)})
    return env


def _run_ranks(argv: list, envs: list, timeout: float = 600.0) -> list:
    """One launcher process a rank (``MESH_RANK``); their outputs and
    each rank's result line (exit code, peak memory, kernel launches)."""
    clean = {k: v for k, v in os.environ.items()
             if not k.startswith(("TPU_", "MEGASCALE_"))}
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_RANK, str(MESH_LAYERS), *argv],
        cwd=ROOT, env={**clean, **env}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for env in envs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    results = []
    for p, out in zip(procs, outs):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("rank result ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"mesh rank rc {p.returncode}:\n"
                                 f"{out[-6000:]}")
        results.append({"stdout": out, **json.loads(
            lines[-1][len("rank result "):])})
    return results


def _losses(recorder, job: str) -> list:
    return [e["args"]["loss"] for e in recorder.events
            if e.get("name") == "train_step" and e.get("job_id") == job]


def _seed_params(cfg) -> dict:
    """The launcher's seeded float32 masters (``--seed 0``), flat."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = ts.init_train_state(cfg, ts.make_optimizer(ts.TrainConfig()),
                                gen, "float32", "cuda")
    return dict(tree_items(state["params"]))


def _delta_rel(delta: dict, ref: dict) -> dict:
    """Each leaf's ||d - d_ref|| / ||d_ref||."""
    return {k: ((d - ref[k]).norm() / ref[k].norm()).item()
            for k, d in delta.items()}


def mesh_train(smi: str) -> dict:
    """The launcher over a real process group on this card: fsdp=2, tp=2
    and dp=2 (two slices), two ranks each on gloo (NCCL refuses two ranks
    on one device; the collectives go through pinned host buffers,
    ``HostStagedGloo``, which rank 0 names), and a one-rank NCCL group
    through the same sharded step.  Each run's losses (full precision,
    from its lead's train_step events) are held to one process's on the
    same seed and batches within MESH_LOSS_ATOL, and each param leaf's
    change over the run (its sharded checkpoint, read back whole, less
    the seed's params) to one process's within MESH_DELTA_RTOL; every
    rank launches the flash kernels and RMSNorm a step as the train phase
    does at this depth.  Every run is read before any failure is raised.
    Prints each rank's peak memory, the step times, the launches and the
    readings."""
    base = ["--model", "llama_1b_cut", "--batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--steps", str(MESH_STEPS),
            "--warmup", "0", "--lr", MESH_LR, "--log-every", "1",
            "--param-dtype", "float32", "--seed", "0"]
    per_step = train_per_step(MESH_LAYERS)
    want = {k: n * MESH_STEPS for k, n in per_step.items()
            if k != "ring_attention_fwd"}
    cfg = dataclasses.replace(llama.CONFIGS["llama_1b"],
                              n_layers=MESH_LAYERS)
    seed = _seed_params(cfg)
    adam_max = MESH_ADAM_MAX * float(MESH_LR) * MESH_STEPS
    root = Path(tempfile.mkdtemp(prefix="mesh-train-"))
    recorder = CoordinatorRecorder()
    runs, failures, ref = {}, [], None
    try:
        plan = [("one_process", [], [_rank_env("none", 0, "one_process")]),
                ("nccl_one_rank", ["--dist-backend", "nccl"],
                 [_rank_env("none", 0, "nccl_one_rank")])]
        plan += [(name, flags + ["--dist-backend", "gloo"],
                  [_rank_env(kind, r, name) for r in range(2)])
                 for name, flags, kind in MESH_LAYOUTS]
        for name, flags, envs in plan:
            t0 = time.perf_counter()
            ranks = _run_ranks(base + flags + [
                "--checkpoint-dir", str(root / name),
                "--dist-port", str(free_port())], envs)
            wall_s = time.perf_counter() - t0
            steps = [re.fullmatch(r"step (\d+) loss (\S+) tok/s (\d+)", ln)
                     for ln in ranks[0]["stdout"].splitlines()
                     if ln.startswith("step ")]
            staged = [ln for ln in ranks[0]["stdout"].splitlines()
                      if ln.startswith("collectives: ")]
            params = ckpt.load_params_for_serving(str(root / name),
                                                  device="cuda")
            shutil.rmtree(root / name)
            delta = {k: v - seed[k] for k, v in tree_items(params)
                     if v.dtype == torch.float32}
            del params
            run = {"ranks": len(ranks), "wall_s": wall_s,
                   "losses": _losses(recorder, f"mesh-{name}"),
                   "step_ms": [TRAIN_BATCH * TRAIN_SEQ / float(m.group(3))
                               * 1e3 for m in steps if m],
                   "peak_gb": [r["peak_gb"] for r in ranks],
                   "launches": [{k: r[k] for k in want} for r in ranks],
                   "rmsnorm_bwd_g_copies": [r["rmsnorm_bwd_g_copies"]
                                            for r in ranks],
                   "collectives": staged}
            bad = []
            if len(delta) != len(seed):
                bad.append(f"{len(seed) - len(delta)} leaves not float32")
            if ref is None:
                ref = {"losses": run["losses"], "delta": delta}
                run["delta_max_abs"] = max(d.abs().max().item()
                                           for d in delta.values())
                run["delta_rms"] = {k: d.square().mean().sqrt().item()
                                    for k, d in delta.items()}
                if not run["delta_max_abs"] <= adam_max or \
                        not all(x > 0 for x in run["delta_rms"].values()):
                    bad.append(f"the reference's change is not Adam's size "
                               f"({adam_max} at most, every leaf moved)")
            else:
                run["loss_abs_err"] = [abs(a - b) for a, b in
                                       zip(run["losses"], ref["losses"])]
                run["delta_rel"] = _delta_rel(delta, ref["delta"])
                run["delta_rel_worst"] = max(run["delta_rel"].values())
                if not all(e <= MESH_LOSS_ATOL
                           for e in run["loss_abs_err"]):
                    bad.append(f"losses beyond {MESH_LOSS_ATOL}")
                if not run["delta_rel_worst"] <= MESH_DELTA_RTOL:
                    bad.append(f"param changes beyond {MESH_DELTA_RTOL}: " +
                               str(sorted(k for k, x in
                                          run["delta_rel"].items()
                                          if x > MESH_DELTA_RTOL)))
                del delta
            torch.cuda.empty_cache()
            runs[name] = run
            print(f"mesh_train {name}: {json.dumps(run)}; {smi}",
                  flush=True)
            gloo = "gloo" in flags
            if len(run["losses"]) != MESH_STEPS or \
                    not all(math.isfinite(x) for x in run["losses"]):
                bad.append(f"{len(run['losses'])} finite losses")
            if any(l != want for l in run["launches"]):
                bad.append(f"launches expected {want}")
            if gloo and not any("HostStagedGloo" in ln for ln in staged):
                bad.append("HostStagedGloo not named")
            if bad:
                failures.append(f"{name}: {bad}")
    finally:
        recorder.close()
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        raise AssertionError(f"mesh_train: {failures}")
    return {"layers": MESH_LAYERS, "steps": MESH_STEPS, "lr": MESH_LR,
            "loss_atol": MESH_LOSS_ATOL, "delta_rtol": MESH_DELTA_RTOL,
            "launches_per_rank_per_step": {k: per_step[k] for k in want},
            "runs": runs}


# Tensor-parallel serving (serve_tp): llama3_8b's local head counts at tp=2
# (16 q / 4 kv heads a rank) and at tp=16 over its 8 kv heads (tp=8 x
# tpr=2: 2 / 1); the gloo group's prompts stay at or under 512 tokens (a
# prefill's 64 all-reduces go through pinned host memory); TP_MISS is
# the killed group's --group-miss-timeout.
TP_LOCAL_HEADS = ((16, 4), (2, 1))
TP_LENS = [0, 1, 17, 100, 1023, 1025, 2047, 2048]
TP_PROMPT_LENS = (7, 33, 64, 128, 200, 300, 400, 512)
TP_SHARED, TP_SHARED_SUFFIXES, TP_OTHER_LENS = 256, (7, 33, 100, 200), \
    (64, 200, 300, 512)
TP_MISS = 5.0
TP_WEIGHT_RTOL = 0.01
# A serving rank as ``python -c``: the server's main, its kernel launch
# counts, the bytes of the shards it drew, its peak memory, the plans it
# broadcast by op and its block copies' (count, ms) printed at exit: a
# demotion pump's blocks taken off the queue, a promotion's blocks, an
# export's records, an import's blocks, each timed to a device sync.
SERVE_TP_RANK = (
    "import atexit, json, runpy, time, numpy as np, torch\n"
    "from kuberay_tpu_torch.ops import launches as counters\n"
    "from kuberay_tpu_torch.serve import multihost, paged_engine, sharding\n"
    "held = {'plans': {}, 'tier_ms': {}}\n"
    "def nbytes(t):\n"
    "    if isinstance(t, dict):\n"
    "        return sum(nbytes(v) for v in t.values())\n"
    "    return t.numel() * t.element_size()\n"
    "def init(cfg, seed, mesh, _real=sharding.init_sharded_params):\n"
    "    params = _real(cfg, seed, mesh)\n"
    "    held['weight_bytes'] = nbytes(params)\n"
    "    return params\n"
    "sharding.init_sharded_params = init\n"
    "def send(self, _real=multihost.MultihostServeEngine._send, **u):\n"
    "    op = str(int(np.asarray(u['op']).ravel()[0]))\n"
    "    held['plans'][op] = held['plans'].get(op, 0) + 1\n"
    "    return _real(self, **u)\n"
    "multihost.MultihostServeEngine._send = send\n"
    "def timed(name, cls=paged_engine.PagedServeEngine):\n"
    "    real = getattr(cls, name)\n"
    "    def wrapper(self, *a, **k):\n"
    "        t0 = time.perf_counter()\n"
    "        out = real(self, *a, **k)\n"
    "        torch.cuda.synchronize()\n"
    "        n = len(out) if isinstance(out, list) else \\\n"
    "            out['imported'] if isinstance(out, dict) else out\n"
    "        if n:\n"
    "            held['tier_ms'].setdefault(name, []).append(\n"
    "                [n, (time.perf_counter() - t0) * 1e3])\n"
    "        return out\n"
    "    setattr(cls, name, wrapper)\n"
    "for name in ('_pump_demotions', '_promote_from_tiers',\n"
    "             'export_kv_blocks', 'import_kv_blocks'):\n"
    "    timed(name)\n"
    "atexit.register(lambda: print('rank stats ' + json.dumps({\n"
    "    'launches': counters.snapshot(\n"
    "        'rmsnorm', 'decode_attention', 'decode_attention_quant',\n"
    "        'paged_decode_attention'),\n"
    "    'weight_bytes': held.get('weight_bytes'),\n"
    "    'plans': held['plans'], 'tier_ms': held['tier_ms'],\n"
    "    'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9}),\n"
    "    flush=True))\n"
    "runpy.run_module('kuberay_tpu_torch.serve.server', run_name='__main__',\n"
    "                 alter_sys=True)\n")


def local_head_checks(gen: torch.Generator) -> dict:
    """The bf16, int8 and paged decode kernels at a tp rank's local head
    counts (TP_LOCAL_HEADS), S 8, M 2048, lens 0..2048: each against its
    plain version (element-wise limits) and timed beside SDPA, with its
    bound and split plan."""
    out = {}
    lens_t = torch.tensor(TP_LENS, dtype=torch.int32, device="cuda")
    live, M = int(sum(TP_LENS)), MAX_LEN
    mask = lens_mask(lens_t, M)
    maxb = M // BLOCK_SIZE
    nblk = SLOTS * maxb
    tables = scrambled_tables(gen, SLOTS, maxb, nblk, shared=10)
    pages = sum(-(-n // BLOCK_SIZE) for n in TP_LENS)
    for hq, hkv in TP_LOCAL_HEADS:
        q = torch.randn(SLOTS, hq, HD, generator=gen, device="cuda"
                        ).bfloat16()
        caches = [tuple(torch.randn(SLOTS, M, hkv, HD, generator=gen,
                                    device="cuda").bfloat16()
                        for _ in range(2)) for _ in range(4)]
        quants = [int8_cache(gen, SLOTS, M, hkv, HD) for _ in range(4)]
        deq = [(da.dequant_lanes(kq, ks, torch.bfloat16),
                da.dequant_lanes(vq, vs, torch.bfloat16))
               for kq, ks, vq, vs in quants]
        pools = [tuple(torch.randn(hkv, nblk * BLOCK_SIZE, HD, generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(2)) for _ in range(4)]
        views = [tuple(pa.gather_view(p, tables, BLOCK_SIZE).contiguous()
                       for p in pool) for pool in pools]
        it = iter(range(1 << 30))

        def run(fn, inputs):
            return lambda: fn(*inputs[next(it) % 4])

        q_bytes = 2 * q.numel() * 2 + lens_t.numel() * 4
        cases = {
            "decode_attention": (
                lambda k, v: da.decode_attention(q, k, v, lens_t),
                lambda k, v: da.decode_attention_ref(q, k, v, lens_t),
                caches, lambda k, v: sdpa_decode(q, k, v, mask), caches,
                2 * live * hkv * HD * 2 + q_bytes),
            "decode_attention_quant": (
                lambda kq, ks, vq, vs: da.decode_attention_quant(
                    q, kq, ks, vq, vs, lens_t),
                lambda kq, ks, vq, vs: da.decode_attention_quant_ref(
                    q, kq, ks, vq, vs, lens_t),
                quants, lambda k, v: sdpa_decode(q, k, v, mask), deq,
                2 * live * hkv * (HD + 4) + q_bytes),
            "paged_decode_attention": (
                lambda k, v: pa.paged_decode_attention(
                    q, k, v, lens_t, tables, BLOCK_SIZE),
                lambda k, v: pa.paged_decode_attention_ref(
                    q, k, v, lens_t, tables, BLOCK_SIZE),
                pools, lambda k, v: sdpa_decode(q, k, v, mask), views,
                2 * live * hkv * HD * 2 + q_bytes + pages * 4)}
        for name, (kernel, plain, inputs, lib, lib_inputs, nbytes) in \
                cases.items():
            loc = local_err(kernel(*inputs[0]), plain(*inputs[0]))
            if not within_local(loc):
                raise AssertionError(f"{name} at {hq}/{hkv} local heads: "
                                     f"{loc}")
            rec = {"Hq": hq, "Hkv": hkv, "lens": TP_LENS,
                   "max_abs_err": loc["max_abs_err"], "local": loc,
                   "chunk": da.CHUNK, "nsplit": da.split_plan(M),
                   **timings(run(kernel, inputs), run(plain, inputs),
                             run(lib, lib_inputs), 100, 20),
                   **bound(nbytes, 4 * live * hq * HD)}
            out.setdefault(name, []).append(rec)
            print(f"{name} at {hq} q / {hkv} kv local heads: "
                  f"{json.dumps(rec)}", flush=True)
        del caches, quants, deq, pools, views
    torch.cuda.empty_cache()
    return out


class ServeGroup:
    """The server as a tp group of processes sharing this card (one
    ``SERVE_TP_RANK`` process a rank, the worker env, LOCAL_RANK 0),
    llama3_8b at 8 slots x 2048 with seed 0's weights drawn into each
    rank's shards; each one's output read as it comes."""

    def __init__(self, n: int, backend: str, *flags):
        self.port = free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        dist_port, hb_port = free_port(), free_port()
        clean = {k: v for k, v in os.environ.items()
                 if not k.startswith(("TPU_", "MEGASCALE_"))}
        self.lines = [[] for _ in range(n)]
        self.procs = []
        for r in range(n):
            env = dict(clean, LOCAL_RANK="0", PYTHONPATH=str(ROOT),
                       TPU_GROUP_HEALTH_PORT=str(hb_port))
            if n > 1:
                env.update(TPU_WORKER_HOSTNAMES=",".join(["127.0.0.1"] * n),
                           TPU_WORKER_ID=str(r))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", SERVE_TP_RANK, "--model", "llama3_8b",
                 "--device", "cuda", "--tp", str(n), "--dist-backend",
                 backend, "--dist-port", str(dist_port), "--host",
                 "127.0.0.1", "--port", str(self.port), "--max-slots",
                 str(SLOTS), "--max-len", str(MAX_LEN), *flags],
                cwd=str(ROOT), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            threading.Thread(target=self._read, args=(r,),
                             daemon=True).start()

    def _read(self, r: int) -> None:
        for ln in self.procs[r].stdout:
            self.lines[r].append(ln.rstrip("\n"))

    def has(self, r: int, prefix: str) -> bool:
        return any(ln.startswith(prefix) for ln in self.lines[r])

    def ready(self, timeout: float = 300.0) -> float:
        """Seconds until rank 0 serves and every follower is ready."""
        t0 = time.perf_counter()
        want = [(0, "serving llama3_8b")] + [
            (r, f"serve follower {r}/") for r in range(1, len(self.procs))]
        while not all(self.has(r, p) for r, p in want):
            if any(p.poll() is not None for p in self.procs) or \
                    time.perf_counter() - t0 > timeout:
                self.kill()
                raise AssertionError(f"tp group did not come up: "
                                     f"{self.tail()}")
            time.sleep(0.1)
        return time.perf_counter() - t0

    def get(self, path: str, timeout: float = 30.0):
        try:
            with urllib.request.urlopen(self.url + path,
                                        timeout=timeout) as r:
                return r.status, json.load(r)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e)

    def stop(self, timeout: float = 180.0) -> list:
        """SIGTERM to every rank (a pod roll); their exit codes."""
        for p in self.procs:
            p.send_signal(signal.SIGTERM)
        try:
            return [p.wait(timeout=timeout) for p in self.procs]
        finally:
            self.kill()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)

    def tail(self) -> str:
        return "\n".join(f"[rank {r}] {ln}" for r, lines in
                         enumerate(self.lines) for ln in lines[-30:])

    def rank_stats(self, r: int) -> dict:
        got = [ln for ln in self.lines[r] if ln.startswith("rank stats ")]
        if not got:
            raise AssertionError(f"rank {r} printed no stats: {self.tail()}")
        return json.loads(got[-1][len("rank stats "):])


def post_all(url: str, prompts, max_tokens: int) -> list:
    """Every prompt POSTed at once (greedy); the (status, body) pairs in
    prompt order."""
    results, errors = {}, []

    def client(i):
        try:
            results[i] = post(url, {"prompt_tokens": prompts[i],
                                    "max_tokens": max_tokens,
                                    "temperature": 0.0})
        except Exception as e:              # reported below, then raised
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or len(results) != len(prompts):
        raise AssertionError(f"requests failed: {errors}")
    out = []
    for i in range(len(prompts)):
        status, _, body = results[i]
        n = len(body["tokens"])
        if status != 200 or not (n == max_tokens or (
                body["finish_reason"] == "eos" and 0 < n <= max_tokens)):
            raise AssertionError(f"request {i}: status {status}, {body}")
        out.append(body)
    return out


def tp_variant(name: str, cfg, params, flags, prompts, margin: float,
               kernel: str, half_bytes: float) -> dict:
    """Two ranks at --tp 2 on gloo (host-staged collectives) serve the
    prompts; every served token is held to the no-cache recompute of the
    whole tree, each rank's weights to half the tree's bytes, every
    follower's replay to rank 0's device calls and each rank's launches
    to 65 RMSNorms a forward and 32 ``kernel`` launches a decode step;
    both exit 0 after SIGTERM, the drain and STOP."""
    g = ServeGroup(2, "gloo", *flags)
    try:
        start_s = g.ready()
        t0 = time.perf_counter()
        bodies = post_all(g.url, prompts, MAX_TOKENS)
        batch_s = time.perf_counter() - t0
        _, stats = g.get("/stats")
        rcs = g.stop()
    finally:
        g.kill()
    print(g.tail(), flush=True)
    if rcs != [0, 0] or "serve: drained=True" not in g.lines[0]:
        raise AssertionError(f"serve_tp {name}: exit codes {rcs}")
    calls = stats["prefills"] + stats["decode_steps"] + stats["verify_steps"]
    replayed = f"serve follower 1/2: STOP after {calls} device calls"
    if replayed not in g.lines[1] or stats["decode_steps"] == 0:
        raise AssertionError(f"serve_tp {name}: follower did not replay "
                             f"{calls} calls: {g.tail()}")
    ranks = [g.rank_stats(r) for r in range(2)]
    want = {k: 0 for k in ("decode_attention", "decode_attention_quant",
                           "paged_decode_attention")}
    want.update(rmsnorm=(2 * cfg.n_layers + 1) * calls)
    want[kernel] = cfg.n_layers * stats["decode_steps"]
    if stats["decode_graph_steps"] or stats["prefill_graph_steps"]:
        raise AssertionError(f"serve_tp {name}: a tp rank replayed a "
                             f"graph ({stats})")
    for r, rs in enumerate(ranks):
        if rs["launches"] != want:
            raise AssertionError(f"serve_tp {name} rank {r}: launches "
                                 f"{rs['launches']} != {want}")
        if abs(rs["weight_bytes"] - half_bytes) > TP_WEIGHT_RTOL * half_bytes:
            raise AssertionError(f"serve_tp {name} rank {r}: weights "
                                 f"{rs['weight_bytes']} bytes, half the "
                                 f"tree is {half_bytes}")
    checks = [check_against_recompute(cfg, params, p, b["tokens"], margin)
              for p, b in zip(prompts, bodies)]
    out = {"flags": list(flags), "start_s": start_s, "batch_wall_s": batch_s,
           "decode_step_ms": 1e3 * stats["decode_s"] / stats["decode_steps"],
           "decode_tokens_per_s": stats["decode_tokens"] / stats["decode_s"],
           "ttft_ms": [b["ttft_ms"] for b in bodies], "device_calls": calls,
           "follower_replayed": calls, "engine": stats,
           "weight_bytes": [rs["weight_bytes"] for rs in ranks],
           "peak_memory_gb": [rs["peak_memory_gb"] for rs in ranks],
           "launches": {k: sum(rs["launches"][k] for rs in ranks)
                        for k in want},
           "group": stats["group"], "recompute_check": checks}
    if "--paged" in flags:
        hits = stats["prefix_hit_tokens"]
        if hits != 3 * TP_SHARED:
            raise AssertionError(f"serve_tp {name}: prefix hits {hits} != "
                                 f"{3 * TP_SHARED}")
    print(f"serve_tp {name}: " + json.dumps(
        {k: v for k, v in out.items() if k != "recompute_check"}),
        flush=True)
    return out


def tp_one_rank_nccl(cfg, prompts, want_tokens) -> dict:
    """A one-rank NCCL group through the lockstep engine at tp=1: the
    serve phase's tokens bit for bit (the same weights, prompts and
    kernels; its collectives and plans are a group of one's)."""
    g = ServeGroup(1, "nccl")
    try:
        start_s = g.ready()
        bodies = post_all(g.url, prompts, MAX_TOKENS)
        _, stats = g.get("/stats")
        rcs = g.stop()
    finally:
        g.kill()
    got = [b["tokens"] for b in bodies]
    if rcs != [0] or got != want_tokens:
        raise AssertionError(f"serve_tp nccl: exit {rcs}, tokens {got} != "
                             f"the serve phase's {want_tokens}: {g.tail()}")
    rs = g.rank_stats(0)
    print(f"serve_tp nccl tp=1: {json.dumps(rs)}", flush=True)
    return {"start_s": start_s, "tokens_equal_serve": True,
            "decode_step_ms": 1e3 * stats["decode_s"] / stats["decode_steps"],
            "launches": rs["launches"], "weight_bytes": rs["weight_bytes"],
            "peak_memory_gb": rs["peak_memory_gb"], "engine": stats}


def tp_killed_follower(prompt) -> dict:
    """SIGKILL the follower mid-decode: rank 0's /healthz answers 503
    within --group-miss-timeout + 5 s, the pending request 503, and rank 0
    leaves at SIGTERM (every wait bounded)."""
    g = ServeGroup(2, "gloo", "--group-miss-timeout", str(TP_MISS))
    box = {}

    def client():
        try:
            box["status"] = post(g.url, {"prompt_tokens": prompt,
                                         "max_tokens": MAX_LEN - len(prompt)
                                         - 8, "temperature": 0.0},
                                 timeout=TP_MISS + 60)[0]
        except urllib.error.HTTPError as e:
            box["status"] = e.code
        except Exception as e:              # recorded, then raised below
            box["error"] = repr(e)

    try:
        g.ready()
        t = threading.Thread(target=client, daemon=True)
        t.start()
        deadline = time.perf_counter() + 120
        while g.get("/stats")[1]["decode_steps"] < 4:
            if time.perf_counter() > deadline or not t.is_alive():
                raise AssertionError(f"no decoding to interrupt: {box}")
            time.sleep(0.05)
        steps_at_kill = g.get("/stats")[1]["decode_steps"]
        g.procs[1].send_signal(signal.SIGKILL)
        t0 = time.perf_counter()
        while g.get("/healthz")[0] != 503:
            if time.perf_counter() - t0 > TP_MISS + 5:
                raise AssertionError(f"/healthz not 503 {TP_MISS + 5} s "
                                     f"after the kill: {g.tail()}")
            time.sleep(0.05)
        healthz_s = time.perf_counter() - t0
        t.join(timeout=TP_MISS + 60)
        if box.get("status") != 503 or t.is_alive():
            raise AssertionError(f"pending request: {box}, alive "
                                 f"{t.is_alive()}")
        _, health = g.get("/healthz")
        g.procs[0].send_signal(signal.SIGTERM)
        rc0 = g.procs[0].wait(timeout=60)
    finally:
        g.kill()
    print(g.tail(), flush=True)
    return {"decode_steps_at_kill": steps_at_kill, "healthz_503_s": healthz_s,
            "reason": health.get("reason"), "rank0_exit": rc0,
            "miss_timeout_s": TP_MISS}


def serve_tp(cfg, params, smi: str, serve_run: dict, decode_res: dict,
             seed: int = 9) -> dict:
    """Tensor-parallel serving on this card: the decode kernels at local
    head counts, the server at --tp 2 (two ranks on gloo, host-staged
    collectives: dense bf16, paged bf16, dense int8 KV), a one-rank NCCL
    group, a killed follower."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kernels = local_head_checks(gen)
    print("decode kernels at group 2 (ptxas): " + json.dumps(
        {k: decode_res[k][f"D{HD}G2"] for k in
         ("decode_attention", "decode_attention_quant",
          "paged_decode_attention")}), flush=True)
    half = tree_bytes(params) / 2
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in TP_PROMPT_LENS]
    prefix = rng.integers(0, cfg.vocab_size, TP_SHARED).tolist()
    shared = ([prefix + rng.integers(0, cfg.vocab_size, n).tolist()
               for n in TP_SHARED_SUFFIXES]
              + [rng.integers(0, cfg.vocab_size, n).tolist()
                 for n in TP_OTHER_LENS])
    runs = {
        "dense": tp_variant("dense", cfg, params, (), prompts,
                            RECOMPUTE_MARGIN["bf16"], "decode_attention",
                            half),
        "paged": tp_variant("paged", cfg, params,
                            ("--paged", "--block-size", str(BLOCK_SIZE)),
                            shared, RECOMPUTE_MARGIN["bf16"],
                            "paged_decode_attention", half),
        "int8_kv": tp_variant("int8_kv", cfg, params, ("--kv-quant", "int8"),
                              prompts, RECOMPUTE_MARGIN["int8"],
                              "decode_attention_quant", half)}
    rng0 = np.random.default_rng(0)       # serve()'s prompts
    serve_prompts = [rng0.integers(0, cfg.vocab_size, n).tolist()
                     for n in PROMPT_LENS]
    nccl = tp_one_rank_nccl(cfg, serve_prompts, serve_run["tokens"])
    killed = tp_killed_follower(prompts[2])
    launches = {}
    for run in (*runs.values(), nccl):
        for k, n in run["launches"].items():
            launches[k] = launches.get(k, 0) + n
    print(f"serve_tp on {smi}: decode step ms " + json.dumps(
        {k: r["decode_step_ms"] for k, r in runs.items()}) + "; killed "
        f"follower: {json.dumps(killed)}", flush=True)
    return {"kernels": kernels, **runs, "nccl_tp1": nccl,
            "killed_follower": killed, "launches": launches}


# The KV tiers and the block transfer under tp (serve_tp_tiers): a pool of
# TPT_BLOCKS blocks a rank holds the first wave whole (serve_tp's paged
# prompts and their decode blocks take about 124); a host tier of
# TPT_HOST blocks on rank 0; an evicting wave of TPT_EVICT_LENS prompts of
# one new token each (450 blocks); TPT_PUMP_TOKENS decode steps a request
# that drains the queued demotions (4 a step); handoff prompts of
# TPT_HANDOFF_LENS tokens.  A group's export of a prompt is held to the
# one-process replica's export of the same prompt, and to a float32
# forward's K/V of it, layer by layer: the largest difference within
# TPT_EXPORT_MARGIN of the layer's largest |value|.  Sound bf16 exports
# read up to 0.049 against float32 and each other, the one-process
# replica's as far from float32 as the group's, both growing with depth
# from 0.004 at layer 0; the group's kv heads joined in the wrong mesh
# order read 1.23 to 1.61 at every layer, one rank's heads missing 0.88
# to 1.0 (NVIDIA H100 80GB HBM3, 700 W).  The limit sits about 4x above
# the one and below the other.
TPT_BLOCKS, TPT_HOST = 192, 512
TPT_EVICT_LENS = (1200,) * 6
TPT_PUMP_TOKENS = 48
TPT_HANDOFF_LENS = (700, 600, 500)
TPT_EXPORT_MARGIN = 0.2


def tpt_first_wave(cfg, rng) -> list:
    """serve_tp's paged prompts drawn from ``rng``: 4 sharing a
    TP_SHARED-token prefix, then 4 others."""
    prefix = rng.integers(0, cfg.vocab_size, TP_SHARED).tolist()
    return ([prefix + rng.integers(0, cfg.vocab_size, n).tolist()
             for n in TP_SHARED_SUFFIXES]
            + [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in TP_OTHER_LENS])


def serve_first_wave(url: str, prompts, pinned: bool = True) -> list:
    """A first wave's greedy tokens.  ``pinned``: the first prompt alone,
    then the other seven together, so the shared prefix's K/V always come
    from the first prompt's prefill (else from whichever request the
    engine admits first, in other shapes that round otherwise)."""
    if not pinned:
        return [b["tokens"] for b in post_all(url, prompts, MAX_TOKENS)]
    return [b["tokens"] for b in post_all(url, prompts[:1], MAX_TOKENS)
            + post_all(url, prompts[1:], MAX_TOKENS)]


def wire_blocks(blocks, cfg) -> np.ndarray:
    """[n, 2, L, Hkv, block_size, D] float32 of ``/v1/kv/export``
    records."""
    shape = (cfg.n_layers, cfg.n_kv_heads, BLOCK_SIZE, cfg.head_dim)
    return np.stack([np.stack([np.frombuffer(base64.b64decode(b[n]), "<f4")
                               .reshape(shape) for n in ("k", "v")])
                     for b in blocks])


def layer_ratio(got: np.ndarray, ref: np.ndarray) -> list:
    """Per layer (axis 2 of [n, 2, L, ...]), the largest |got - ref| over
    the layer's largest |ref|."""
    return [float(np.abs(got[:, :, l] - ref[:, :, l]).max()
                  / np.abs(ref[:, :, l]).max())
            for l in range(got.shape[2])]


def export_pair(group_url: str, replica_url: str, prompt) -> list:
    """The prompt prefilled on each side (one token), its blocks exported
    from each: the two lists of wire records, the group's first."""
    exports = []
    for url in (group_url, replica_url):
        post_json(url, "/v1/completions", {"prompt_tokens": prompt,
                                           "max_tokens": 1})
        _, _, exp, _ = post_json(url, "/v1/kv/export",
                                 {"prompt_tokens": prompt})
        exports.append(exp["blocks"])
    if [b["hash"] for b in exports[0]] != [b["hash"] for b in exports[1]] \
            or len(exports[0]) != len(prompt) // BLOCK_SIZE:
        raise AssertionError("the two exports hold other blocks")
    return exports


class Widened:
    """A stacked layer leaf whose ``[i]`` is layer i in float32, for
    ``forward_with_cache``'s loop (one layer widened at a time)."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __getitem__(self, i):
        return self.t[i].float()


def float32_kv(cfg, params, prompt, n_blocks: int) -> np.ndarray:
    """[n_blocks, 2, L, Hkv, block_size, D]: the K/V of the prompt's first
    ``n_blocks`` blocks from one float32 forward of the whole tree (the
    bf16 weights widened a layer at a time, float32 activations and
    cache, TF32 off): what an engine without rounding would export."""
    T = n_blocks * BLOCK_SIZE
    L, hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    cache = {n: torch.zeros(L, 1, T, hkv, D, dtype=torch.float32,
                            device="cuda") for n in ("k", "v")}
    wide = dict(params, embed=params["embed"].float(),
                final_norm=params["final_norm"].float(),
                layers={k: Widened(v) for k, v in params["layers"].items()})
    with torch.no_grad():
        forward_with_cache(cfg, wide, torch.tensor([prompt[:T]],
                                                   device="cuda"),
                           cache, torch.zeros(1, dtype=torch.long,
                                              device="cuda"),
                           logits_index=torch.tensor([T - 1],
                                                     device="cuda"))
    kv = torch.stack([cache["k"][:, 0], cache["v"][:, 0]])  # [2, L, T, H, D]
    kv = kv.reshape(2, L, n_blocks, BLOCK_SIZE, hkv, D)
    out = kv.permute(2, 0, 1, 4, 3, 5).contiguous().cpu().numpy()
    del cache, wide, kv
    torch.cuda.empty_cache()
    return out


def export_witness(cfg, params, prompt, exports) -> dict:
    """The group's export (``exports[0]``) against the replica's and
    against ``float32_kv``, the replica's against ``float32_kv``, layer
    by layer; and what two faults would read against the replica: the
    group's kv heads joined in the wrong mesh order, and tp index 1's
    heads missing (zeros)."""
    got, rep = (wire_blocks(e, cfg) for e in exports)
    exact = float32_kv(cfg, params, prompt, got.shape[0])
    half = cfg.n_kv_heads // 2
    swapped = np.concatenate([got[:, :, :, half:], got[:, :, :, :half]], 3)
    zeroed = got.copy()
    zeroed[:, :, :, half:] = 0
    rows = {"group_vs_replica": layer_ratio(got, rep),
            "group_vs_float32": layer_ratio(got, exact),
            "replica_vs_float32": layer_ratio(rep, exact),
            "swapped_vs_replica": layer_ratio(swapped, rep),
            "zeroed_vs_replica": layer_ratio(zeroed, rep)}
    return {"blocks": got.shape[0], "margin": TPT_EXPORT_MARGIN,
            "worst": {k: max(v) for k, v in rows.items()},
            "least": {k: min(v) for k, v in rows.items()},
            "norm_rel": float(np.linalg.norm(got - rep)
                              / np.linalg.norm(rep)),
            "layer_ratio": rows}


def per_block_ms(pairs) -> float | None:
    """Milliseconds a block over (blocks, ms) records."""
    n = sum(b for b, _ in pairs)
    return sum(ms for _, ms in pairs) / n if n else None


def serve_tp_tiers(cfg, params, smi: str, seed: int = 10) -> dict:
    """llama3_8b's KV tiers and block transfer under tp: the server as two
    ranks at ``--tp 2 --paged --host-blocks`` sharing this card over gloo,
    seed 0's weights drawn into each rank's shards (``params`` is the
    whole tree, for the recompute and the one-process replica).
    ``serve_tiers``' waves: the first wave (serve_tp's paged prompts, 4
    sharing a 256-token prefix; the first prompt alone, then the other
    seven together), the same wave while its blocks are on
    the card, requests of TPT_PUMP_TOKENS steps until no demotion is
    queued, an evicting wave that leaves none of the first wave's blocks
    on the card, the first wave again.  The repeat must promote from the
    host tier, prefill fewer tokens than the first wave, and give the
    warm wave's tokens; every wave's tokens pass the no-cache recompute of
    the whole tree.  Then the handoff over ``/v1/kv/*`` both ways with a
    one-process paged replica with the same tiers (each receiver's prefix
    hits cover the imported blocks, its tokens pass the recompute), and
    the group's export of a third prompt against the replica's export of
    it and against a float32 forward's K/V of it (TPT_EXPORT_MARGIN;
    ``export_witness`` also reads the replica against float32 and two
    faults against the replica).  The follower replays every plan rank 0
    broadcast, the block plans among them; both ranks launch 65 RMSNorms
    a forward and 32 paged decode attentions a decode step.  Prints the
    demotion, promotion, export and import ms a block (rank 0's, host
    staged) and the follower's replay count."""
    flags = ("--paged", "--block-size", str(BLOCK_SIZE), "--num-blocks",
             str(TPT_BLOCKS), "--host-blocks", str(TPT_HOST))
    rng = np.random.default_rng(seed)
    prompts = tpt_first_wave(cfg, rng)
    evict = [rng.integers(0, cfg.vocab_size, n).tolist()
             for n in TPT_EVICT_LENS]
    x, y, z = (rng.integers(0, cfg.vocab_size, n).tolist()
               for n in TPT_HANDOFF_LENS)
    replica = PagedServeEngine(cfg, params, max_slots=SLOTS,
                               max_len=MAX_LEN, block_size=BLOCK_SIZE,
                               num_blocks=TPT_BLOCKS, host_blocks=TPT_HOST,
                               device="cuda")
    fe = ServeFrontend(replica)
    rsrv, rurl = fe.serve_background("127.0.0.1", 0)
    g = ServeGroup(2, "gloo", *flags)
    waves = {}
    try:
        start_s = g.ready()
        counters.clear()

        def gstats():
            return g.get("/stats")[1]

        def resident():
            return [post_json(g.url, "/v1/kv/resident",
                              {"prompt_tokens": p})[2]["resident_blocks"]
                    for p in prompts]

        for name in ("first", "warm"):
            before = gstats()
            t0 = time.perf_counter()
            tokens = serve_first_wave(g.url, prompts, name == "first")
            waves[name] = {"wall_s": time.perf_counter() - t0,
                           "tokens": tokens,
                           "prefilled": prefilled(gstats())
                           - prefilled(before),
                           "resident_blocks": resident()}
        pumps = 0
        while gstats()["pending_demotions"] and pumps < 4:
            post_all(g.url, [prompts[0][:7]], TPT_PUMP_TOKENS)
            pumps += 1
        drained = gstats()
        post_all(g.url, evict, 1)
        waves["evict"] = {"resident_blocks": resident(),
                          "host_blocks_used": gstats()["host_blocks_used"]}
        before = gstats()
        t0 = time.perf_counter()
        tokens = [b["tokens"] for b in post_all(g.url, prompts, MAX_TOKENS)]
        after = gstats()
        waves["repeat"] = {
            "wall_s": time.perf_counter() - t0, "tokens": tokens,
            "prefilled": prefilled(after) - prefilled(before),
            "tier_fetch_blocks": after["tier_fetch_blocks"]
            - before["tier_fetch_blocks"]}
        to_replica = handoff(g.url, rurl, x, fe.stats)
        to_group = handoff(rurl, g.url, y, gstats)
        for row in (to_replica, to_group):
            del row["body"]
        exports = export_pair(g.url, rurl, z)
        final = gstats()
        replica_launches = counters.snapshot(*SERVE_KERNELS)
        replica_stats = fe.stats()
        rcs = g.stop()
    finally:
        g.kill()
        rsrv.shutdown()
        rsrv.server_close()
        fe.close()
    print(g.tail(), flush=True)
    ranks = [g.rank_stats(r) for r in range(2)]
    plans = ranks[0]["plans"]
    replayed = sum(n for op, n in plans.items() if op != "0")
    failures = []
    if rcs != [0, 0] or "serve: drained=True" not in g.lines[0]:
        failures.append(f"exit codes {rcs}")
    if f"serve follower 1/2: STOP after {replayed} device calls" not in \
            g.lines[1]:
        failures.append(f"the follower did not replay {replayed} plans")
    blocks = {"read": plans.get("4", 0), "write": plans.get("5", 0)}
    if not blocks["read"] or not blocks["write"]:
        failures.append(f"no block plans: {plans}")
    if drained["pending_demotions"]:
        failures.append(f"demotions still queued: {drained}")
    if any(waves["evict"]["resident_blocks"]):
        failures.append(f"first-wave blocks left on the card: "
                        f"{waves['evict']}")
    rep, first, warm = waves["repeat"], waves["first"], waves["warm"]
    if rep["tier_fetch_blocks"] <= 0 or \
            rep["prefilled"] >= first["prefilled"]:
        failures.append(f"no promotion: {rep} (first wave prefilled "
                        f"{first['prefilled']})")
    if rep["tokens"] != warm["tokens"]:
        failures.append("the promoted repeat's tokens are not the warm "
                        "wave's")
    calls = final["prefills"] + final["decode_steps"] + final["verify_steps"]
    if final["decode_graph_steps"] or final["prefill_graph_steps"]:
        failures.append(f"a tp rank replayed a graph: {final}")
    want = {"decode_attention": 0, "decode_attention_quant": 0,
            "paged_decode_attention": cfg.n_layers * final["decode_steps"],
            "rmsnorm": (2 * cfg.n_layers + 1) * calls}
    for r, rs in enumerate(ranks):
        if rs["launches"] != want:
            failures.append(f"rank {r} launches {rs['launches']} != {want}")
    for name, row in (("to_replica", to_replica), ("to_group", to_group)):
        if row["sent"] != row["blocks"] - row["resident"] or \
                row["import"]["imported"] != row["sent"] or \
                row["decode_hits"] < row["blocks"] * BLOCK_SIZE:
            failures.append(f"handoff {name}: {row}")
    diff = export_witness(cfg, params, z, exports)
    del exports
    for k in ("group_vs_replica", "group_vs_float32"):
        if not diff["worst"][k] <= TPT_EXPORT_MARGIN:
            failures.append(f"the group's export left the other's ({k}): "
                            f"{diff['worst']}")
    # The repeat's tokens are the warm wave's (held above): two waves.
    checks = {w: [check_against_recompute(cfg, params, p, t)
                  for p, t in zip(prompts, waves[w]["tokens"])]
              for w in ("first", "repeat")}
    for row, p in ((to_replica, x), (to_group, y)):
        row["recompute_check"] = check_against_recompute(
            cfg, params, p, row.pop("tokens"))
    tier_ms = ranks[0]["tier_ms"]
    out = {"flags": list(flags), "start_s": start_s, "pumps": pumps,
           "waves": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                     for k, v in waves.items()},
           "ms_per_block": {
               "demotion": per_block_ms(tier_ms.get("_pump_demotions", [])),
               "promotion": per_block_ms(tier_ms.get("_promote_from_tiers",
                                                     [])),
               "export": per_block_ms(tier_ms.get("export_kv_blocks", [])),
               "import": per_block_ms(tier_ms.get("import_kv_blocks", []))},
           "tier_ms": tier_ms, "plans": plans, "block_plans": blocks,
           "follower_replayed": replayed, "device_calls": calls,
           "handoffs": {"to_replica": to_replica, "to_group": to_group},
           "export": diff, "engine": final,
           "replica_engine": replica_stats,
           "decode_step_ms": 1e3 * final["decode_s"] / final["decode_steps"],
           "peak_memory_gb": [rs["peak_memory_gb"] for rs in ranks],
           "recompute_check": {
               w: {"tokens": sum(c["tokens"] for c in cs),
                   "argmax_agree": sum(c["argmax_agree"] for c in cs),
                   "gap_over_margin": [c["max_gap"] / c["margin"]
                                       for c in cs]}
               for w, cs in checks.items()},
           "launches": {k: sum(rs["launches"][k] for rs in ranks)
                        + replica_launches[k] for k in want},
           "card": smi}
    print(f"serve_tp_tiers [{smi}]: " + json.dumps(
        {k: out[k] for k in ("start_s", "pumps", "waves", "ms_per_block",
                             "plans", "follower_replayed", "handoffs",
                             "decode_step_ms", "peak_memory_gb",
                             "recompute_check")})
          + "; export " + json.dumps(
              {k: v for k, v in diff.items() if k != "layer_ratio"}),
          flush=True)
    if failures:
        raise AssertionError(f"serve_tp_tiers: {failures}")
    del replica
    torch.cuda.empty_cache()
    return out


# Pipeline parallelism (pipeline_phase): llama_1b's 16 layers at full
# width as two stages of 8, one process a stage sharing this card over
# gloo (the hops staged through pinned host memory), B 4 x S 2048 in 4
# microbatches of 1, bf16; a warm-up step, then the timed and counted one.
# Each rank then applies all 16 layers microbatch by microbatch in its own
# process (the reference): the output bit for bit, its stage's gradients
# of (out.float() ** 2).sum() within PP_GRAD_NORM of the reference's in
# norm, leaf by leaf.
PP_STAGES, PP_MICRO, PP_B, PP_S = 2, 4, 4, 2048
PP_GRAD_NORM = 2 ** -7
PP_RANK = (
    "import json, sys, time, torch, torch.distributed as dist\n"
    "from kuberay_tpu_torch.models import llama\n"
    "from kuberay_tpu_torch.ops import launches as counters\n"
    "from kuberay_tpu_torch.ops.rope import rope_frequencies\n"
    "from kuberay_tpu_torch.parallel import spmd\n"
    "from kuberay_tpu_torch.parallel.mesh import MeshSpec\n"
    "from kuberay_tpu_torch.parallel.pipeline import pipeline_apply\n"
    "rank, world, port, n_micro, B, S = (int(a) for a in sys.argv[1:7])\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.cuda.set_device(0)\n"
    "dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',\n"
    "                        rank=rank, world_size=world)\n"
    "mesh = MeshSpec(pp=world, fsdp=1).build('cuda')\n"
    "cfg = llama.CONFIGS['llama_1b']\n"
    "params = llama.init_params(\n"
    "    cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')\n"
    "tokens = torch.randint(0, cfg.vocab_size, (B, S), device='cuda',\n"
    "    generator=torch.Generator(device='cuda').manual_seed(1))\n"
    "with torch.no_grad():\n"
    "    x = params['embed'][tokens]\n"
    "cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta, 'cuda')\n"
    "def layer(h, lp):\n"
    "    return llama._layer(cfg, h, lp, cos, sin)\n"
    "def fresh():\n"
    "    return {k: v.detach().clone().requires_grad_(True)\n"
    "            for k, v in params['layers'].items()}\n"
    "def step(stack):\n"
    "    out = pipeline_apply(layer, stack, x, mesh, n_microbatches=n_micro)\n"
    "    (out.float() ** 2).sum().backward()\n"
    "    return out.detach()\n"
    "step(fresh())\n"
    "stack = fresh()\n"
    "torch.cuda.synchronize()\n"
    "counters.clear()\n"
    "t0 = time.perf_counter()\n"
    "out = step(stack)\n"
    "torch.cuda.synchronize()\n"
    "step_ms = (time.perf_counter() - t0) * 1e3\n"
    "launches = counters.snapshot('flash_fwd', 'flash_bwd_dkv',\n"
    "    'flash_bwd_dq', 'rmsnorm', 'rmsnorm_bwd', 'rmsnorm_bwd_dw')\n"
    "dist.barrier()\n"
    "ref_stack, outs = fresh(), []\n"
    "mb = B // n_micro\n"
    "for m in range(n_micro):\n"
    "    h = x[m * mb:(m + 1) * mb]\n"
    "    for i in range(cfg.n_layers):\n"
    "        h = layer(h, {k: v[i] for k, v in ref_stack.items()})\n"
    "    outs.append(h)\n"
    "ref = torch.cat(outs)\n"
    "(ref.float() ** 2).sum().backward()\n"
    "per = cfg.n_layers // world\n"
    "rows = slice(rank * per, (rank + 1) * per)\n"
    "grad_rel = {k: ((stack[k].grad[rows].float() - ref_stack[k].grad[rows]\n"
    "                 .float()).norm() / ref_stack[k].grad[rows].float()\n"
    "                 .norm()).item() for k in stack}\n"
    "others_zero = all(not bool(torch.cat([stack[k].grad[:rows.start],\n"
    "    stack[k].grad[rows.stop:]]).any()) for k in stack)\n"
    "print('rank result ' + json.dumps({\n"
    "    'rank': rank, 'step_ms': step_ms, 'launches': launches,\n"
    "    **counters.snapshot('rmsnorm_bwd_g_copies'),\n"
    "    'out_bits_equal': bool(torch.equal(out, ref)),\n"
    "    'out_finite': bool(torch.isfinite(out).all()),\n"
    "    'out_max_abs_diff': (out.float() - ref.float()).abs().max().item(),\n"
    "    'grad_rel': grad_rel, 'other_stage_grads_zero': others_zero,\n"
    "    'staged': spmd.layout_of(mesh).host_staged,\n"
    "    'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9}),\n"
    "    flush=True)\n"
    "dist.destroy_process_group()\n")


def pipeline_phase(smi: str) -> dict:
    """``parallel/pipeline.py::pipeline_apply`` on this card: llama_1b's
    layers (``llama._layer``) at full width and depth as PP_STAGES stages
    of 8, one process a stage over gloo, B PP_B x S PP_S in PP_MICRO
    microbatches, bf16, forward and backward of (out.float() ** 2).sum().
    Each rank: its output bit for bit the same layers applied microbatch
    by microbatch in one process, its stage's gradients within
    PP_GRAD_NORM in norm of that run's (the other stage's rows zero), and
    per step 2 x 4 = 8 layer-microbatches' flash forwards, dK/dV and dQ
    each, and two RMSNorms each.  Prints the launches and step ms."""
    torch.cuda.empty_cache()
    port = free_port()
    clean = {k: v for k, v in os.environ.items()
             if not k.startswith(("TPU_", "MEGASCALE_"))}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", PP_RANK, str(r), str(PP_STAGES), str(port),
         str(PP_MICRO), str(PP_B), str(PP_S)], cwd=ROOT,
        env={**clean, "PYTHONPATH": str(ROOT)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(PP_STAGES)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    wall_s = time.perf_counter() - t0
    ranks = []
    for p, out in zip(procs, outs):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("rank result ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"pipeline rank rc {p.returncode}:\n"
                                 f"{out[-6000:]}")
        ranks.append(json.loads(lines[-1][len("rank result "):]))
    per = llama.CONFIGS["llama_1b"].n_layers // PP_STAGES * PP_MICRO
    want = {"flash_fwd": per, "flash_bwd_dkv": per, "flash_bwd_dq": per,
            "rmsnorm": 2 * per, "rmsnorm_bwd": 2 * per,
            "rmsnorm_bwd_dw": 2 * per}
    run = {"stages": PP_STAGES, "microbatches": PP_MICRO,
           "shape": [PP_B, PP_S], "wall_s": wall_s, "ranks": ranks,
           "launches_per_rank": want,
           "launches": {k: sum(r["launches"][k] for r in ranks)
                        for k in want},
           "card": smi}
    print(f"pipeline [{smi}]: " + json.dumps(run), flush=True)
    bad = [r["rank"] for r in ranks
           if r["launches"] != want or not r["out_bits_equal"]
           or not r["out_finite"] or not r["other_stage_grads_zero"]
           or not r["staged"]
           or not max(r["grad_rel"].values()) <= PP_GRAD_NORM]
    if bad:
        raise AssertionError(f"pipeline: ranks {bad} failed: {run}")
    return run


def bench_profile(smi: str) -> dict:
    """``python -m kuberay_tpu_torch.bench --profile-out PATH`` as a
    process: its stdout line has the bench's keys, and the document is
    ``tpu-profile/v1`` with one ``train`` record a timed step, each
    holding ``dispatch`` and ``host-fetch``, and the bench's meta; its
    launches exactly the launcher's a step."""
    path = Path(tempfile.mkdtemp(prefix="bench-profile-")) / "profile.json"
    line, counts, wall_s, stderr = run_bench(["--profile-out", str(path)],
                                             "bench --profile-out")
    doc = json.loads(path.read_text())
    shutil.rmtree(path.parent, ignore_errors=True)
    d = line["detail"]
    train = doc.get("shapes", {}).get("train", {})
    kinds = train.get("kinds", {})
    run = {"line": line, "wall_s": wall_s, "meta": doc.get("meta"),
           "traces": train.get("traces"),
           "kinds": {k: {kk: v[kk] for kk in ("count", "mean_s", "p50_s",
                                              "fraction")}
                     for k, v in kinds.items()},
           "step_ms": d["batch"] * d["seq"] / line["value"] * 1e3,
           "launches": counts, "card": smi}
    print(f"bench_profile: {json.dumps(run)}", flush=True)
    meta_want = {"source": "kuberay_tpu_torch.bench", "model": "llama_1b",
                 "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": d["steps"],
                 "device": torch.cuda.get_device_name(0)}
    if set(line) != BENCH_KEYS or set(d) != BENCH_DETAIL_KEYS or \
            doc.get("schema") != "tpu-profile/v1" or \
            doc.get("meta") != meta_want or train.get("traces") != d["steps"] \
            or set(kinds) != {"dispatch", "host-fetch"} or \
            any(k["count"] != d["steps"] for k in kinds.values()) or \
            f"profile -> {path}" not in stderr:
        raise AssertionError(f"bench --profile-out: {run}")
    return run


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

    smoke_t0 = time.perf_counter()
    walls = {}

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            walls[name] = time.perf_counter() - t

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    walls["build"] = build_s
    print(f"built {[p.name for p in libs]} in {build_s:.2f} s", flush=True)
    hopper = hopper_resources(libs)
    print(f"hopper attention kernels (ptxas): {json.dumps(hopper)}",
          flush=True)
    decode_res = decode_resources(libs)
    print(f"decode kernels (ptxas): {json.dumps(decode_res)}", flush=True)
    rms_res = rms_resources(libs)
    print(f"rmsnorm forward kernels (ptxas): {json.dumps(rms_res)}",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rms = timed("check_rmsnorm", check_rmsnorm, gen, rms_res)
    dec = timed("check_decode", check_decode, gen)
    decq = timed("check_decode_quant", check_decode_quant, gen)
    paged = timed("check_paged", check_paged, gen)
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
    flash = timed("check_flash", check_flash, gen)
    xe = timed("check_xent", check_xent, gen)
    ring = timed("check_ring", check_ring, gen)
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
    srv = timed("serve", serve, cfg, params)
    cached = {"serve_paged": timed("serve_paged", serve_cached, cfg, params,
                                   "none", paged=True),
              "serve_int8_paged": timed("serve_int8_paged", serve_cached,
                                        cfg, params, "int8", paged=True),
              "serve_int8_dense": timed("serve_int8_dense", serve_cached,
                                        cfg, params, "int8", paged=False)}
    for name, run in {"serve": srv, **cached}.items():
        print(f"{name}: " + json.dumps(
            {k: v for k, v in run.items()
             if k not in ("engine", "engine_after_batch", "tokens")}),
            flush=True)
    options = timed("serve_options", serve_options, cfg, params, smi)
    options["serve_surface"] = timed("serve_surface", serve_surface, cfg,
                                     params, smi)
    options["serve_tiers"] = timed("serve_tiers", serve_tiers, cfg, params,
                                   smi)
    options["serve_disagg"] = timed("serve_disagg", serve_disagg, cfg,
                                    params, smi)
    prof = timed("profile", profile_phase, cfg, params, smi)
    stp = timed("serve_tp", serve_tp, cfg, params, smi, srv, decode_res)
    stt = timed("serve_tp_tiers", serve_tp_tiers, cfg, params, smi)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    moe_serve = timed("mixtral_serve", mixtral_serve, smi)
    options.update({k: v for k, v in moe_serve.items()
                    if k.startswith("mixtral_")})
    moe_train = timed("mixtral_train", mixtral_train, smi)
    trn = timed("train", train, profile=args.profile)
    print(f"train: {json.dumps(trn)}", flush=True)
    steady_ms = trn["launcher"]["step_ms_median_steady"]
    bnch = timed("bench", bench, steady_ms, smi)
    trn_ring = timed("train_ring", train_ring, profile=args.profile)
    handoff = timed("train_to_serve", train_to_serve, smi, steady_ms)
    ent = timed("entry", entry_phase, smi)
    mesh = timed("mesh_train", mesh_train, smi)
    pipe = timed("pipeline", pipeline_phase, smi)
    bprof = timed("bench_profile", bench_profile, smi)
    mesh_launches = {}
    for run in mesh["runs"].values():
        for rank in run["launches"]:
            for k, n in rank.items():
                mesh_launches[k] = mesh_launches.get(k, 0) + n
    by_path = {"serve": srv["launches"],
               **{name: run["launches"] for name, run in cached.items()},
               **{name: run["launches"] for name, run in options.items()},
               "mixtral_train": moe_train["launches"],
               "train": trn["launcher"]["launches"],
               "bench": bnch["launches"],
               "bench_profile": bprof["launches"],
               "train_ring": trn_ring["launches"],
               "train_ckpt": handoff["launcher"]["launches"],
               "serve_ckpt": handoff["server"]["launches"],
               "profile": prof["launches"], "entry": ent["launches"],
               "mesh_train": mesh_launches, "serve_tp": stp["launches"],
               "serve_tp_tiers": stt["launches"],
               "pipeline": pipe["launches"]}

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
                **({"graph_ms": m["graph_ms"],
                    "library_graph_ms": m["library_graph_ms"]}
                   if name.startswith("rmsnorm") else {}),
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
        entry("rmsnorm", "cuda", "kuberay_tpu_torch/csrc/rmsnorm.cu",
              "kuberay_tpu/ops/rmsnorm.py:27", rms),
        entry("rmsnorm_bwd", "triton", "kuberay_tpu_torch/ops/rmsnorm.py",
              "kuberay_tpu/ops/rmsnorm.py:90", rms["bwd"]),
        entry("rmsnorm_bwd_dw", "triton", "kuberay_tpu_torch/ops/rmsnorm.py",
              "kuberay_tpu/ops/rmsnorm.py:90", rms["dw_sum"]),
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
        "decode_resources": decode_res, "rmsnorm_resources": rms_res,
        "build_log": {p.name: p.with_suffix(".log").read_text()
                      for p in libs},
        "rmsnorm": rms, "decode_attention": dec,
        "decode_attention_quant": decq, "paged_decode_attention": paged,
        "flash": flash, "chunked_xent": xe, "ring": ring, "serve": srv,
        **cached, **options, "mixtral_serve_setup": {
            k: v for k, v in moe_serve.items() if not k.startswith(
                "mixtral_")}, "mixtral_train": moe_train,
        "train": trn, "train_ring": trn_ring,
        "train_to_serve": handoff, "bench": bnch, "entry": ent,
        "mesh_train": mesh, "profile": prof, "serve_tp": stp,
        "serve_tp_tiers": stt, "pipeline": pipe, "bench_profile": bprof,
        "walls_s": walls,
        **kernels}, indent=1))
    walls["total"] = time.perf_counter() - smoke_t0
    print("wall seconds: " + json.dumps(
        {k: round(v, 2) for k, v in walls.items()}), flush=True)
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
