#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile]

1. Device: requires a CUDA device (exits non-zero without one) and prints
   its name and power limit.
2. Kernels: builds every kernel from the sources in this checkout, runs each
   kernel's wrapper at the Llama-3-8B shapes the serving path gives it, and
   holds the result against the plain PyTorch version on the same inputs
   (bf16: RMSNorm atol 1.6e-2, one bf16 ulp for |y| < 4; decode attention
   atol 2e-2).  Times kernel, plain version and one PyTorch library call
   (yardstick only) with CUDA events, eagerly and replayed from a CUDA
   graph (device time without the host's launch cost), and computes each
   kernel's bound.
   The three flash-attention kernels of the training path likewise, at
   llama_1b's shape (B 4, S 2048, 16 q / 8 kv heads of 128, causal), the
   Llama-3-8B head layout (32 / 8) at S 1024, a ragged S (1000), Skv > Sq
   and D 64 with group 1 (llama_125m): out and lse (atol 1e-4) of the
   forward, and dQ/dK/dV for a seeded dO, against the plain versions, each
   bf16 element within one ulp of its own value plus 2^-5 of its row's
   RMS, and each tensor within 2^-7 in norm; SDPA forward, ATen's flash
   backward (the yardstick of the dK/dV + dQ pair) and SDPA
   forward+backward times as yardsticks.  Chunked cross entropy at
   llama3_8b's head (T 2048, d 4096, V 128256, chunk 16384, bf16): loss,
   dx and dhead against the dense loss.
3. Serve: builds llama3_8b at full width (seeded random bf16 weights),
   starts ServeEngine(max_slots=8, max_len=2048) behind ServeFrontend on
   127.0.0.1, POSTs 8 concurrent greedy /v1/completions and then a repeat
   of the first prompt.  Checks every response, the repeat's tokens, and
   that both kernels' launch counts over this phase are exactly
   65 RMSNorms per forward and 32 decode attentions per decode step.
   Then checks the served tokens of the first request against a
   full-recompute (no-cache) forward of the same sequence.
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
5. Prints the kernels' JSON line, and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Details go to chiprun_out/chip_smoke.json beside this script.  Any failure
raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
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
from kuberay_tpu_torch.ops import rmsnorm as rn
from kuberay_tpu_torch.ops import xent
from kuberay_tpu_torch.train import launcher
from kuberay_tpu_torch.train import train_step as ts
from kuberay_tpu_torch.serve.engine import ServeEngine
from kuberay_tpu_torch.serve.kv_cache import forward_with_cache, init_kv_cache
from kuberay_tpu_torch.serve.server import ServeFrontend

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
RMS_ATOL = 1.6e-2
DECODE_ATOL = 2e-2
# Flash kernels vs plain, element by element against the element's own
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
# sides (measured 1e-6).
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


def timings(kernel, plain, library, iters: int, plain_iters: int) -> dict:
    """Eager times (CUDA events around back-to-back calls, what the eager
    paths pay, host launch cost included) and CUDA-graph times (device
    work alone) of a kernel, its plain version and the library call
    (None where no one PyTorch call computes the same function)."""
    return {"ms": cuda_ms(kernel, iters), "graph_ms": graph_ms(kernel, iters),
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


def check_decode(gen: torch.Generator) -> dict:
    """Decode attention at the 8B decode shape, and at a cache length (1000)
    that no 64-row tile divides."""
    shapes = []
    for M, lens in ((MAX_LEN, [0, 1, 17, 100, 1023, 1025, 2047, 2048]),
                    (1000, [0, 1, 63, 64, 65, 500, 999, 1000])):
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(SLOTS, HQ, HD, generator=gen, device="cuda").bfloat16()
        # Four cache copies, cycled, so timed launches find the cache cold
        # in L2 as each layer's does on the serving path.
        caches = [(torch.randn(SLOTS, M, HKV, HD, generator=gen,
                               device="cuda").bfloat16(),
                   torch.randn(SLOTS, M, HKV, HD, generator=gen,
                               device="cuda").bfloat16()) for _ in range(4)]
        ck, cv = caches[0]
        out = da.decode_attention(q, ck, cv, lens_t)
        err = max_err(out, da.decode_attention_ref(q, ck, cv, lens_t))
        if not err <= DECODE_ATOL:
            raise AssertionError(f"decode M={M} lens={lens}: max abs err "
                                 f"{err} > {DECODE_ATOL}")
        if out[0].abs().max().item() != 0.0:
            raise AssertionError("decode: a lens=0 slot must give 0")
        mask = (torch.arange(M, device="cuda")[None, :] < lens_t[:, None]
                )[:, None, None, :]
        it = iter(range(1 << 30))

        def run(fn):
            return lambda: fn(*caches[next(it) % 4])

        live = int(sum(lens))
        nbytes = (2 * live * HKV * HD * 2 + 2 * q.numel() * 2
                  + lens_t.numel() * 4)
        flops = 4 * live * HQ * HD
        shapes.append({
            "max_len": M, "lens": lens, "max_abs_err": err,
            **timings(
                run(lambda k, v: da.decode_attention(q, k, v, lens_t)),
                run(lambda k, v: da.decode_attention_ref(q, k, v, lens_t)),
                run(lambda k, v: F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)), 100, 20),
            **bound(nbytes, flops)})
        print(f"decode M={M}: {json.dumps(shapes[-1])}", flush=True)
    return {"shapes": shapes, "main": shapes[0]}


# (name, B, Sq, Skv, Hq, Hkv, D); the first is the training path's shape.
FLASH_SHAPES = (("llama_1b", 4, 2048, 2048, 16, 8, 128),
                ("llama3_8b_heads", 1, 1024, 1024, 32, 8, 128),
                ("ragged", 2, 1000, 1000, 16, 8, 128),
                ("offset", 1, 512, 1536, 16, 8, 128),
                ("d64_group1", 2, 1024, 1024, 12, 12, 64))


def visible_pairs(B, Sq, Skv, Hq, causal=True) -> int:
    """(query, key) pairs the causal mask lets through, over batch and
    heads: the work this run's inputs need."""
    off = Skv - Sq
    row = (sum(min(Skv, max(0, r + off + 1)) for r in range(Sq)) if causal
           else Sq * Skv)
    return B * Hq * row


def check_flash(gen: torch.Generator) -> dict:
    """The forward, dK/dV and dQ kernels against their plain versions on
    every shape of FLASH_SHAPES (the backward's plain versions get the
    kernel's own out/lse, so each kernel is checked alone); times at the
    llama_1b shape."""
    errs = {"flash_fwd": [], "flash_bwd_dkv": [], "flash_bwd_dq": []}
    shapes, timed = [], {}
    for name, B, Sq, Skv, Hq, Hkv, D in FLASH_SHAPES:
        q, do = (torch.randn(B, Sq, Hq, D, generator=gen, device="cuda"
                             ).bfloat16() for _ in range(2))
        k, v = (torch.randn(B, Skv, Hkv, D, generator=gen, device="cuda"
                            ).bfloat16() for _ in range(2))
        out, lse = fa.flash_fwd(q, k, v)
        delta = fa.attention_delta(out, do)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        rout, rlse = fa.flash_fwd_ref(q, k, v)
        rdk, rdv = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta)
        rdq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta)
        rec = {"shape": name, "B": B, "Sq": Sq, "Skv": Skv, "Hq": Hq,
               "Hkv": Hkv, "D": D, "lse_err": max_err(lse, rlse)}
        for g, r, key in ((out, rout, "out"), (dq, rdq, "dq"),
                          (dk, rdk, "dk"), (dv, rdv, "dv")):
            rec[key] = local_err(g, r)
        print(f"flash {name}: {json.dumps(rec)}", flush=True)
        if not (rec["lse_err"] <= FLASH_LSE_ATOL
                and all(rec[t]["worst"] <= 1.0
                        and rec[t]["norm_rel"] <= FLASH_NORM_TOL
                        for t in ("out", "dq", "dk", "dv"))):
            raise AssertionError(f"flash kernels disagree with the plain "
                                 f"versions at {name}: {rec}")
        errs["flash_fwd"].append(rec["out"]["max_abs_err"])
        errs["flash_bwd_dkv"].append(max(rec["dk"]["max_abs_err"],
                                         rec["dv"]["max_abs_err"]))
        errs["flash_bwd_dq"].append(rec["dq"]["max_abs_err"])
        shapes.append(rec)
        del rout, rlse, rdk, rdv, rdq
        torch.cuda.empty_cache()
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
        timed["flash_bwd_dkv"] = {
            **timings(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta),
                      lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta),
                      None, 20, 3),
            **bound(io_qkv + 2 * do.numel() + 2 * rows + 4 * k.numel(),
                    8 * pairs * D)}
        timed["flash_bwd_dq"] = {
            **timings(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta),
                      lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta),
                      None, 20, 3),
            **bound(io_qkv + 4 * do.numel() + 2 * rows, 6 * pairs * D)}
        # Yardstick of the dK/dV + dQ pair: one call of ATen's flash
        # backward (through autograd) on the same inputs and dO, with k/v
        # expanded to the q heads (its dK/dV are per q head; the group sum
        # is not in its time).
        qs, ks, vs = (t.detach().requires_grad_() for t in (qt, kt, vt))
        dot = do.transpose(1, 2).contiguous()
        kx, vx = (t.repeat_interleave(Hq // Hkv, dim=1).requires_grad_()
                  for t in (kt, vt))
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib_out = F.scaled_dot_product_attention(qs, kx, vx,
                                                     is_causal=True)
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qs, kx, vx), dot, retain_graph=True), 20)
        for kname in ("flash_bwd_dkv", "flash_bwd_dq"):
            timed[kname].update(library_ms=lib_bwd_ms, library_graph_ms=None,
                                library_of="flash_bwd_dkv + flash_bwd_dq")
        del lib_out, kx, vx
        # Yardsticks for the whole attention, forward and backward.
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
        "checks": shapes, "fwd_bwd": timed["fwd_bwd"]}


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


def post(url: str, body: dict, timeout: float = 600.0):
    req = urllib.request.Request(
        f"{url}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), json.load(resp)


def serve(seed: int = 0) -> dict:
    """llama3_8b at full width behind the HTTP frontend."""
    cfg = llama.CONFIGS["llama3_8b"]
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    engine = ServeEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                         device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    fe = ServeFrontend(engine)
    srv, url = fe.serve_background("127.0.0.1", 0)
    results, errors = {}, []

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
        repeat = post(url, {"prompt_tokens": prompts[0],
                            "max_tokens": MAX_TOKENS, "temperature": 0.0})
        launches = {"rmsnorm": rn.launches, "decode_attention": da.launches}
        stats = fe.stats()
    finally:
        srv.shutdown()
        srv.server_close()
        fe.close()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve requests failed: {errors}")
    for i, (status, headers, body) in sorted(results.items()):
        n = len(body["tokens"])
        if status != 200 or not (
                n == MAX_TOKENS or (body["finish_reason"] == "eos"
                                    and 0 < n <= MAX_TOKENS)):
            raise AssertionError(f"request {i}: status {status}, body {body}")
        if not headers.get("X-TPU-Queue-Depth", "").isdigit():
            raise AssertionError(f"request {i}: no load headers {headers}")
        if body["prompt_len"] != PROMPT_LENS[i] or \
                not all(0 <= t < cfg.vocab_size for t in body["tokens"]):
            raise AssertionError(f"request {i}: bad body {body}")
    if repeat[0] != 200 or repeat[2]["tokens"] != results[0][2]["tokens"]:
        raise AssertionError(f"repeat differs: {repeat[2]['tokens']} vs "
                             f"{results[0][2]['tokens']}")
    forwards = stats["prefills"] + stats["decode_steps"]
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * forwards,
            "decode_attention": cfg.n_layers * stats["decode_steps"]}
    if launches != want or stats["decode_steps"] == 0:
        raise AssertionError(f"kernel launches {launches} != expected {want} "
                             f"(stats {stats})")
    ref = check_against_recompute(cfg, params, prompts[0],
                                  results[0][2]["tokens"][:8])
    ttfts = [results[i][2]["ttft_ms"] for i in sorted(results)]
    out = {
        "model": "llama3_8b", "params": cfg.num_params(), "setup_s": setup_s,
        "batch_wall_s": batch_s, "ttft_ms": ttfts,
        "decode_tokens_per_s": stats["decode_tokens"] / stats["decode_s"],
        "decode_step_ms": 1e3 * stats["decode_s"] / stats["decode_steps"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "engine": stats, "recompute_check": ref,
        "repeat_tokens_equal": True,
    }
    del params, engine
    torch.cuda.empty_cache()
    return out


def check_against_recompute(cfg, params, prompt, served) -> dict:
    """Greedy tokens served through the cache (prefill + decode kernel)
    vs one no-cache forward of prompt + served tokens (multi-token plain
    attention): each served token must be the reference's argmax, or within
    a bf16-noise margin of its max logit."""
    seq = torch.tensor([prompt + served], device="cuda")
    T = seq.shape[1]
    cache = init_kv_cache(cfg, 1, T, "cuda")
    with torch.no_grad():
        logits, _ = forward_with_cache(cfg, params, seq, cache,
                                       torch.zeros(1, dtype=torch.long,
                                                   device="cuda"))
    rows = logits[0, len(prompt) - 1:T - 1]                 # predicts served
    if not torch.isfinite(rows).all():
        raise AssertionError("recompute logits are not finite")
    served_t = torch.tensor(served, device="cuda")
    gap = rows.max(-1).values - rows.gather(-1, served_t[:, None])[:, 0]
    margin = 0.05 * rows.abs().max().item()
    agree = int((rows.argmax(-1) == served_t).sum())
    if gap.max().item() > margin:
        raise AssertionError(f"served tokens are not the recompute's greedy "
                             f"choices: gaps {gap.tolist()} > {margin}")
    return {"tokens": len(served), "argmax_agree": agree,
            "max_gap": gap.max().item(), "margin": margin}


def reset_counts() -> None:
    rn.launches = da.launches = 0
    fa.fwd_launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0


def train_counts() -> dict:
    return {"flash_fwd": fa.fwd_launches,
            "flash_bwd_dkv": fa.bwd_dkv_launches,
            "flash_bwd_dq": fa.bwd_dq_launches, "rmsnorm": rn.launches}


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
                "rmsnorm": 2 * 2 * L + 1}          # full remat: fwd twice
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
                    help="profile one more fixed-batch training step")
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

    gen = torch.Generator(device="cuda").manual_seed(0)
    rms = check_rmsnorm(gen)
    dec = check_decode(gen)
    flash = check_flash(gen)
    xe = check_xent(gen)
    torch.cuda.empty_cache()
    srv = serve()
    print(f"serve: {json.dumps({k: v for k, v in srv.items() if k != 'engine'})}",
          flush=True)
    trn = train(profile=args.profile)
    print(f"train: {json.dumps(trn)}", flush=True)
    by_path = {"serve": srv["launches"], "train": trn["launcher"]["launches"]}

    def entry(name, route, source, replaces, res, launches):
        m = res["main"]
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches,
                "launches_by_path": {p: c[name] for p, c in by_path.items()
                                     if name in c},
                "max_abs_err": max(s["max_abs_err"] for s in res["shapes"]),
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"],
                **({"library_of": m["library_of"]} if "library_of" in m
                   else {})}

    kernels = {"kernels": [
        entry("rmsnorm", "triton", "kuberay_tpu_torch/ops/rmsnorm.py",
              "kuberay_tpu/ops/rmsnorm.py:27", rms,
              srv["launches"]["rmsnorm"]
              + trn["launcher"]["launches"]["rmsnorm"]),
        entry("decode_attention", "cuda",
              "kuberay_tpu_torch/csrc/decode_attention.cu",
              "kuberay_tpu/ops/decode_attention.py:150", dec,
              srv["launches"]["decode_attention"]),
        *(entry(name, "cuda", "kuberay_tpu_torch/csrc/flash_attention.cu",
                f"kuberay_tpu/ops/attention.py:{line}", flash[name],
                trn["launcher"]["launches"][name])
          for name, line in (("flash_fwd", 70), ("flash_bwd_dkv", 172),
                             ("flash_bwd_dq", 222))),
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": kind, "nvidia_smi": smi, "torch": torch.__version__,
        "build_s": build_s,
        "build_log": {p.name: p.with_suffix(".log").read_text()
                      for p in libs},
        "rmsnorm": rms, "decode_attention": dec, "flash": flash,
        "chunked_xent": xe, "serve": srv, "train": trn,
        **kernels}, indent=1))
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
