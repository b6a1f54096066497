#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

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
3. Serve: builds llama3_8b at full width (seeded random bf16 weights),
   starts ServeEngine(max_slots=8, max_len=2048) behind ServeFrontend on
   127.0.0.1, POSTs 8 concurrent greedy /v1/completions and then a repeat
   of the first prompt.  Checks every response, the repeat's tokens, and
   that both kernels' launch counts over this phase are exactly
   65 RMSNorms per forward and 32 decode attentions per decode step.
   Then checks the served tokens of the first request against a
   full-recompute (no-cache) forward of the same sequence.
4. Prints the kernels' JSON line, and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Details go to chiprun_out/chip_smoke.json beside this script.  Any failure
raises and exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.ops import _build
from kuberay_tpu_torch.ops import decode_attention as da
from kuberay_tpu_torch.ops import rmsnorm as rn
from kuberay_tpu_torch.serve.engine import ServeEngine
from kuberay_tpu_torch.serve.kv_cache import forward_with_cache, init_kv_cache
from kuberay_tpu_torch.serve.server import ServeFrontend

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
RMS_ATOL = 1.6e-2
DECODE_ATOL = 2e-2
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
    serving path pays, host launch cost included) and CUDA-graph times
    (device work alone) of a kernel, its plain version and the library
    call."""
    return {"ms": cuda_ms(kernel, iters), "graph_ms": graph_ms(kernel, iters),
            "plain_ms": cuda_ms(plain, plain_iters),
            "plain_graph_ms": graph_ms(plain, plain_iters),
            "library_ms": cuda_ms(library, iters),
            "library_graph_ms": graph_ms(library, iters)}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_rmsnorm(gen: torch.Generator) -> dict:
    """RMSNorm at decode (8 rows), ragged and prefill row counts."""
    shapes = []
    for rows in (1, 8, 300, 2048):
        # Uniform inputs keep |y| < 4, where one bf16 ulp is <= 1/64.
        x = (torch.rand(rows, D_MODEL, generator=gen, device="cuda") * 2 - 1
             ).bfloat16()
        w = (torch.rand(D_MODEL, generator=gen, device="cuda") + 0.5
             ).bfloat16()
        err = max_err(rn.rmsnorm(x, w), rn.rmsnorm_ref(x, w))
        if not err <= RMS_ATOL:
            raise AssertionError(f"rmsnorm rows={rows}: max abs err {err} "
                                 f"> {RMS_ATOL}")
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * 2
        flops = 4 * x.numel()
        shapes.append({
            "rows": rows, "max_abs_err": err,
            **timings(lambda: rn.rmsnorm(x, w),
                      lambda: rn.rmsnorm_ref(x, w),
                      lambda: F.rms_norm(x, (D_MODEL,), w, 1e-5), 200, 200),
            "bound_ms": max(nbytes / HBM_BYTES_S, flops / BF16_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_S >= flops / BF16_FLOPS
            else "operations"})
        print(f"rmsnorm rows={rows}: {json.dumps(shapes[-1])}", flush=True)
    return {"shapes": shapes, "main": next(s for s in shapes if s["rows"] == 8)}


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
            "bound_ms": max(nbytes / HBM_BYTES_S, flops / BF16_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_S >= flops / BF16_FLOPS
            else "operations"})
        print(f"decode M={M}: {json.dumps(shapes[-1])}", flush=True)
    return {"shapes": shapes, "main": shapes[0]}


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
        rn.launches = 0
        da.launches = 0
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


def main() -> None:
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
    srv = serve()
    print(f"serve: {json.dumps({k: v for k, v in srv.items() if k != 'engine'})}",
          flush=True)

    def entry(name, route, source, replaces, res, launches):
        m = res["main"]
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(s["max_abs_err"] for s in res["shapes"]),
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"]}

    kernels = {"kernels": [
        entry("rmsnorm", "triton", "kuberay_tpu_torch/ops/rmsnorm.py",
              "kuberay_tpu/ops/rmsnorm.py:27", rms,
              srv["launches"]["rmsnorm"]),
        entry("decode_attention", "cuda",
              "kuberay_tpu_torch/csrc/decode_attention.cu",
              "kuberay_tpu/ops/decode_attention.py:150", dec,
              srv["launches"]["decode_attention"]),
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": kind, "nvidia_smi": smi, "torch": torch.__version__,
        "build_s": build_s,
        "build_log": {p.name: p.with_suffix(".log").read_text()
                      for p in libs},
        "rmsnorm": rms, "decode_attention": dec, "serve": srv,
        **kernels}, indent=1))
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
