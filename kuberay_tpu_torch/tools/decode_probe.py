"""Where the split decode kernels' time goes, on one card.

At ``chip_smoke.py``'s serving shape (8 slots, cache length 2048, 32 q / 8
kv heads of 128, block size 16 for the paged pool, lens 0..2048 with 5242
live positions), this prints, in ms of device time from a CUDA graph
(100 calls captured, four cache copies cycled so each call finds its
cache cold in L2):

- the bf16, int8 and paged kernels at chunks of 64, 128, 256 and 512
  positions (the wrappers use ``decode_attention.CHUNK``), beside SDPA
  over the same bf16 cache;
- the three kernels at the default chunk with every lens 0 (the fixed
  cost of a call: two launches, the empty splits, the merge), with the
  main lens and with every slot full;
- the merge kernel alone, and one trivial kernel (a graph's floor);
- each wrapper's host enqueue time a call (the host's clock around 200
  calls).

With ``--serve-ab PARENT``, it then runs, in the tree at PARENT and in
this one, in turns (parent, this, this, parent), each round in its own
process: the decode checks' main shapes (``chip_smoke.py``); the host
time of 32 bf16 decode calls enqueued behind 20 ms of matmuls (a call
that waited for the device would show it); 30 decode steps of the dense
bf16 and int8 engines called directly, 8 slots of 7-1500 positions; and
``chip_smoke.py``'s four serve phases over HTTP.  It prints each round's
kernel times and step times.

    python3 -m kuberay_tpu_torch.tools.decode_probe [--serve-ab DIR]

Needs a CUDA device; builds the decode kernels at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from kuberay_tpu_torch.ops import decode_attention as da
from kuberay_tpu_torch.ops import paged_attention as pa
from kuberay_tpu_torch.serve.kv_cache import quantize_kv

S, M, HQ, HKV, D, BS = 8, 2048, 32, 8, 128, 16
LENS = {"zero": [0] * S, "main": [0, 1, 17, 1000, 2048, 2047, 64, 65],
        "full": [M] * S}
CHUNKS = (64, 128, 256, 512)
ROOT = Path(__file__).resolve().parents[2]


def graph_ms(fn, iters: int = 100) -> float:
    """Mean device time of one call: ``iters`` calls in one CUDA graph,
    replayed between CUDA events."""
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


def host_ms(fn, iters: int = 200) -> float:
    """Host time of one call's enqueue: the host's clock around ``iters``
    calls, no synchronisation inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return t


def launch(kind: str, chunk: int, q, lens, kv, tables=None) -> torch.Tensor:
    """One call of a decode kernel's C entry point at ``chunk`` (the
    wrappers' launch with another split plan)."""
    cap = tables.shape[1] * BS if kind == "paged" else M
    n = da.split_plan(cap, chunk)
    out = torch.empty_like(q)
    ws = torch.empty(da.workspace_numel(S, HQ, D, n), device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    tail = (HQ, HKV, D, chunk, n, da._scale(D, None), stream)
    ptrs = [t.data_ptr() for t in kv]
    if kind == "bf16":
        err = da._fn("decode_attention_bf16")(
            q.data_ptr(), *ptrs, lens.data_ptr(), out.data_ptr(),
            ws.data_ptr(), S, M, *tail)
    elif kind == "int8":
        err = da._fn("decode_attention_int8")(
            q.data_ptr(), *ptrs, lens.data_ptr(), out.data_ptr(),
            ws.data_ptr(), S, M, *tail)
    else:
        err = pa._fn("paged_decode_attention_bf16")(
            q.data_ptr(), *ptrs, tables.data_ptr(), lens.data_ptr(),
            out.data_ptr(), ws.data_ptr(), S, kv[0].shape[1],
            tables.shape[1], BS, *tail)
    if err:
        raise RuntimeError(f"{kind} chunk {chunk}: cudaError {err}")
    return out


def kernel_probe() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(S, HQ, D, generator=gen, device="cuda").bfloat16()
    dense = [tuple(torch.randn(S, M, HKV, D, generator=gen, device="cuda"
                               ).bfloat16() for _ in range(2))
             for _ in range(4)]
    int8 = []
    for _ in range(4):
        parts = []
        for _ in range(2):
            x8, s = quantize_kv(torch.randn(S, M, HKV, D, generator=gen,
                                            device="cuda"))
            parts += [x8, s[..., 0].transpose(1, 2).contiguous()]
        int8.append(tuple(parts))             # kq, ks, vq, vs
    nblk = S * M // BS
    perm = torch.randperm(nblk, generator=gen, device="cuda")
    tables = perm.reshape(S, M // BS).int().contiguous()
    pools = [tuple(torch.randn(HKV, nblk * BS, D, generator=gen,
                               device="cuda").bfloat16() for _ in range(2))
             for _ in range(4)]
    copies = {"bf16": dense, "int8": int8, "paged": pools}
    it = iter(range(1 << 30))

    def timed(kind, chunk, lens):
        return graph_ms(lambda: launch(kind, chunk, q, lens,
                                       copies[kind][next(it) % 4], tables))

    out = {"chunk": da.CHUNK, "by_chunk": {}, "by_lens": {}}
    main = torch.tensor(LENS["main"], dtype=torch.int32, device="cuda")
    for kind in copies:                       # a first check, untimed
        got = launch(kind, da.CHUNK, q, main, copies[kind][0], tables)
        if kind == "bf16":
            want = da.decode_attention(q, *dense[0], main)
        elif kind == "int8":
            want = da.decode_attention_quant(q, *int8[0], main)
        else:
            want = pa.paged_decode_attention(q, *pools[0], main, tables, BS)
        if not torch.equal(got, want):
            raise AssertionError(f"{kind}: the probe's launch differs from "
                                 f"the wrapper's")
    for chunk in CHUNKS:
        out["by_chunk"][chunk] = {k: timed(k, chunk, main) for k in copies}
        print(f"chunk {chunk}: {json.dumps(out['by_chunk'][chunk])}",
              flush=True)
    for name, lens in LENS.items():
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        mask = (torch.arange(M, device="cuda")[None, :] < lt[:, None]
                )[:, None, None, :]
        rec = {k: timed(k, da.CHUNK, lt) for k in copies}
        rec["sdpa"] = graph_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], *(t.transpose(1, 2)
                             for t in dense[next(it) % 4]),
            attn_mask=mask, enable_gqa=True))
        out["by_lens"][name] = rec
        print(f"lens {name}: {json.dumps(rec)}", flush=True)
    out["host_ms"] = {
        "bf16": host_ms(lambda: da.decode_attention(q, *dense[0], main)),
        "int8": host_ms(lambda: da.decode_attention_quant(q, *int8[0], main)),
        "paged": host_ms(lambda: pa.paged_decode_attention(q, *pools[0], main,
                                                           tables, BS))}
    print(f"host enqueue a call: {json.dumps(out['host_ms'])}", flush=True)
    n = da.split_plan(M)
    acc, m, l = da.split_partials_ref(q, *dense[0], main)
    ws = da.pack_partials(acc, m, l)
    out["merge"] = graph_ms(lambda: da.merge_partials(ws, S, HQ, D, n))
    x = torch.zeros(1, device="cuda")
    out["trivial_kernel"] = graph_ms(lambda: x.add_(1))
    print(f"merge {out['merge']}, trivial kernel {out['trivial_kernel']}",
          flush=True)
    return out


# One round of the A/B: run from a tree's root, with that tree's
# chip_smoke.py.
ROUND = r'''
import json, time
import numpy as np
import torch
import chip_smoke as cs
from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.serve.engine import ServeEngine
gen = torch.Generator(device="cuda").manual_seed(0)
out = {}
for name, fn in (("decode", cs.check_decode), ("int8", cs.check_decode_quant),
                 ("paged", cs.check_paged)):
    m = fn(gen)["main"]
    out[name] = {k: m[k] for k in ("ms", "host_ms", "graph_ms",
                                   "library_graph_ms", "bound_ms")}
cfg = llama.CONFIGS["llama3_8b"]
params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
# Behind 20 ms of queued matmuls, the host time of 32 decode calls (one
# step's worth): the enqueue alone unless a call waits for the device.
from kuberay_tpu_torch.ops import decode_attention as da
q = torch.randn(8, 32, 128, device="cuda").bfloat16()
ck, cv = (torch.randn(8, 2048, 8, 128, device="cuda").bfloat16()
          for _ in range(2))
lt = torch.tensor([0, 1, 17, 1000, 2048, 2047, 64, 65], dtype=torch.int32,
                  device="cuda")
a = torch.randn(8192, 8192, device="cuda").bfloat16()
da.decode_attention(q, ck, cv, lt)
t = []
for _ in range(5):
    torch.cuda.synchronize()
    for _ in range(20):
        a @ a
    t0 = time.perf_counter()
    for _ in range(32):
        da.decode_attention(q, ck, cv, lt)
    t.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
out["host_32_calls_behind_matmuls_ms"] = sorted(t)
del a, ck, cv
# One dense engine's decode step called directly (no HTTP), 8 slots at the
# smoke's prompt lengths: 30 steps after 3 warm-up steps.
for kvq in ("none", "int8"):
    eng = ServeEngine(cfg, params, max_slots=8, max_len=2048, device="cuda",
                      kv_quant=kvq)
    eng.lens[:] = [7, 33, 64, 200, 511, 900, 1024, 1500]
    last = np.zeros(8, np.int64)
    temps = np.zeros((8, 3), np.float32)
    temps[:, 1] = 1.0
    mask = np.ones(8, np.float32)
    for _ in range(3):
        eng._decode_call(last, temps, mask)
    ts = []
    for _ in range(30):
        t0 = time.perf_counter()
        eng._decode_call(last, temps, mask)
        ts.append((time.perf_counter() - t0) * 1e3)
    out[f"direct_step_{kvq}_ms"] = sorted(ts)
    del eng
    torch.cuda.empty_cache()
runs = {"serve": cs.serve(cfg, params),
        "serve_paged": cs.serve_cached(cfg, params, "none", paged=True),
        "serve_int8_paged": cs.serve_cached(cfg, params, "int8", paged=True),
        "serve_int8_dense": cs.serve_cached(cfg, params, "int8", paged=False)}
for k, r in runs.items():
    out[k] = {"decode_step_ms": r["decode_step_ms"],
              "decode_steps": r["engine"]["decode_steps"],
              "decode_tokens_per_s": r["decode_tokens_per_s"]}
print("ROUND " + json.dumps(out), flush=True)
'''


def serve_ab(parent: Path) -> list:
    rounds = []
    for tag, tree in (("parent", parent), ("this", ROOT), ("this", ROOT),
                      ("parent", parent)):
        p = subprocess.run([sys.executable, "-c", ROUND], cwd=tree,
                           env={**os.environ, "PYTHONPATH": str(tree)},
                           capture_output=True, text=True, timeout=900)
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("ROUND ")]
        if p.returncode or not line:
            raise RuntimeError(f"{tag} round failed ({p.returncode}): "
                               f"{p.stderr[-3000:]}")
        rounds.append({"tree": tag, **json.loads(line[-1][6:])})
        print(f"{tag}: {json.dumps(rounds[-1])}", flush=True)
    return rounds


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve-ab", type=Path, default=None,
                    help="the root of the parent tree to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    res = {"kernels": kernel_probe()}
    if args.serve_ab is not None:
        res["serve_ab"] = serve_ab(args.serve_ab.resolve())
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_probe.json").write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
