"""A/B of the llama_1b training step between this tree and another, on one
card.

    python3 -m kuberay_tpu_torch.tools.train_ab --parent DIR
        [--out chiprun_out/train_ab.json]

DIR is a checkout of another commit (e.g. ``git archive <commit>``
unpacked into the git-ignored ``_scratch/``).  In turns (the other tree,
this one, this one, the other), a child process in that tree (its
directory the working directory and ``PYTHONPATH``) builds the tree's
kernels and:

- runs the tree's ``chip_smoke.train()``: the launcher at llama_1b, 4 x
  2048, 8 steps (step ms from its tokens/s, host clock), then 8 steps on
  one fixed batch with float32 masters;
- profiles one step of the bench's configuration (``make_train_step`` at
  llama_1b, bf16, full remat, 4 x 2048, after two warm-up steps) under
  ``torch.profiler``: device ms by kernel name, and by kind (ATen
  elementwise, ATen reductions, copies and fills, matrix products, the
  port's kernels, other), with the device's busy share of the step;
- runs ``python -m kuberay_tpu_torch.bench`` (tokens/s, MFU) and again
  with ``--profile-out`` (the ``dispatch`` and ``host-fetch`` shares of
  a timed step).

Then it writes one JSON record of the four turns.  Times are CUDA events
or the host clock (ms, as named); quote them with the card's name and
power limit, which the record carries.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve()
TREE = HERE.parents[2]

# A kernel's kind by its name in the profile, first match wins.
KINDS = (
    ("port", re.compile(r"rmsnorm|flash_|ring_fwd|decode_kernel|"
                        r"_kernel_body")),
    ("matmul", re.compile(r"gemm|nvjet|sm90_xmma|cutlass|cublas", re.I)),
    ("aten_reduce", re.compile(r"reduce_kernel|Reduce", re.I)),
    ("aten_copy_fill", re.compile(r"copy|fill|Memcpy|Memset|cat_", re.I)),
    ("aten_elementwise", re.compile(r"elementwise|vectorized|unrolled",
                                    re.I)),
)


def kind_of(name: str) -> str:
    for kind, pat in KINDS:
        if pat.search(name):
            return kind
    return "other"


def profile_bench_step() -> dict:
    """One bench-configuration step under torch.profiler, after two."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kuberay_tpu_torch.models import llama
    from kuberay_tpu_torch.train import train_step as ts

    cfg = llama.CONFIGS["llama_1b"]
    tc = ts.TrainConfig(warmup_steps=2, decay_steps=1000)
    opt = ts.make_optimizer(tc)
    state = ts.init_train_state(
        cfg, opt, torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    step = ts.make_train_step(cfg, tc, opt)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), device="cuda",
                           dtype=torch.int32,
                           generator=torch.Generator(device="cuda"
                                                     ).manual_seed(1))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    for _ in range(2):
        state, m = step(state, batch)
    float(m["total_loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["total_loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, by_kind, counts, spans = {}, {}, {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        ms = (b - a) / 1e3
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
        counts[ev.name] = counts.get(ev.name, 0) + 1
        kind = kind_of(ev.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        spans.append((a, b))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:30]
    del state
    torch.cuda.empty_cache()
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_ms_total": sum(by_name.values()),
            "kernel_events": len(spans), "ms_by_kind": by_kind,
            "top_kernels": [(n[:120], ms, counts[n]) for n, ms in top]}


def bench(tree: Path, extra: list) -> dict:
    """The tree's bench as a process: its line, and with ``extra`` naming
    ``--profile-out``, the document's kinds."""
    out = subprocess.run([sys.executable, "-m", "kuberay_tpu_torch.bench",
                          *extra], cwd=tree, capture_output=True, text=True,
                         timeout=600, env={**os.environ,
                                           "PYTHONPATH": str(tree)})
    if out.returncode != 0:
        raise SystemExit(f"bench {extra}: rc {out.returncode}\n"
                         f"{out.stderr[-4000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    d = line["detail"]
    return {"tokens_s": line["value"], "mfu": line["vs_baseline"],
            "step_ms": d["batch"] * d["seq"] / line["value"] * 1e3}


def child() -> dict:
    """The measurements in the tree this process imports from."""
    import torch

    import chip_smoke as cs
    from kuberay_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    tree = Path(cs.__file__).resolve().parent
    t0 = time.perf_counter()
    _build.build_all()
    rec = {"build_s": time.perf_counter() - t0}
    trn = cs.train()
    rec["launcher_step_ms"] = trn["launcher"]["step_ms"]
    rec["launcher_step_ms_median_steady"] = \
        trn["launcher"]["step_ms_median_steady"]
    rec["launcher_launches_per_step"] = trn["launcher"]["launches_per_step"]
    rec["fixed_step_ms"] = trn["fixed_batch"]["step_ms"]
    rec["profile"] = profile_bench_step()
    rec["bench"] = bench(tree, [])
    path = Path(tempfile.mkdtemp(prefix="train-ab-")) / "profile.json"
    rec["bench_profile"] = bench(tree, ["--profile-out", str(path)])
    kinds = json.loads(path.read_text())["shapes"]["train"]["kinds"]
    rec["bench_profile"]["kinds"] = {
        k: {kk: v[kk] for kk in ("count", "mean_s", "fraction")}
        for k, v in kinds.items()}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other tree")
    ap.add_argument("--out", default=str(TREE / "chiprun_out" /
                                         "train_ab.json"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print("TRAIN_AB " + json.dumps(child()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_ab: no CUDA device")
    if not args.parent:
        raise SystemExit("train_ab: --parent DIR is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    trees = {"parent": Path(args.parent).resolve(), "this": TREE}
    turns = []
    for tag in ("parent", "this", "this", "parent"):
        tree = trees[tag]
        env = {**os.environ, "PYTHONPATH": str(tree)}
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, str(HERE), "--child"], cwd=tree,
                           env=env, capture_output=True, text=True,
                           timeout=900)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("TRAIN_AB ")]
        if p.returncode != 0 or not line:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"train_ab: the {tag} turn failed "
                             f"(exit {p.returncode})")
        rec = json.loads(line[-1][len("TRAIN_AB "):])
        rec.update(tree=tag, wall_s=time.perf_counter() - t0)
        turns.append(rec)
        print(f"{tag}: " + json.dumps(
            {k: v for k, v in rec.items() if k != "profile"}), flush=True)
        print(f"{tag} profile: " + json.dumps(
            {k: v for k, v in rec["profile"].items()
             if k != "top_kernels"}), flush=True)
    out = {"device": smi, "turns": turns}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"device": smi, "turns": [
        {"tree": t["tree"],
         "launcher_step_ms_median_steady":
             t["launcher_step_ms_median_steady"],
         "bench_tokens_s": t["bench"]["tokens_s"],
         "bench_mfu": t["bench"]["mfu"],
         "dispatch": t["bench_profile"]["kinds"]["dispatch"]["fraction"],
         "profiled_busy_ms": t["profile"]["device_busy_ms"]}
        for t in turns]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
