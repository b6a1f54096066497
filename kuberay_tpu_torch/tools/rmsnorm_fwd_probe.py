"""RMSNorm's forward kernel on one card: checks, a sweep of its launch
plans, and an A/B against another tree.

    python3 -m kuberay_tpu_torch.tools.rmsnorm_fwd_probe [--quick]
        [--parent DIR [--e2e]] [--out chiprun_out/rmsnorm_fwd_probe.json]

At every shape of SHAPES (chip_smoke.py's ``check_rmsnorm`` row counts
and llama3_70b's 64 x 8192; bf16 x and w from one seeded generator) and
every ``chip_smoke.RMS_ODD`` case: ``rmsnorm_fwd`` against
``rmsnorm_ref`` within ``chip_smoke.RMS_ATOL`` and two calls bit for
bit.  Then, unless ``--quick``, for each setting of the plan's knob
(``UNITS_A_THREAD``; each distinct plan once) with and without
programmatic dependent launch (``PDL``), the kernel's
time at each shape from a CUDA graph twice: on one x (which stays in the
50 MB L2 across replays for all but the largest shapes) and over x
buffers rotated past L2 (``rotated_graph_ms``).  At the module's own
plan: ``chip_smoke.timings`` (eager, host enqueue, graph; the plain
version and ``F.rms_norm``), the rotated times of the kernel and of
``F.rms_norm``, the bound, the launch floors (empty Triton and CUDA
kernels) and the ptxas report of every instantiation.

With ``--parent DIR`` (another commit's checkout, e.g. ``git archive``
unpacked into the git-ignored ``_scratch/``), in turns (the other tree,
this one, this one, the other) a child process in each tree (its
directory the working directory and ``PYTHONPATH``) builds the tree's
kernels and times ``rmsnorm`` at every shape of SHAPES (graph, rotated
graph, eager, host enqueue, ``F.rms_norm`` from a graph) and keeps a
SHA-256 of each output; with ``--e2e`` also the tree's
``chip_smoke.serve()`` at llama3_8b (its ``decode_step_ms``) and
``chip_smoke.train()`` at llama_1b (the launcher's steady step).

Times are CUDA events (ms) or the host's clock; quote them with the
card's name and power limit, which the record carries.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
TREE = HERE.parents[2]
SHAPES = ((1, 4096), (8, 4096), (300, 4096), (2048, 4096), (512, 2048),
          (2048, 2048), (4096, 2048), (8192, 2048), (64, 8192))
UNITS = (1, 2, 4)             # 4: past MAX_NV, the kernel's loop
ROTATE_BYTES = 200e6           # x and out bytes a rotated graph moves
ROTATE_MAX = 2000              # calls in a rotated graph at most


def _digest(t) -> str:
    import torch
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def _inputs(gen, rows: int, d: int):
    """chip_smoke.check_rmsnorm's inputs: x uniform in [-1, 1), w in
    [0.5, 1.5), bf16."""
    import torch
    x = (torch.rand(rows, d, generator=gen, device="cuda") * 2 - 1
         ).bfloat16()
    w = (torch.rand(d, generator=gen, device="cuda") + 0.5).bfloat16()
    return x, w


def rotated_graph_ms(fn, x) -> float:
    """Mean device time of ``fn(xi)`` over copies xi of x whose bytes (and
    their outputs') pass ROTATE_BYTES, so each call reads its x from
    device memory, not L2: one call a copy captured in one CUDA graph,
    replayed between CUDA events.  The outputs stay alive, each at its
    own address."""
    import torch
    n = int(min(ROTATE_MAX, max(4, ROTATE_BYTES //
                                (2 * x.numel() * x.element_size()))))
    xs = [x.clone() for _ in range(n)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for xi in xs[:3]:
            fn(xi)
    torch.cuda.current_stream().wait_stream(side)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for xi in xs:
            outs.append(fn(xi))
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def child(shapes, e2e: bool) -> dict:
    """The A/B's measurements in the tree this process imports from."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from kuberay_tpu_torch.ops import _build
    from kuberay_tpu_torch.ops import rmsnorm as rn

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    rec = {"build_s": time.perf_counter() - t0, "bits": {}, "shapes": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, d in shapes:
        x, w = _inputs(gen, rows, d)
        rec["bits"][f"{rows}x{d}"] = _digest(rn.rmsnorm(x, w))
        fn = lambda: rn.rmsnorm(x, w)  # noqa: E731
        rec["shapes"][f"{rows}x{d}"] = {
            "graph_ms": cs.graph_ms(fn, 200),
            "rotated_graph_ms": rotated_graph_ms(
                lambda xi: rn.rmsnorm(xi, w), x),
            "ms": cs.cuda_ms(fn, 200), "host_ms": cs.host_ms(fn, 200),
            "library_graph_ms": cs.graph_ms(
                lambda: F.rms_norm(x, (d,), w, 1e-5), 200)}
        del x, w
        torch.cuda.empty_cache()
    if e2e:
        cfg = cs.llama.CONFIGS["llama3_8b"]
        params = cs.llama.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        srv = cs.serve(cfg, params)
        rec["decode_step_ms"] = srv["decode_step_ms"]
        del params, srv
        torch.cuda.empty_cache()
        rec["launcher_step_ms"] = \
            cs.train()["launcher"]["step_ms_median_steady"]
    return rec


def ab(parent: Path, e2e: bool) -> dict:
    """The turns parent, this, this, parent, each in a child process."""
    task = json.dumps({"shapes": SHAPES, "e2e": e2e})
    trees = {"parent": parent, "this": TREE}
    turns = []
    for tag in ("parent", "this", "this", "parent"):
        tree = trees[tag]
        env = {**os.environ, "PYTHONPATH": str(tree)}
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, str(HERE), "--child", task],
                           cwd=tree, env=env, capture_output=True, text=True,
                           timeout=1500)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("RMS_AB ")]
        if p.returncode != 0 or not line:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"rmsnorm_fwd_probe: the {tag} turn failed "
                             f"(exit {p.returncode})")
        rec = json.loads(line[-1][len("RMS_AB "):])
        rec.update(tree=tag, wall_s=time.perf_counter() - t0)
        turns.append(rec)
        print(f"{tag}: " + json.dumps({k: v for k, v in rec.items()
                                       if k != "bits"}), flush=True)
    spread = {}
    for key in turns[0]["shapes"]:
        for metric in turns[0]["shapes"][key]:
            for tag in trees:
                vals = [t["shapes"][key][metric] for t in turns
                        if t["tree"] == tag]
                spread.setdefault(key, {}).setdefault(metric, {})[tag] = \
                    [min(vals), max(vals)]
    for metric in ("decode_step_ms", "launcher_step_ms"):
        if metric in turns[0]:
            spread[metric] = {tag: [t[metric] for t in turns
                                    if t["tree"] == tag] for tag in trees}
    same = {tag: all(t["bits"] == [u for u in turns if u["tree"] == tag][0]
                     ["bits"] for t in turns if t["tree"] == tag)
            for tag in trees}
    return {"turns": turns, "spread": spread, "repeat_bits_equal": same}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="checks and the module's own plan only")
    ap.add_argument("--parent", type=Path, help="the other tree")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--out", default=str(TREE / "chiprun_out" /
                                         "rmsnorm_fwd_probe.json"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        task = json.loads(args.child)
        print("RMS_AB " + json.dumps(child(task["shapes"], task["e2e"])),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_fwd_probe: no CUDA device")
    import torch.nn.functional as F
    sys.path.insert(0, str(TREE))
    import chip_smoke as cs
    from kuberay_tpu_torch.ops import _build
    from kuberay_tpu_torch.ops import rmsnorm as rn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    libs = _build.build_all(["rmsnorm"])
    rec = {"device": smi, "build_s": time.perf_counter() - t0,
           "checks": {}, "sweep": {}, "default": {}}
    res = cs.rms_resources(libs)
    rec["resources"] = res
    print(f"built in {rec['build_s']:.2f} s; ptxas: {json.dumps(res)}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for rows, d in SHAPES:
        x, w = _inputs(gen, rows, d)
        inputs[(rows, d)] = (x, w)
        y = rn.rmsnorm(x, w)
        err = cs.max_err(y, rn.rmsnorm_ref(x, w))
        rec["checks"][f"{rows}x{d}"] = {
            "max_abs_err": err, "ok": err <= cs.RMS_ATOL and
            cs.bits_equal(y, rn.rmsnorm(x, w)), "plan": cs.rms_plan(x, w)}
        print(f"{rows}x{d}: {json.dumps(rec['checks'][f'{rows}x{d}'])}",
              flush=True)
    rec["checks"]["odd"] = cs.check_rmsnorm_odd(res)
    knobs = ("UNITS_A_THREAD", "PDL")
    default = {k: getattr(rn, k) for k in knobs}
    if not args.quick:
        for (rows, d), (x, w) in inputs.items():
            seen = set()
            for units, pdl in itertools.product(UNITS, (False, True)):
                rn.UNITS_A_THREAD, rn.PDL = units, pdl
                plan = rn.fwd_plan(d)
                if (plan, pdl) in seen:
                    continue
                seen.add((plan, pdl))
                rn._plans.clear()
                key = f"{rows}x{d} T{plan.threads} nv{plan.nv} pdl{int(pdl)}"
                rec["sweep"][key] = {
                    "graph_ms": cs.graph_ms(lambda: rn.rmsnorm(x, w), 100),
                    "rotated_graph_ms": rotated_graph_ms(
                        lambda xi: rn.rmsnorm(xi, w), x)}
                print(f"{key}: {json.dumps(rec['sweep'][key])}", flush=True)
        for k, v in default.items():
            setattr(rn, k, v)
        rn._plans.clear()
    for (rows, d), (x, w) in inputs.items():
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * 2
        key = f"{rows}x{d}"
        rec["default"][key] = {
            "plan": rn.fwd_plan(d), "pdl": rn.PDL,
            **cs.timings(lambda: rn.rmsnorm(x, w),
                         lambda: rn.rmsnorm_ref(x, w),
                         lambda: F.rms_norm(x, (d,), w, 1e-5), 200, 200),
            "rotated_graph_ms": rotated_graph_ms(
                lambda xi: rn.rmsnorm(xi, w), x),
            "library_rotated_graph_ms": rotated_graph_ms(
                lambda xi: F.rms_norm(xi, (d,), w, 1e-5), x),
            **cs.bound(nbytes, 4 * x.numel())}
        print(f"default {key}: {json.dumps(rec['default'][key])}",
              flush=True)
    rec["launch_floor"] = cs.launch_floor()
    print(f"launch floor: {json.dumps(rec['launch_floor'])}", flush=True)
    del inputs
    torch.cuda.empty_cache()
    if args.parent:
        rec["ab"] = ab(args.parent.resolve(), args.e2e)
        print(f"ab spread: {json.dumps(rec['ab']['spread'])}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    bad = [k for k, c in rec["checks"].items() if k != "odd" and not c["ok"]]
    print(json.dumps({"device": smi, "failed": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
