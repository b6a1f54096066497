"""RMSNorm's backward kernels on one card: checks, times and a sweep.

    python3 -m kuberay_tpu_torch.tools.rmsnorm_bwd_probe
        [--out chiprun_out/rmsnorm_bwd_probe.json]

At every training shape of ``chip_smoke.RMS_BWD_SHAPES`` (bf16 x, w and
g from one seeded generator): ``rmsnorm_bwd`` against ``rmsnorm_bwd_ref``
(``chip_smoke.local_err``, dx and dw), two calls bit for bit, dx alone and
dw alone, a strided and an expanded g.  Then, for each warp count of
WARPS and programs-per-SM count of PLANS, the wrapper's time at each
shape (eager and from a CUDA graph); at the module's own choice,
``chip_smoke.rms_bwd_timings`` (the plain chain and ``F.rms_norm``'s
backward beside the wrapper) and the bound; and each kernel variant's
registers and spills.  Times are CUDA events (ms);
quote them with the card's name and power limit, which the record
carries.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
PLANS = (1, 2, 4, 8)
WARPS = (None, 4, 8, 16)       # None: the module's choice by width


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(TREE / "chiprun_out" /
                                         "rmsnorm_bwd_probe.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_bwd_probe: no CUDA device")
    sys.path.insert(0, str(TREE))
    import chip_smoke as cs
    from kuberay_tpu_torch.ops import rmsnorm as rn
    DEFAULT_PER_SM = rn.PROGRAMS_PER_SM

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {"device": smi, "checks": {}, "times": {}}
    inputs = {}
    for rows, d in cs.RMS_BWD_SHAPES:
        x, w, g = cs.rms_bwd_inputs(gen, rows, d)
        inputs[(rows, d)] = (x, w, g)
        rec["checks"][f"{rows}x{d}"] = cs.rms_bwd_check(x, w, g)
        print(f"{rows}x{d}: {json.dumps(rec['checks'][f'{rows}x{d}'])}",
              flush=True)
    real_warps = rn.bwd_warps
    for warps in WARPS:
        rn.bwd_warps = (lambda block, n=warps: n) if warps else real_warps
        for per_sm in PLANS:
            rn.PROGRAMS_PER_SM = per_sm
            for (rows, d), (x, w, g) in inputs.items():
                key = f"warps {warps or 'auto'}, {per_sm} an SM, {rows}x{d}"
                rec["times"][key] = {
                    "plan": rn.bwd_plan(rows, x.device),
                    "graph_ms": cs.graph_ms(lambda: rn.rmsnorm_bwd(x, w, g),
                                            50),
                    "ms": cs.cuda_ms(lambda: rn.rmsnorm_bwd(x, w, g), 50)}
                print(f"{key}: {json.dumps(rec['times'][key])}", flush=True)
    rn.bwd_warps, rn.PROGRAMS_PER_SM = real_warps, DEFAULT_PER_SM
    for (rows, d), (x, w, g) in inputs.items():
        key = f"default {rows}x{d}"
        rec["times"][key] = {**cs.rms_bwd_timings(x, w, g),
                             **cs.rms_bwd_bound(x)}
        print(f"{key}: {json.dumps(rec['times'][key])}", flush=True)
    rec["resources"] = rn.resources()
    print(f"resources: {json.dumps(rec['resources'])}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    bad = [k for k, c in rec["checks"].items() if not c["ok"]]
    print(json.dumps({"device": smi, "failed": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
