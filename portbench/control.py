"""Readings that set a cell's limits: the program's, the control's, the
faults'.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3
                                 [--seconds 10] [--controls ...]

Per seed, one run of the cell as ``portbench.run`` makes it (a short
window at the cell's own load and sizes) gives the program's numbers.
Then, named by ``--controls``:

- ``int8w`` (serving): the program with its own lower-precision path on,
  W8A16 weights (``weight_quant="int8"``), judged by the same check;
- ``fp8`` (serving and training): the reference put in the program's
  place with every matmul's inputs in fp8 e4m3 (``reference.Lowp``); for
  serving, the gap of the token it puts first at each served position of
  the program's sampled requests; for training, its first steps against
  the float32 reference's;
- ``half`` (training): the reference on half of each batch's rows, the
  mean over the rest (a fault a training cell can have).

Each reading is a JSON line with ``correct``: the verdict of the cell's
own check (``check.verdict`` at the limits in its cell file) on those
numbers, which has to come out false for a control.  The limits are set
from the readings by hand (``PERF.md`` keeps them).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--controls", default="")
    args = ap.parse_args(argv)

    from portbench import harness

    harness.pin_caches()
    import torch

    from portbench import check
    from portbench.traffic import generate

    controls = [c for c in args.controls.split(",") if c]
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = harness.context(args.workload, seed, args.seconds, False,
                              time.perf_counter())
        ctx.options = {"keep_samples": True}
        rec = harness.driver(ctx.cell["driver"]).run(ctx)
        _emit(seed=seed, side="program", correct=rec["correct"],
              numbers=rec["numbers"], phases=rec.get("phases"))
        fam = harness.family(ctx.config)
        config = ctx.config
        vocab = fam.dims(config).vocab
        for control in controls:
            if control == "int8w":
                c = harness.context(args.workload, seed, args.seconds,
                                    False, time.perf_counter())
                c.options = {"engine": {"weight_quant": "int8"}}
                r = harness.driver(c.cell["driver"]).run(c)
                numbers = r["numbers"]
            elif control == "fp8" and ctx.cell["driver"] == "serve":
                params = fam.make_params(config, seed, "cuda",
                                         fam.dtype(config))
                numbers = check.serve_numbers(
                    fam, params, config, rec["samples"],
                    lowp=fam.Lowp("fp8"))
                del params
            elif control in ("fp8", "half"):
                n = int(ctx.cell["check"]["steps"])
                batches = generate.batches(ctx.mix, vocab, seed, "cuda")[:n]
                rows = (slice(0, ctx.mix["batch"] // 2)
                        if control == "half" else None)
                lowp = fam.Lowp("fp8" if control == "fp8" else None)
                p0 = fam.make_params(config, seed, "cuda", torch.float32)
                got = fam.reference_train(p0, config, list(batches), lowp,
                                          rows)
                del p0, batches
                numbers = check.train_numbers(got, rec["reference"])
            else:
                raise SystemExit(f"unknown control {control!r}")
            gc.collect()
            torch.cuda.empty_cache()
            ok, _ = check.verdict(numbers, ctx.cell["check"]["limits"])
            _emit(seed=seed, side=control, correct=ok, numbers=numbers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
