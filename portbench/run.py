"""One run of one cell on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Loads the cell's files (``harness.py``), builds the port's system under
test from the seed, warms up every shape the cell's traffic uses, measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``;
a serving cell adds ``kv_pool``: the KV pool's blocks, the blocks the run
ever wrote and a block's bytes, since the pool is reserved whole and
``memory_peak_bytes`` counts all of it.  ``checked`` comes last, each
compared number beside its limit, and the same numbers are the last lines
of standard error.

A run needs the card: without CUDA, or with fewer cards than the cell
asks for, it exits with 2 and prints no result.  It exits with 3 and no
result if the process holds JAX or the JAX package after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    from portbench import harness

    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.pin_caches()
    bench = harness.benchmark()
    ctx = harness.context(args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START)
    entry = next((w for w in bench["workloads"] if w["name"] == ctx.name),
                 None)
    if entry is None or any(entry[k] != ctx.cell[k]
                            for k in ("config", "traffic", "chips")):
        print(f"portbench: {ctx.name}'s cell file and BENCHMARK.json "
              f"disagree (or BENCHMARK.json has no such workload)",
              file=sys.stderr)
        return 2

    import torch

    chips = int(ctx.cell["chips"])
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; a measurement never runs on the "
              "CPU (portbench.rehearse does)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {ctx.name} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    record = harness.driver(ctx.cell["driver"]).run(ctx)
    metrics = harness.read_metrics(bench, ctx, record)
    held = harness.forbidden_modules(sys.modules)
    if held:
        print(f"portbench: the process holds {', '.join(held)}",
              file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": record["memory_peak_bytes"]}
    line = {"correct": record["correct"], "attempted": record["attempted"],
            "failed": record["failed"], "metrics": metrics,
            "device": device}
    prof = record.get("profile")
    if ctx.trace and prof is not None:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        line["breakdown"] = prof["breakdown"]
    if "kv" in record:
        line["kv_pool"] = record["kv"]
    line["checked"] = record["checked"]
    print(f"portbench: phases {json.dumps(record.get('phases', {}))} "
          f"kv_pool {json.dumps(record.get('kv'))} "
          f"numbers {json.dumps(record['numbers'])}", file=sys.stderr)
    for name, c in record["checked"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
