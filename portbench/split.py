"""A traced run of a cell, its capture split by the program's ranges.

    python3 -m portbench.split --workload <cell> --seed <n>
                               [--seconds S] [--rehearse]

Runs the cell as ``portbench.run --trace 1`` does (on the card; with
``--rehearse``, as ``portbench.rehearse`` does on the CPU), and reads the
same ``torch.profiler`` capture a second time with ``ranges.summarize``:
the card's idle time and device time by the program's step spans and
train phases, which the port's tracer marks as profiler ranges.  The
record then carries ``profile_ranges``, and the readers that need it
(``RANGE_METRICS``) are read beside the cell's per-layer metrics.

The drivers do not pass the capture's events on by themselves, so the
tool wraps ``profiling.summarize`` for its own process: the events the
driver summarises are also summarised by range.  That makes the tool a
stopgap, to be deleted when the drivers pass ``cap.events()`` to
``ranges.summarize`` into ``record["profile_ranges"]`` and the four
range readers get their entries in ``BENCHMARK.json``.  The stdout line holds
the cell's metrics, the range readers' metrics, the ranges and, for a
serving cell, the engine steps' host time by span (``obs/profile.py``'s
self times over the ``engine-step`` traces that start in the window);
``portbench: ranges {...}`` goes to standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

RANGE_METRICS = ("decode_idle.serve", "forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train")


def _with_ranges(summarize):
    from portbench import ranges

    def wrapped(events, window_s, thread=None, top=10):
        out = summarize(events, window_s, thread, top)
        out["ranges"] = ranges.summarize(events, thread)
        return out

    return wrapped


def step_host_time(record: Dict) -> Optional[Dict]:
    """The engine steps' host seconds by span kind (self times) over the
    ``engine-step`` traces that start in the window, and their count."""
    from kuberay_tpu_torch.obs.profile import trace_records

    w0, w1 = record["window"]
    spans = record.get("spans", ())
    inside = {s["trace_id"] for s in spans
              if s["name"] == "engine-step" and w0 <= s["start"] < w1}
    recs = trace_records([s for s in spans if s["trace_id"] in inside],
                         {"engine-step": "serve-step"})
    if not recs:
        return None
    kinds: Dict[str, float] = {}
    for r in recs:
        for k, v in r["self_s"].items():
            kinds[k] = kinds.get(k, 0.0) + v
    return {"steps": len(recs),
            "total_s": sum(r["duration_s"] for r in recs),
            "self_s": dict(sorted(kinds.items(), key=lambda kv: -kv[1]))}


def split(name: str, seed: int, seconds: float, rehearsal: bool = False):
    """(record, metrics) of one traced run with ``profile_ranges``."""
    from portbench import harness, profiling

    summarize = profiling.summarize
    profiling.summarize = _with_ranges(summarize)
    try:
        if rehearsal:
            from portbench.rehearse import rehearse

            record, metrics = rehearse(name, seed, seconds, trace=True)
        else:
            harness.pin_caches()
            ctx = harness.context(name, seed, seconds, True, T_START)
            record = harness.driver(ctx.cell["driver"]).run(ctx)
            metrics = harness.read_metrics(harness.benchmark(), ctx, record)
    finally:
        profiling.summarize = summarize
    prof = record.get("profile")
    if prof is not None and "ranges" in prof:
        record["profile_ranges"] = prof.pop("ranges")
    for m in RANGE_METRICS:
        value = harness.reader(m).read(record)
        if value is not None:
            metrics[m] = {"value": value}
    return record, metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.split")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the CPU rehearsal at tiny sizes")
    args = ap.parse_args(argv)
    if not args.rehearse:
        import torch

        if not torch.cuda.is_available():
            print("portbench.split: no CUDA device (--rehearse runs on the "
                  "CPU)", file=sys.stderr)
            return 2
    record, metrics = split(args.workload, args.seed, args.seconds,
                            args.rehearse)
    ranges = record.get("profile_ranges")
    print(f"portbench: ranges {json.dumps(ranges)}", file=sys.stderr)
    prof = record.get("profile") or {}
    line = {"workload": args.workload, "seed": args.seed,
            "rehearsal": args.rehearse, "correct": record["correct"],
            "metrics": metrics, "busy_s": prof.get("busy_s"),
            "window_s": prof.get("window_s"),
            "profile_steps": record.get("profile_steps"),
            "ranges": ranges}
    if record["kind"] == "serve":
        line["step_host_time"] = step_host_time(record)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
