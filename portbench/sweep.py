"""Find the highest rate a serving cell sustains: a sweep on the card.

    python3 -m portbench.sweep --workload <cell> --rates 2,3,4 \
        [--seconds 30] [--seed N]

Runs the cell's driver once at each rate, in one process, with the check
left out, on the cell's own schedule (the mix's fixed sizes and gaps, the
gaps scaled to the rate), and prints a line a rate: TTFT p50 and p90, ITL
p50, p95 and p99, requests due and failed, the engine's queue at the
window's start and end, and the output tokens completed a second.

A rate is sustained (``SUSTAINED``) where no request failed, the engine's
queue at the window's end is at most ``QUEUE_GROWTH`` deeper than at its
start, and TTFT p90 is at most ``TTFT_FACTOR`` times the lowest rate's.
The last line names the highest rate sustained with every lower one, and
0.8 of it, rounded down to a tenth: the rate to fix in the traffic file.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# Past the window, how long a sweep point waits for first tokens: an
# overloaded point counts what is still waiting as failed.
DRAIN_S = 15.0
QUEUE_GROWTH = 2
TTFT_FACTOR = 2.0


def sustained(point, lowest) -> bool:
    return bool(point["failed"] == 0
                and point["queue_end"] <= point["queue_start"] + QUEUE_GROWTH
                and point["ttft_p90_ms"] <= TTFT_FACTOR
                * lowest["ttft_p90_ms"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    from portbench import harness
    from portbench.stats import quantile

    harness.pin_caches()
    points = []
    for rate in sorted(float(r) for r in args.rates.split(",")):
        ctx = harness.context(args.workload, args.seed, args.seconds, False,
                              time.perf_counter())
        ctx.mix["rate_per_s"] = rate
        ctx.cell["drain_s"] = DRAIN_S
        ctx.options = {"skip_check": True}
        rec = harness.driver(ctx.cell["driver"]).run(ctx)
        w0, w1 = rec["window"]
        win = [r for r in rec["requests"] if r["in_window"]]
        ttft = [((r["times"][0] if r["times"] else r["end"]) - r["due"])
                * 1e3 for r in win]
        gaps = [(b - a) * 1e3 for r in rec["requests"]
                for a, b in zip(r["times"], r["times"][1:]) if w0 <= b < w1]
        toks = sum(1 for r in rec["requests"] for t in r["times"]
                   if w0 <= t < w1)
        point = {
            "rate": rate, "due": len(win), "failed": rec["failed"],
            "ttft_p50_ms": quantile(ttft, 0.5),
            "ttft_p90_ms": quantile(ttft, 0.9),
            "itl_p50_ms": quantile(gaps, 0.5),
            "itl_p95_ms": quantile(gaps, 0.95),
            "itl_p99_ms": quantile(gaps, 0.99),
            "queue_start": rec["stats0"]["queue_depth"],
            "queue_end": rec["stats1"]["queue_depth"],
            "active_end": rec["stats1"]["active_slots"],
            "tokens_per_s": toks / (w1 - w0),
            "decode_step_ms": 1e3 * (rec["stats1"]["decode_s"] -
                                     rec["stats0"]["decode_s"]) / max(
                1, rec["stats1"]["decode_steps"] -
                rec["stats0"]["decode_steps"]),
            "setup_s": rec["setup_s"]}
        points.append(point)
        point["sustained"] = sustained(point, points[0])
        print(json.dumps(point), flush=True)
    top = None
    for point in points:
        if not point["sustained"]:
            break
        top = point["rate"]
    print(json.dumps({"highest_sustained": top,
                      "cell_rate": (None if top is None else
                                    int(top * 8 + 1e-9) / 10)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
