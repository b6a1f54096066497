"""A cell's control flow on the CPU at tiny sizes, for rehearsal and tests.

    python3 -m portbench.rehearse --workload <cell> [--seed N]
                                  [--seconds S] [--trace 0|1]

Runs the cell's driver and metric readers exactly as ``portbench.run``
does, on the port's plain (CPU) paths, with the cell's configuration
shrunk to a few-layer model of tiny widths (``TINY``), its traffic's
lengths and its engine scaled down to match, and the cell's own limits.
The printed line says ``"rehearsal": true`` and names the CPU: it is
never a measurement, and no device metric is read from it (the readers
find no peak for the CPU).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

TINY = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128, "head_dim": 16,
        "max_position_embeddings": 512}


def shrink(ctx, sizes: Dict) -> None:
    """Shrink a context's configuration to ``sizes``, and its traffic and
    engine to match, in place."""
    cfg = ctx.config
    group = cfg["num_attention_heads"] // cfg["num_key_value_heads"]
    cfg.update(sizes)
    cfg["num_key_value_heads"] = max(1, cfg["num_attention_heads"] // group)
    if "train" in cfg:
        cfg["train"] = dict(cfg["train"], xent_chunk=256)
    mix = ctx.mix
    if mix["kind"] == "batches":
        mix.update(batch=2, seq_len=32, pool=4)
    else:
        mix["rate_per_s"] = 20.0
        mix["prompt"] = dict(mix["prompt"], min=8, max=40)
        if "median" in mix["prompt"]:
            mix["prompt"]["median"] = 16
        mix["output"] = dict(mix["output"], min=2, max=10)
        if "median" in mix["output"]:
            mix["output"]["median"] = 5
        if mix.get("documents"):
            mix["documents"] = dict(mix["documents"], count=3, min=40,
                                    max=80)
        if mix.get("system"):
            mix["system"] = dict(mix["system"], min=20, max=40)
            mix["think_s"] = 0.05
        cell = ctx.cell
        cell["engine"] = dict(cell["engine"], max_slots=4, max_len=160,
                              num_blocks=160)
        cell.update(ramp_s=0.5, drain_s=10.0, profile_s=0.3)
        cell["check"] = dict(cell["check"], min_served_tokens=20,
                             max_requests=4)


def rehearse(name: str, seed: int = 1, seconds: float = 2.0,
             trace: bool = False, options: Optional[Dict] = None,
             device: str = "cpu", sizes: Optional[Dict] = None,
             mix: Optional[Dict] = None):
    """(record, metrics) of one small run of cell ``name``: on the CPU at
    ``TINY`` sizes unless told otherwise (the gpu-marked tests run it on
    the card with a few layers of the published widths).  ``mix`` puts
    another traffic mix in the cell's (the tests' mixes of other kinds)."""
    from portbench import harness
    from portbench.traffic import generate

    harness.pin_caches()
    ctx = harness.context(name, seed, seconds, trace, time.perf_counter(),
                          device=device)
    if mix is not None:
        generate.check_keys(mix)
        ctx.mix = copy.deepcopy(mix)
    ctx.config = copy.deepcopy(ctx.config)
    shrink(ctx, TINY if sizes is None else sizes)
    ctx.options = dict(options or {})
    record = harness.driver(ctx.cell["driver"]).run(ctx)
    return record, harness.read_metrics(harness.benchmark(), ctx, record)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.rehearse")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    record, metrics = rehearse(args.workload, args.seed, args.seconds,
                               bool(args.trace))
    print(json.dumps({"rehearsal": True, "correct": record["correct"],
                      "attempted": record["attempted"],
                      "failed": record["failed"], "metrics": metrics,
                      "device": {"platform": "cpu", "count": 0},
                      "setup_s": time.perf_counter() - T_START,
                      "checked": record["checked"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
