"""mfu.serve_prefill: the model FLOPs of the window's prefill forwards
(``counts.forward_flops`` of each one's real new tokens after its cached
prefix, logits at one row) at the card's bf16 peak, over their wall time
from the call to the sampled token on the host.  Model step, prefill.
Percent."""

from portbench import counts


def read(record):
    pk = counts.peaks(record["device_name"])
    w0, w1 = record["window"]
    calls = [p for p in record.get("prefills", ()) if w0 <= p["t0"] < w1]
    if pk is None or not calls:
        return None
    flops = sum(counts.forward_flops(record["dims"], p["start"], p["new"], 1)
                for p in calls)
    wall = sum(p["t1"] - p["t0"] for p in calls)
    return 100.0 * flops / pk["bf16_flops"] / wall
