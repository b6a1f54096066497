"""mfu.serve_decode: the whole decode step's share of the card's peak: the
least time each of the window's decode steps could take
(``counts.decode_step_bound_s`` over its active slots: the larger of FLOPs
at the bf16 peak and bytes at the HBM peak; the bytes, weights once, live
KV once and the new KV written, bound it at these shapes), summed, over
the engine's ``decode_s`` of those steps.  Model step, decode.  Percent."""

from portbench import counts


def read(record):
    pk = counts.peaks(record["device_name"])
    w0, w1 = record["window"]
    steps = [d for d in record.get("decodes", ()) if w0 <= d["t"] < w1
             and d["active"]]
    if pk is None or not steps:
        return None
    bound = sum(counts.decode_step_bound_s(record["dims"], d["active"], pk)
                for d in steps)
    return 100.0 * bound / sum(d["dt"] for d in steps)
