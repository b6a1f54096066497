"""paged_decode_roofline: the paged decode-attention kernel
(``csrc/paged_attention.cu``: ``paged_decode_kernel`` and its split
merge) over the profiled stretch: the least time its calls could take
(``counts.paged_decode_bound_s``, one call a layer and decode step, over
every row the call is given) over their device time in the trace.
Kernels layer.  Percent."""

from portbench import counts, profiling


def read(record):
    pk = counts.peaks(record["device_name"])
    prof = record.get("profile")
    if pk is None or prof is None:
        return None
    first, last = record["profile_steps"]
    steps = [d for d in record["decodes"] if first < d["step"] <= last]
    busy, launches = profiling.device_seconds(
        prof, r"paged_decode_kernel|merge_kernel")
    if not steps or busy <= 0:
        return None
    dims = record["dims"]
    bound = dims.layers * sum(counts.paged_decode_bound_s(
        dims, d["rows"], record["block_size"], pk) for d in steps)
    return 100.0 * bound / busy
