"""flash_roofline: the port's flash kernels (``csrc/flash_attention.cu``:
forward, dK/dV, dQ) in the profiled train steps: the least time their
launches could take (``counts.flash_bound_s`` at the cell's shape: visible
(q, k) pairs times 4, 8 and 6 head-dim FLOPs at the bf16 peak) over their
device time.  Kernels layer.  Percent."""

from portbench import counts, profiling

KERNELS = {"fwd": r"flash_fwd_kernel", "bwd_dkv": r"flash_bwd_dkv_kernel",
           "bwd_dq": r"flash_bwd_dq_kernel"}


def read(record):
    pk = counts.peaks(record["device_name"])
    prof = record.get("profile")
    if record["kind"] != "train" or pk is None or prof is None:
        return None
    dims = record["dims"]
    bound = busy = 0.0
    for kind, pattern in KERNELS.items():
        s, n = profiling.device_seconds(prof, pattern)
        busy += s
        bound += n * counts.flash_bound_s(
            kind, record["batch"], record["seq_len"], dims.heads,
            dims.kv_heads, dims.head_dim, pk)
    return 100.0 * bound / busy if busy > 0 else None
