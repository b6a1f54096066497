"""elementwise_ms.train: device milliseconds a train step in the kernel
kinds ``aten_elementwise``, ``aten_copy_fill`` and ``aten_reduce`` of the
copied ``KINDS`` table (the optimizer, casts, the loss's glue), from the
profiled steps.  Train-step layer."""

KINDS = ("aten_elementwise", "aten_copy_fill", "aten_reduce")


def read(record):
    prof = record.get("profile")
    if record["kind"] != "train" or prof is None or prof["busy_s"] <= 0:
        return None
    s = sum(prof["device_s_by_kind"].get(k, 0.0) for k in KINDS)
    return 1e3 * s / record["profile_steps"]
