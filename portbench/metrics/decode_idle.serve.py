"""decode_idle.serve: the card's idle time inside the engine's
``step-decode`` ranges (``_decode_all`` whole: block growth, the
forward's enqueue, the sync, the token emission) over those ranges' time
in the capture (``ranges.summarize``, inclusive).  Device layer.
Percent.  Reads ``profile_ranges``; nothing where the record has none or
the capture holds no device operation."""


def read(record):
    prof = record.get("profile")
    rng = (record.get("profile_ranges") or {}).get("ranges", {})
    dec = rng.get("step-decode")
    if record["kind"] != "serve" or prof is None or prof["busy_s"] <= 0 \
            or not dec or dec["time_s"] <= 0:
        return None
    return 100.0 * dec["idle_s"] / dec["time_s"]
