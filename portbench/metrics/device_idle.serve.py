"""device_idle.serve: the share of the profiled stretch of a serving
window in which no operation ran on the card (1 - busy_s / window_s of the
trace).  Device layer.  Percent."""


def read(record):
    prof = record.get("profile")
    if record["kind"] != "serve" or prof is None or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
