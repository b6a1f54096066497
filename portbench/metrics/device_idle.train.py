"""device_idle.train: the share of the profiled train steps in which no
operation ran on the card (1 - busy_s / window_s of the trace).  Device
layer.  Percent."""


def read(record):
    prof = record.get("profile")
    if record["kind"] != "train" or prof is None or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
