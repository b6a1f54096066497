"""mfu.train: (6 N + 12 L d S) FLOPs a token (``counts``) times the tokens
trained in the window, over the window's seconds and the card's bf16
peak.  Whole train step.  Percent."""

from portbench import counts


def read(record):
    pk = counts.peaks(record["device_name"])
    if record["kind"] != "train" or pk is None:
        return None
    w0, w1 = record["window"]
    flops = counts.train_flops_per_token(record["dims"], record["seq_len"])
    return 100.0 * flops * record["tokens"] / (w1 - w0) / pk["bf16_flops"]
