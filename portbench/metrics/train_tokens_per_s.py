"""train_tokens_per_s: the tokens of every train step finished inside the
window over the window's seconds; the window's ends are device syncs.
Host clock."""


def read(record):
    if record["kind"] != "train":
        return None
    w0, w1 = record["window"]
    return record["tokens"] / (w1 - w0)
