"""itl_p50_ms.serve: the median over every gap between two consecutive
tokens of one request whose later token reached its stream inside the
window, pooled over all requests: the pace of decoding, a decode step's
time from the engine's loop to the stream.  Host clock.  A per-layer
metric and not an end-to-end one: the host-bound loop's speed moved it by
9-28% between runs of one seed, wider than any bound allows."""

from portbench.stats import quantile


def read(record):
    if record["kind"] != "serve":
        return None
    w0, w1 = record["window"]
    gaps = [(b - a) * 1e3 for r in record["requests"]
            for a, b in zip(r["times"], r["times"][1:]) if w0 <= b < w1]
    return quantile(gaps, 0.50) if gaps else None
