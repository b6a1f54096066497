"""ttft_p90_ms: the 90th percentile, over every request due inside the
window, of the time from its due time on the open-loop schedule to its
first token reaching its stream.  A request that never got a token counts
with the time until the run gave up on it, so it lies beyond any limit the
others meet.  Host clock."""

from portbench.stats import quantile


def read(record):
    if record["kind"] != "serve":
        return None
    waits = [((r["times"][0] if r["times"] else r["end"]) - r["due"]) * 1e3
             for r in record["requests"] if r["in_window"]]
    return quantile(waits, 0.90) if waits else None
