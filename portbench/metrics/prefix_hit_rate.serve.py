"""prefix_hit_rate.serve: prompt tokens the paged pool's prefix cache
served over the block-aligned prompt tokens it was asked for, over the
window (the engine's ``prefix_hit_tokens`` / ``prefix_query_tokens``).
Paged-KV layer.  Percent."""


def read(record):
    if record["kind"] != "serve":
        return None
    a, b = record["stats0"], record["stats1"]
    queries = b["prefix_query_tokens"] - a["prefix_query_tokens"]
    if queries <= 0:
        return None
    return 100.0 * (b["prefix_hit_tokens"] - a["prefix_hit_tokens"]) / queries
