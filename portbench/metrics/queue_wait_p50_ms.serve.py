"""queue_wait_p50_ms.serve: the median of the engine's ``engine-queue``
spans (a request's arrival at the engine to its admission) over the
requests due in the window.  Frontend and admission layer."""

import statistics


def read(record):
    ids = {r["trace_id"] for r in record["requests"]
           if r["in_window"] and r["trace_id"]}
    waits = [(s["end"] - s["start"]) * 1e3 for s in record.get("spans", ())
             if s["name"] == "engine-queue" and s["trace_id"] in ids]
    return statistics.median(waits) if waits else None
