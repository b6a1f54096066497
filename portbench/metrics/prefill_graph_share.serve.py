"""prefill_graph_share.serve: the engine's prefills in the window that ran
as one CUDA graph replay, over its prefills in the window (the engine's
``prefill_graph_steps`` / ``prefills``, chunks counted).  None where the
engine has no such counter.  Model step layer.  Percent."""


def read(record):
    if record["kind"] != "serve":
        return None
    a, b = record["stats0"], record["stats1"]
    if "prefill_graph_steps" not in a or "prefill_graph_steps" not in b:
        return None
    prefills = b["prefills"] - a["prefills"]
    if prefills <= 0:
        return None
    return 100.0 * (b["prefill_graph_steps"] - a["prefill_graph_steps"]) \
        / prefills
