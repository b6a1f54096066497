"""decode_graph_share.serve: the engine's decode steps in the window that
ran as one CUDA graph replay, over its decode steps in the window (the
engine's ``decode_graph_steps`` / ``decode_steps``).  None where the engine
has no such counter.  Model step layer.  Percent."""


def read(record):
    if record["kind"] != "serve":
        return None
    a, b = record["stats0"], record["stats1"]
    if "decode_graph_steps" not in a or "decode_graph_steps" not in b:
        return None
    steps = b["decode_steps"] - a["decode_steps"]
    if steps <= 0:
        return None
    return 100.0 * (b["decode_graph_steps"] - a["decode_graph_steps"]) / steps
