"""decode_step_ms.serve: the engine's decode seconds over its decode steps
in the window (``decode_s / decode_steps``: host clock around a step that
ends in the sampled tokens' copy to the host).  Engine loop layer."""


def read(record):
    if record["kind"] != "serve":
        return None
    a, b = record["stats0"], record["stats1"]
    steps = b["decode_steps"] - a["decode_steps"]
    if steps <= 0:
        return None
    return 1e3 * (b["decode_s"] - a["decode_s"]) / steps
