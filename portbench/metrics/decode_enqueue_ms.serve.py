"""decode_enqueue_ms.serve: the mean of the engine's ``decode-enqueue``
spans (``ServeEngine._decode_call`` from its host arrays to the sampler's
launch: the eager forward's enqueue) that start inside the window, less
the steps inside the profiler's capture (``ranges.window_spans``).  Model
step, decode.  Reads the program's spans; nothing where the program has
none."""

from portbench import ranges


def read(record):
    ms = [(s["end"] - s["start"]) * 1e3
          for s in ranges.window_spans(record, ("decode-enqueue",))]
    return sum(ms) / len(ms) if ms else None
