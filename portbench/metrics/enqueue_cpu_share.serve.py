"""enqueue_cpu_share.serve: the engine thread's CPU seconds (the spans'
``cpu_s``) over the wall seconds of the ``prefill-enqueue`` and
``decode-enqueue`` spans that start inside the window, less the steps
inside the profiler's capture (``ranges.window_spans``).  Under 100, the
thread was runnable and not running for the rest: waiting for the
interpreter lock or a core.  Engine loop layer.  Percent."""

from portbench import ranges


def read(record):
    spans = ranges.window_spans(record,
                                ("prefill-enqueue", "decode-enqueue"))
    wall = sum(s["end"] - s["start"] for s in spans)
    if wall <= 0:
        return None
    return 100.0 * sum(s["attrs"]["cpu_s"] for s in spans) / wall
