"""forward_ms.train: device milliseconds a profiled train step of the
operations launched inside the step's ``train-forward`` range
(``ranges.summarize``: each operation charged to the range that holds
its launch).  Train-step layer.  Reads ``profile_ranges``; nothing where
the record has none."""

from portbench import ranges


def read(record):
    return ranges.phase_ms(record, "train-forward")
