"""setup_s: seconds from the harness's first line to the window's start
(build or cache load, weights from the seed, warm-up of the cell's own
shapes, the cache fill and ramp its traffic needs).  Host clock."""


def read(record):
    return record["setup_s"]
