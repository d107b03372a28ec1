"""setup_s: host seconds from the process's start to the first timed solve:
imports, CUDA start, drawing and writing the instances, one warm call of
the cell's own shape."""

SPANS = {}


def read(rec):
    return rec.setup_s
