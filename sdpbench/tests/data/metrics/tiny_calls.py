"""tiny_calls: a test metric, the number of calls the window made."""

SPANS = {}


def read(rec):
    return float(len(rec.calls))
