"""iter_ms: the traced window's host ms over the IPM iterations run in it
(solo), or over the fleet iterations (a fleet)."""

SPANS = {}


def read(rec):
    return 1e3 * rec.window_s / rec.iterations if rec.iterations else None
