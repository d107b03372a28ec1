"""solve_s: seconds per certified solve, the window's elapsed host time over
the solves it completed (a fleet member is one solve).  The window closes
when the solve in flight at --seconds ends, so none is counted in part; a
failed solve's time stays in the window."""

SPANS = {}


def read(rec):
    return rec.window_s / rec.solves if rec.solves else None
