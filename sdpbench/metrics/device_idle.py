"""device_idle: the share of the traced window, in %, in which no operation
(kernel, copy or memset) ran on the device: 1 - (union of their intervals)
/ (the window), both from the profiler's trace."""

SPANS = {}


def read(rec):
    busy, window = rec.busy_s(), rec.traced_window_s()
    return 100.0 * (1.0 - busy / window) if busy is not None and window else None
