"""launches_per_iter: device kernels (profiler events on the device that are
not copies or memsets) in the traced window, per IPM iteration (fleet iteration in a fleet)."""

SPANS = {}


def read(rec):
    if rec.profile is None or not rec.iterations:
        return None
    k = rec.in_window(rec.profile.kernels)
    return len(k) / rec.iterations if k else None
