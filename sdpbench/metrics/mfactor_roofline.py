"""mfactor_roofline: the Schur factor's share of its roofline, in %.

For every ``fused.factor_m`` call, the least time the card could take for
one Cholesky of its M (``roofline.cholesky_flops`` at the FP64 tensor-core
peak against ``roofline.cholesky_bytes`` at the HBM bandwidth, times the
fleet's instances), summed, over the device time of the kernels that ran
inside the calls' spans (their union, from the profiler's trace; the spans
synchronise the device at both ends, so those kernels are the call's).  A
regularisation ladder that refactors counts as time, not as work."""

import math

from sdpbench import roofline, tracing

SPANS = {"factor_m": "hdsdp_tpu_torch.solver.fused:factor_m"}


def read(rec):
    calls = [s for s in rec.spans if s.name == "factor_m" and s.shapes]
    if rec.profile is None or rec.peaks is None or not calls:
        return None
    least = 0.0
    for s in calls:
        shape = s.shapes[0]
        m, batch = shape[-1], math.prod(shape[:-2])
        least += roofline.least_time(roofline.cholesky_flops(m, batch),
                                     roofline.cholesky_bytes(m, batch),
                                     rec.peaks["fp64_tensor_flops"], rec.peaks["hbm_bytes_per_s"])
    windows = sorted((s, e) for name, s, e in rec.profile.spans if name == "factor_m")
    kernels = sorted((s, e) for _, s, e in rec.profile.kernels)
    inside, k = [], 0
    for lo, hi in windows:
        while k < len(kernels) and kernels[k][0] < lo:
            k += 1
        j = k
        while j < len(kernels) and kernels[j][0] <= hi:
            inside.append(kernels[j])
            j += 1
    device_s = tracing.union_length(inside) * 1e-9
    return 100.0 * least / device_s if device_s > 0 else None
