"""sinv_roofline: S^-1's share of its roofline, in %.

S^-1 from its Cholesky factor L (``ops/chol.py`` ``chol_inverse``) is
counted as LAPACK's ``potri`` does the job: the triangular inverse L^-1
(n^3 / 3 operations) and the product L^-T L^-1 (n^3 / 3), so

  - ``sinv_flops``: (2 / 3) n^3 floating-point operations per matrix;
  - ``sinv_bytes``: L read once and S^-1 written once, 16 n^2 bytes of
    float64 per matrix,

times the batch (every axis of L before the last two: the blocks of a
group, a fleet's instances).  For every ``chol_inverse`` call, the least
time the card could take for that work (the larger of the operations at
the FP64 tensor-core peak and the bytes at the HBM bandwidth), summed,
over the device time of the kernels that ran inside the calls' spans
(their union, from the profiler's trace; the spans synchronise the device
at both ends, so those kernels are the call's)."""

import math

from sdpbench import roofline, tracing

SPANS = {"sinv": "hdsdp_tpu_torch.ops.chol:chol_inverse"}


def sinv_flops(n: int, batch: int = 1) -> float:
    return batch * 2.0 * n ** 3 / 3.0


def sinv_bytes(n: int, batch: int = 1, itemsize: int = 8) -> float:
    return batch * 2.0 * itemsize * n * n


def read(rec):
    calls = [s for s in rec.spans if s.name == "sinv" and s.shapes]
    if rec.profile is None or rec.peaks is None or not calls:
        return None
    least = 0.0
    for s in calls:
        shape = s.shapes[0]
        n, batch = shape[-1], math.prod(shape[:-2])
        least += roofline.least_time(sinv_flops(n, batch), sinv_bytes(n, batch),
                                     rec.peaks["fp64_tensor_flops"], rec.peaks["hbm_bytes_per_s"])
    windows = sorted((s, e) for name, s, e in rec.profile.spans if name == "sinv")
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
