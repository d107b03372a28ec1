"""Operations and bytes of the kernels the per-layer rooflines measure, and
the published peaks they are held to (``peaks.json``).

The counts are the logical work of the mathematical operation, as
``benchmarks/roofline.py`` counts it:

  - Cholesky of an [m, m] matrix: m^3 / 3 floating-point operations; its
    bytes: the matrix read once and the factor written once;
  - the slot-major Schur assembly of rank r over m constraints and an
    [n, n] block: r 2 m n^2 (F U) + r (r + 1) / 2 2 m^2 n (the products
    of the slots) operations.

A roofline share is the least time the card could take, the larger of
operations over peak rate and bytes over peak bandwidth, over the time the
kernels took.  It cannot pass 100 % unless the work is over-counted.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

PEAKS = Path(__file__).resolve().with_name("peaks.json")


def peaks(kind: str) -> Optional[dict]:
    """The published peaks of the card named ``kind``, or None."""
    with open(PEAKS) as f:
        return json.load(f).get(kind)


def cholesky_flops(m: int, batch: int = 1) -> float:
    return batch * m ** 3 / 3.0


def cholesky_bytes(m: int, batch: int = 1, itemsize: int = 8) -> float:
    return batch * 2.0 * itemsize * m * m


def schur_assembly_flops(m: int, n: int, r: int) -> float:
    return r * 2.0 * m * n * n + r * (r + 1) / 2.0 * 2.0 * m * m * n


def least_time(flops: float, nbytes: float, peak_flops: float, peak_bw: float) -> float:
    return max(flops / peak_flops, nbytes / peak_bw)
