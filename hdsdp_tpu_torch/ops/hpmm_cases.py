"""Adversarial inputs for the Ozaki pair accumulation, with an exact
integer reference.

The pair kernel's in-chunk sums are exact only because every slice is an
integer of magnitude <= 256 times its unit 2^-8(t+1), so that any partial
sum of one 256-wide chunk is an integer of magnitude <= 2^24 times the
pair's unit.  The cases here sit on that limit.  With every slice entry
+-256 units a chunk's sum of equal signs reaches 2^24 units exactly, and
mixed signs walk every partial sum up and down below it; but every such
product is a multiple of 2^16 units, so these cases say nothing about the
low bits.  The odd cases do: with equal signs and odd magnitudes <= 255
every product is odd, and the partial sums climb to 2^24 - 2^17 units
with their low bits set, so an accumulation that kept fewer than 24 bits
below its largest exponent would lose them.  The reference computes every in-chunk sum in int64 (no rounding anywhere),
converts it to f32 (exact, by the same bound) and folds in numpy f32 in
the reference order.  Both the CPU tests and ``chip_smoke.py`` hold the
plain version and the CUDA kernel to it bit for bit.
"""

from __future__ import annotations

import numpy as np

CHUNK = 256
KINDS = ("same", "alternating", "random", "odd_same", "odd_random")


def adversarial_ints(kind: str, m: int, k: int, n: int, q: int, seed: int = 0):
    """Integer slices (ia [q, m, k], ib [q, k, n]) at the exactness bound.

    ``same``: all +256 (each chunk sum is 2^24 units); ``alternating``:
    a's sign flips along k (partial sums swing between 0 and 2^16 units);
    ``random``: +-256 with independent random signs on both operands;
    ``odd_same``: all +255 (odd products of 65025 units, chunk sums of
    2^24 - 130816 units); ``odd_random``: random odd magnitudes <= 255,
    all positive (partial and chunk sums with arbitrary low bits)."""
    ia = np.full((q, m, k), 256, dtype=np.int64)
    ib = np.full((q, k, n), 256, dtype=np.int64)
    if kind == "odd_same":
        ia[:] = 255
        ib[:] = 255
    elif kind == "odd_random":
        rng = np.random.default_rng(seed)
        ia = 2 * rng.integers(0, 128, size=ia.shape) + 1
        ib = 2 * rng.integers(0, 128, size=ib.shape) + 1
    elif kind == "alternating":
        ia[:, :, 1::2] = -256
    elif kind == "random":
        rng = np.random.default_rng(seed)
        ia *= rng.choice(np.array([-1, 1]), size=ia.shape)
        ib *= rng.choice(np.array([-1, 1]), size=ib.shape)
    elif kind != "same":
        raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
    return ia, ib


def slices_from_ints(ints: np.ndarray) -> np.ndarray:
    """f32 slice values ints[t] * 2^-8(t+1); every one is exact in bf16
    (an integer of <= 9 bits times a power of two)."""
    q = ints.shape[0]
    unit = 2.0 ** (-8.0 * (np.arange(q) + 1))
    return (ints * unit.reshape(q, 1, 1)).astype(np.float32)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def exact_pairs_ref(ia: np.ndarray, ib: np.ndarray, gmax: int):
    """(Ch, Cl) f32 of the pair accumulation with every in-chunk sum p_tu
    computed in int64; also returns the largest |p_tu| met, in units of
    its pair, to show that a case reaches the 2^24 bound, and whether some
    p_tu had a bit set below 2^16 units (a chunk of 256 odd products sums
    to an even number, so bit 0 itself shows only in the partial sums)."""
    _, m, k = ia.shape
    n = ib.shape[2]
    if k % CHUNK:
        raise ValueError(f"K = {k} is not a multiple of {CHUNK}")
    ch = np.zeros((m, n), np.float32)
    cl = np.zeros((m, n), np.float32)
    peak, low_bits = 0, False
    for c0 in range(0, k, CHUNK):
        high = None
        for g in range(gmax + 1):
            for t in range(g + 1):
                units = ia[t, :, c0:c0 + CHUNK] @ ib[g - t, c0:c0 + CHUNK, :]
                peak = max(peak, int(np.abs(units).max()))
                low_bits = low_bits or bool((units & 0xFFFF).any())
                p = units.astype(np.float64) * 2.0 ** (-8.0 * (g + 2))
                assert np.array_equal(p.astype(np.float32).astype(np.float64), p)
                p = p.astype(np.float32)
                if g <= 3:
                    s, e = _two_sum(ch, p)
                    t2 = e + cl
                    ch = s + t2
                    cl = t2 - (ch - s)
                else:
                    high = p if high is None else high + p
        if high is not None:
            s, e = _two_sum(ch, high)
            t2 = e + cl
            ch = s + t2
            cl = t2 - (ch - s)
    return ch, cl, peak, low_bits
