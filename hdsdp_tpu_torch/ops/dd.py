"""Double-single ("DD") arithmetic on float32 tensors.

A value is an unevaluated pair (hi, lo) of f32 tensors with x = hi + lo
and |lo| <= ulp(hi)/2, about 48 mantissa bits (ref: the JAX package's
ops/dd.py).  These primitives are error-free transformations WITHOUT
fused multiply-add: Dekker's splitting (two_prod) and Knuth's two_sum,
exact in round-to-nearest f32.  Every product and every sum is its own
torch operation, so nothing can contract ``a * b + c`` into an FMA (which
would make two_prod's error term wrong); the CUDA kernel that shares these
semantics (csrc/dd_panel.cu) spells each step with ``__fmul_rn`` and
friends for the same reason.

All functions are shape-polymorphic and elementwise, except
:func:`dd_sum`, whose binary tree is the JAX package's, pair for pair.

Caveats (as in the JAX package):
  * f32 exponent range: callers pre-scale so magnitudes stay within
    ~1e-30..1e30;
  * the Dekker split multiplies by 4097: inputs above ~8e34 overflow.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SPLIT = 4097.0  # 2^12 + 1 (f32: 24-bit mantissa -> 12/12 split)


def two_sum(a, b):
    """s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """s + e == a + b exactly, REQUIRES |a| >= |b| (Dekker)."""
    s = a + b
    return s, b - (s - a)


def split(a):
    """a == hi + lo with hi, lo having <= 12 mantissa bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly (Dekker, FMA-free)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def add(xh, xl, yh, yl):
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return quick_two_sum(s, e)


def sub(xh, xl, yh, yl):
    return add(xh, xl, -yh, -yl)


def mul(xh, xl, yh, yl):
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def scale(xh, xl, c):
    """Multiply by an exact f32 scalar (e.g. a power of two)."""
    p, e = two_prod(xh, c)
    e = e + xl * c
    return quick_two_sum(p, e)


def fma(xh, xl, yh, yl, ah, al):
    """x * y + a in DD."""
    ph, pl = mul(xh, xl, yh, yl)
    return add(ph, pl, ah, al)


def div(xh, xl, yh, yl):
    """Two-step Newton quotient, ~full DD accuracy."""
    q1 = xh / yh
    ph, pl = mul(q1, torch.zeros_like(q1), yh, yl)
    rh, rl = add(xh, xl, -ph, -pl)
    q2 = (rh + rl) / yh
    return quick_two_sum(q1, q2)


def inv(yh, yl):
    return div(torch.ones_like(yh), torch.zeros_like(yh), yh, yl)


def sqrt(xh, xl):
    """One DD Newton refinement of the f32 sqrt.

    sqrt of a negative hi word is NaN and a zero one divides by zero; both
    propagate through every DD op, which keeps the try-Cholesky PSD
    predicate (ref hdsdp_linsolver.c:1112-1144).

    The f32 square root is taken in f64 and rounded once to f32, which is
    the correctly rounded f32 root (53 >= 2 * 24 + 2 bits, so the double
    rounding is exact): torch's vectorized f32 sqrt on the CPU is not
    correctly rounded in every case, IEEE's (the card's __fsqrt_rn, XLA's)
    is."""
    s = torch.sqrt(xh.to(torch.float64)).to(torch.float32)
    ph, pl = two_prod(s, s)
    rh, rl = add(xh, xl, -ph, -pl)
    r = (rh + rl) / (2.0 * s)
    return quick_two_sum(s, r)


def dd_sum(h, l, axis: int):
    """Sum a DD array along ``axis`` with the JAX package's binary tree:
    the axis is padded with zeros to a power of two p, then halved until
    one entry is left, element i taking element i + p/2 each time.

    A plain f32 sum would cap accuracy at ~K 2^-24; the tree keeps the
    compensation term at DD (~2^-45) level."""
    n = h.shape[axis]
    h = torch.movedim(h, axis, 0)
    l = torch.movedim(l, axis, 0)
    p = 1
    while p < n:
        p *= 2
    if p != n:
        pad = [0, 0] * (h.ndim - 1) + [0, p - n]
        h, l = F.pad(h, pad), F.pad(l, pad)
    while p > 1:
        p //= 2
        ah, al, bh, bl = h[:p], l[:p], h[p:], l[p:]
        s, e = two_sum(ah, bh)
        h, l = quick_two_sum(s, e + al + bl)
    return h[0], l[0]


def from_f64(x: torch.Tensor):
    """Exact f64 -> DD (f64 has 52 mantissa bits; DD keeps the top ~48)."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def to_f64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return hi.to(torch.float64) + lo.to(torch.float64)
