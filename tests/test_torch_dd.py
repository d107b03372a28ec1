"""The port's double-single arithmetic (ops/dd.py) against the JAX
package's on identical seeded numpy inputs, bit for bit.

The JAX functions are called eagerly, one XLA operation each, as the
reference's semantics intend (no fused multiply-add): inside a jitted
program XLA's CPU backend contracts a * b - c into an FMA, which moves the
low words of two_prod and everything built on it (see
tests/test_torch_ddchol.py, which holds jitted results to 1e-12 instead)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdsdp_tpu.ops import dd as jdd
from hdsdp_tpu_torch.ops import dd as tdd


def _pair(rng, shape, scale=1.0):
    """A DD pair (hi, lo) of f32 arrays with |lo| <= ulp(hi)/2."""
    x = rng.standard_normal(shape) * scale
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _same_bits(t, j) -> bool:
    """Bit-for-bit equality, signed zeros told apart, NaN equal to NaN."""
    t = t.numpy()
    j = np.asarray(j)
    if t.shape != j.shape or t.dtype != j.dtype:
        return False
    nt, nj = np.isnan(t), np.isnan(j)
    return bool(np.array_equal(nt, nj)
                and np.array_equal(np.where(nt, 0, t).view(np.int32),
                                   np.where(nj, 0, j).view(np.int32)))


def _both(name, *arrays):
    jout = getattr(jdd, name)(*(jnp.asarray(a) for a in arrays))
    tout = getattr(tdd, name)(*(torch.as_tensor(a) for a in arrays))
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    return jout, tout


# scales: unit, wild (1e-12..1e12 an entry, so that products, quotients and
# low words stay inside the f32 range ops/dd.py states: XLA's CPU backend
# flushes subnormals to zero and torch does not) and uniformly small
SCALES = {"unit": 1.0, "wild": np.logspace(-12, 12, 4000), "small": 1e-9}


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("name", ["add", "sub", "mul", "div", "fma"])
def test_binary_ops_bitwise(name, scale):
    rng = np.random.default_rng(len(name))
    s = SCALES[scale]
    args = [*_pair(rng, 4000, s), *_pair(rng, 4000, s)]
    if name == "fma":
        args += list(_pair(rng, 4000, s))
    jout, tout = _both(name, *args)
    assert all(_same_bits(t, j) for t, j in zip(tout, jout))


@pytest.mark.parametrize("name", ["split", "two_prod", "two_sum", "quick_two_sum", "inv",
                                  "scale"])
def test_unary_and_error_free_ops_bitwise(name):
    rng = np.random.default_rng(7)
    h, l = _pair(rng, 4000, np.logspace(-15, 15, 4000))
    b = rng.standard_normal(4000).astype(np.float32)
    args = {
        "split": (h,), "two_prod": (h, b), "two_sum": (h, b),
        "quick_two_sum": (np.maximum(np.abs(h), np.abs(b)), np.minimum(np.abs(h), np.abs(b))),
        "inv": (h, l), "scale": (h, l, np.float32(0.25) * np.ones(4000, np.float32)),
    }[name]
    jout, tout = _both(name, *args)
    assert all(_same_bits(t, j) for t, j in zip(tout, jout))


def test_sqrt_bitwise_and_its_psd_semantics():
    """sqrt is the PSD predicate: NaN from a negative hi word, a division
    by zero from a zero one; bitwise elsewhere, wild scales included.  The
    port's f32 root is taken in f64 and rounded once (torch's vectorized
    f32 sqrt on the CPU is not correctly rounded in every case)."""
    rng = np.random.default_rng(3)
    h, l = _pair(rng, 4000, np.logspace(-25, 25, 4000))
    h = np.abs(h)
    h[:4], l[:4] = [-1.0, -1e-30, 0.0, -0.0], [0.0, 1e-40, 0.0, 0.0]
    jout, tout = _both("sqrt", h, l)
    assert all(_same_bits(t, j) for t, j in zip(tout, jout))
    assert np.isnan(tout[0][:2].numpy()).all() and not np.isfinite(tout[1][2:4].numpy()).all()
    assert np.isfinite(tout[0][4:].numpy()).all()


@pytest.mark.parametrize("n", [1, 2, 5, 8, 100, 256, 257])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_dd_sum_tree_bitwise(n, axis):
    """The tree pads to a power of two and pairs i with i + p/2: the same
    pairs as the JAX package at every length, along every axis."""
    rng = np.random.default_rng(n)
    shape = [3, 4]
    shape[axis] = n
    h, l = _pair(rng, tuple(shape), 1e3)
    jout = jdd.dd_sum(jnp.asarray(h), jnp.asarray(l), axis=axis)
    tout = tdd.dd_sum(torch.as_tensor(h), torch.as_tensor(l), axis=axis)
    assert all(_same_bits(t, j) for t, j in zip(tout, jout))
    # DD accuracy: the tree keeps ~2^-45 of the exact sum
    exact = np.sum(h.astype(np.float64) + l.astype(np.float64), axis=axis)
    got = tout[0].numpy().astype(np.float64) + tout[1].numpy().astype(np.float64)
    assert np.max(np.abs(got - exact)) <= 1e-11 * max(np.max(np.abs(exact)), 1.0)


def test_f64_round_trip():
    rng = np.random.default_rng(11)
    x = rng.standard_normal(1000) * np.logspace(-25, 25, 1000)
    jh, jl = jdd.from_f64(jnp.asarray(x))
    th, tl = tdd.from_f64(torch.as_tensor(x))
    assert _same_bits(th, jh) and _same_bits(tl, jl)
    back = tdd.to_f64(th, tl)
    assert np.array_equal(back.numpy(), np.asarray(jdd.to_f64(jh, jl)))
    assert np.max(np.abs(back.numpy() - x) / np.abs(x)) < 2.0 ** -44
