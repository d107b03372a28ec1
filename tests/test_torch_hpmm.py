"""The port's Ozaki matmul (hdsdp_tpu_torch.ops.hpmm) against the JAX
package's hpmm on the CPU.

On CPU tensors the port runs the plain versions of its two kernels: K1
(matmul_sliced_ref / pairs_ref) and the slicing kernel K1s (slice_ref).
The in-chunk f32 sums are exact in any order and every other operation
follows the JAX code op for op, so every comparison here is bitwise."""

import ctypes
import os
import subprocess
import sys

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdsdp_tpu.ops import dd as jdd
from hdsdp_tpu.ops import hpmm as jhpmm
from hdsdp_tpu_torch.ops import cuda_build
from hdsdp_tpu_torch.ops import hpmm as thpmm
from hdsdp_tpu_torch.ops import hpmm_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(a, b, gmax=5):
    cj = np.asarray(jhpmm.hpmm(a, b, gmax=gmax))
    ct = thpmm.hpmm(torch.as_tensor(a), torch.as_tensor(b), gmax=gmax).numpy()
    return cj, ct


@pytest.mark.parametrize(
    "m,k,n",
    [(50, 300, 40), (37, 300, 45), (101, 100, 101), (64, 256, 64), (20, 513, 7)],
)
def test_hpmm_bitwise_matches_jax(m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    a = rng.standard_normal((m, k))
    b = rng.standard_normal((k, n))
    cj, ct = _both(a, b)
    np.testing.assert_array_equal(ct, cj)


def test_hpmm_wild_scales_bitwise():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((96, 96)) * np.logspace(-30, 30, 96)[:, None]
    b = rng.standard_normal((96, 96)) * np.logspace(25, -25, 96)[None, :]
    cj, ct = _both(a, b)
    np.testing.assert_array_equal(ct, cj)
    ref = a @ b
    rel = np.max(np.abs(ct - ref) / np.max(np.abs(ref), axis=0, keepdims=True))
    assert rel < 1e-12


def test_hpmm_gmax3_bitwise():
    """gmax <= 3 folds every pair (no f32 'high' accumulator)."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((30, 280))
    b = rng.standard_normal((280, 25))
    cj, ct = _both(a, b, gmax=3)
    np.testing.assert_array_equal(ct, cj)


def test_hpmm_nan_propagates_like_jax():
    a = np.ones((8, 8))
    a[3, 4] = np.nan
    cj, ct = _both(a, np.ones((8, 8)))
    assert np.isnan(ct[3]).all()
    assert np.isfinite(ct[0]).all()
    np.testing.assert_array_equal(ct, cj)


def test_matmul_sliced_ref_matches_jax_scan():
    """Same bf16 slices into both pair accumulations."""
    rng = np.random.default_rng(5)
    a_sl = rng.integers(-256, 257, size=(6, 40, 512)) * 2.0 ** -8
    b_sl = rng.integers(-256, 257, size=(6, 512, 33)) * 2.0 ** -8
    a_sl *= 2.0 ** (-8 * np.arange(6))[:, None, None]
    b_sl *= 2.0 ** (-8 * np.arange(6))[:, None, None]
    chj, clj = jhpmm._matmul_sliced(
        jnp.asarray(a_sl, jnp.bfloat16), jnp.asarray(b_sl, jnp.bfloat16), 5
    )
    cht, clt = thpmm.matmul_sliced_ref(
        torch.as_tensor(a_sl, dtype=torch.bfloat16),
        torch.as_tensor(b_sl, dtype=torch.bfloat16), 5,
    )
    np.testing.assert_array_equal(cht.numpy(), np.asarray(chj))
    np.testing.assert_array_equal(clt.numpy(), np.asarray(clj))


def test_slices_match_jax_and_cast_exactly():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((20, 300)) * np.exp(rng.standard_normal((20, 1)) * 4)
    b = rng.standard_normal((300, 9))
    a_sl, b_sl, ea, eb = thpmm.slice_operands(torch.as_tensor(a), torch.as_tensor(b))
    assert a_sl.shape == (6, 20, 512) and b_sl.shape == (6, 512, 9)
    # the JAX prologue on the same operand
    e = jhpmm._exp_of(jnp.max(jnp.abs(jnp.asarray(a)), axis=1, keepdims=True))
    ah, al = jdd.from_f64(jnp.asarray(a) * jhpmm._pow2(-e, jnp.float64))
    ja = np.asarray(jhpmm._pad_k(jhpmm._slices(ah, al, 6), axis=2), np.float32)
    np.testing.assert_array_equal(a_sl.to(torch.float32).numpy(), ja)
    np.testing.assert_array_equal(ea.numpy(), np.asarray(e))
    # the bf16 cast of each slice is exact: redo the f32 truncation
    th, tl = thpmm.dd.from_f64(torch.as_tensor(a) * thpmm._pow2(-ea, torch.float64))
    rh, rl = th, tl
    for t in range(6):
        s = torch.trunc(rh * 2.0 ** (8 * (t + 1))) * 2.0 ** (-8 * (t + 1))
        assert torch.equal(s.to(torch.bfloat16).to(torch.float32), s)
        assert torch.equal(a_sl[t, :, :300].to(torch.float32), s)
        rh, rl = thpmm.dd.two_sum(rh - s, rl)


def test_cpu_path_launches_no_kernel():
    before = thpmm.KERNEL_LAUNCHES
    rng = np.random.default_rng(1)
    thpmm.hpmm(torch.as_tensor(rng.standard_normal((10, 20))),
               torch.as_tensor(rng.standard_normal((20, 5))))
    assert thpmm.KERNEL_LAUNCHES == before


def test_hpmm_pairs_rejects_bad_slices():
    good = torch.zeros((6, 4, 256), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        thpmm.hpmm_pairs(good.float(), torch.zeros((6, 256, 3)), 5)
    with pytest.raises(ValueError):
        thpmm.hpmm_pairs(good[:, :, :100], torch.zeros((6, 100, 3), dtype=torch.bfloat16), 5)
    with pytest.raises(ValueError):
        thpmm.hpmm_pairs(good, torch.zeros((6, 256, 3), dtype=torch.bfloat16), 6)


def test_find_nvcc_raises_without_toolkit(monkeypatch):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_module_imports_without_triton_or_nvcc():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    code = (
        "import sys, hdsdp_tpu_torch.ops.hpmm, hdsdp_tpu_torch.ops.cuda_build;"
        "assert 'triton' not in sys.modules and 'jax' not in sys.modules;"
        "print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _slice_input(case, axis, rng, decades=30):
    """numpy f64 operand [R, C] for a slicing case; K runs along axis."""
    r, c = (23, 300) if axis == 1 else (300, 23)
    x = rng.standard_normal((r, c))
    keep = 1 - axis  # the axis that keeps its entries (rows of A, columns of B)
    shape = [1, 1]
    shape[keep] = x.shape[keep]
    if case == "wild":
        x = x * np.logspace(-decades, decades, x.shape[keep]).reshape(shape)
    elif case == "nan_row":
        x[(3, 5) if axis == 1 else (5, 3)] = np.nan
    elif case == "zero_row":
        if axis == 1:
            x[4, :] = 0.0
        else:
            x[:, 4] = 0.0
    return x


def _jax_slices(x, axis, q, dd_input):
    """The JAX package's prologue for one operand: (slices f32, e)."""
    xj = jnp.asarray(x)
    if dd_input:
        h, l = jdd.from_f64(xj)
        e = jhpmm._exp_of(jnp.max(jnp.abs(h), axis=axis, keepdims=True))
        nh, nl, scale = jhpmm._normalize_dd(h, l, axis)
        np.testing.assert_array_equal(np.asarray(scale), np.asarray(jhpmm._pow2(e, jnp.float32)))
    else:
        e = jhpmm._exp_of(jnp.max(jnp.abs(xj), axis=axis, keepdims=True))
        nh, nl = jdd.from_f64(xj * jhpmm._pow2(-e, jnp.float64))
    sl = jhpmm._pad_k(jhpmm._slices(nh, nl, q), axis=axis + 1)
    return np.asarray(sl, np.float32), np.asarray(e)


@pytest.mark.parametrize("case", ["plain", "wild", "nan_row", "zero_row", "noncontig"])
@pytest.mark.parametrize("dd_input", [False, True], ids=["f64", "dd"])
@pytest.mark.parametrize("axis", [0, 1])
def test_slice_ref_bitwise_matches_jax(axis, dd_input, case):
    rng = np.random.default_rng(100 + 10 * axis + dd_input)
    # a double-single pair must keep its low word a normal f32 (XLA's CPU
    # code flushes subnormals), so its wild case spans fewer decades
    x = _slice_input(case, axis, rng, decades=12 if dd_input else 30)
    xt = torch.as_tensor(x)
    if case == "noncontig":  # a transposed view of column-major storage
        xt = torch.as_tensor(np.ascontiguousarray(x.T)).T
        assert not xt.is_contiguous()
    if dd_input:
        xt = thpmm.dd.from_f64(xt)
    sl, e = thpmm.slice_ref(xt, axis, gmax=5)
    sl_j, e_j = _jax_slices(x, axis, 6, dd_input)
    assert sl.dtype == torch.bfloat16 and e.dtype == torch.int32
    assert sl.shape == ((6, 23, 512) if axis == 1 else (6, 512, 23))
    np.testing.assert_array_equal(sl.to(torch.float32).numpy(), sl_j)
    np.testing.assert_array_equal(e.numpy(), e_j)
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = thpmm.SLICE_LAUNCHES
    sl_w, e_w = thpmm.hpmm_slice(xt, axis, gmax=5)
    assert thpmm.SLICE_LAUNCHES == before
    np.testing.assert_array_equal(sl_w.to(torch.float32).numpy(), sl_j)
    assert torch.equal(e_w, e)


def test_slice_ref_kpad_and_gmax():
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.standard_normal((7, 100)))
    sl, e = thpmm.slice_ref(x, 1, gmax=2, kpad=512)
    assert sl.shape == (3, 7, 512) and e.shape == (7, 1)
    base, _ = thpmm.slice_ref(x, 1, gmax=2)
    assert torch.equal(sl[:, :, :256], base) and not sl[:, :, 256:].any()
    with pytest.raises(ValueError):
        thpmm.slice_ref(x, 1, kpad=300)


@pytest.mark.parametrize("k", [256, 512])
@pytest.mark.parametrize("kind", hpmm_cases.KINDS)
def test_adversarial_slices_exact_at_the_2_24_bound(kind, k):
    """Slices of +-256 units, and of odd units with equal signs: the plain
    version, the JAX scan and an int64 computation of every in-chunk sum
    agree bit for bit."""
    ia, ib = hpmm_cases.adversarial_ints(kind, 19, k, 13, 6, seed=k)
    ch_x, cl_x, peak, low_bits = hpmm_cases.exact_pairs_ref(ia, ib, 5)
    if kind == "same":
        assert peak == 2 ** 24  # the bound is reached
    elif kind == "odd_same":
        assert low_bits and peak == 2 ** 24 - 130816  # 256 * 255 * 255
    elif kind == "odd_random":
        assert low_bits and peak > 2 ** 21  # low bits set in large sums
    else:
        assert not low_bits  # every product is a multiple of 2^16 units
    a_sl, b_sl = hpmm_cases.slices_from_ints(ia), hpmm_cases.slices_from_ints(ib)
    at = torch.as_tensor(a_sl).to(torch.bfloat16)
    bt = torch.as_tensor(b_sl).to(torch.bfloat16)
    assert torch.equal(at.to(torch.float32), torch.as_tensor(a_sl))  # exact in bf16
    ch, cl = thpmm.matmul_sliced_ref(at, bt, 5)
    np.testing.assert_array_equal(ch.numpy(), ch_x)
    np.testing.assert_array_equal(cl.numpy(), cl_x)
    chj, clj = jhpmm._matmul_sliced(jnp.asarray(a_sl, jnp.bfloat16),
                                    jnp.asarray(b_sl, jnp.bfloat16), 5)
    np.testing.assert_array_equal(np.asarray(chj), ch_x)
    np.testing.assert_array_equal(np.asarray(clj), cl_x)
    # and the double-single result is the exact sum to ~2^-45
    exact = sum(
        (ia[t].astype(object) @ ib[u].astype(object)) * 2.0 ** (-8 * (t + u + 2))
        for t in range(6) for u in range(6 - t)
    ).astype(np.float64)
    got = ch.numpy().astype(np.float64) + cl.numpy().astype(np.float64)
    assert np.max(np.abs(got - exact)) <= 2.0 ** -44 * max(np.max(np.abs(exact)), 1.0)


@pytest.mark.parametrize("m,k,n", [(37, 300, 45), (20, 513, 7)])
def test_f64_epilogue_form_equals_two_step_form(m, k, n):
    """hpmm_pairs with its f64 epilogue against the separate rescale that
    hpmm used before the epilogue was fused."""
    rng = np.random.default_rng(m + k)
    a = torch.as_tensor(rng.standard_normal((m, k)) * np.logspace(-9, 9, m)[:, None])
    b = torch.as_tensor(rng.standard_normal((k, n)))
    a_sl, b_sl, ea, eb = thpmm.slice_operands(a, b)
    ch, cl = thpmm.hpmm_pairs(a_sl, b_sl, 5)
    c = ch.to(torch.float64) + cl.to(torch.float64)
    two_step = c * thpmm._pow2(ea, torch.float64) * thpmm._pow2(eb, torch.float64)
    fused = thpmm.hpmm_pairs(a_sl, b_sl, 5, ea, eb, out_f64=True)
    assert fused.dtype == torch.float64
    assert torch.equal(fused, two_step)
    assert torch.equal(thpmm.hpmm(a, b), two_step)
    sh, sl_ = thpmm.hpmm_pairs(a_sl, b_sl, 5, ea, eb)
    s = thpmm._pow2(ea, torch.float32) * thpmm._pow2(eb, torch.float32)
    assert torch.equal(sh, ch * s) and torch.equal(sl_, cl * s)


def _dd_pair(x):
    h = x.astype(np.float32)
    return h, (x - h.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(31, 300, 17), (16, 256, 16), (9, 70, 40)])
def test_hpmm_dd_bitwise_matches_jax(m, k, n):
    rng = np.random.default_rng(m * k)
    ah, al = _dd_pair(rng.standard_normal((m, k)) * np.exp(rng.standard_normal((m, 1)) * 3))
    bh, bl = _dd_pair(rng.standard_normal((k, n)))
    chj, clj = jhpmm.hpmm_dd(*(jnp.asarray(v) for v in (ah, al, bh, bl)))
    ch, cl = thpmm.hpmm_dd(*(torch.as_tensor(v) for v in (ah, al, bh, bl)))
    np.testing.assert_array_equal(ch.numpy(), np.asarray(chj))
    np.testing.assert_array_equal(cl.numpy(), np.asarray(clj))


@pytest.mark.parametrize("m,k", [(33, 300), (12, 256)])
def test_hpmm_dd_syrk_bitwise_matches_jax(m, k):
    rng = np.random.default_rng(m + 7 * k)
    ah, al = _dd_pair(rng.standard_normal((m, k)) * np.logspace(-5, 5, m)[:, None])
    chj, clj = jhpmm.hpmm_dd_syrk(jnp.asarray(ah), jnp.asarray(al))
    ch, cl = thpmm.hpmm_dd_syrk(torch.as_tensor(ah), torch.as_tensor(al))
    np.testing.assert_array_equal(ch.numpy(), np.asarray(chj))
    np.testing.assert_array_equal(cl.numpy(), np.asarray(clj))


@pytest.mark.parametrize("m,k", [(33, 300), (12, 256), (50, 40)])
def test_hpmm_syrk_bitwise_matches_jax(m, k):
    rng = np.random.default_rng(3 * m + k)
    a = rng.standard_normal((m, k)) * np.logspace(-20, 20, m)[:, None]
    cj = np.asarray(jhpmm.hpmm_syrk(jnp.asarray(a)))
    ct = thpmm.hpmm_syrk(torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("m,k,n", [(21, 300, 5), (40, 100, 40)])
def test_hpmm_presliced_bitwise_matches_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k))
    a_slj, eaj = jhpmm.hpmm_slice_a(jnp.asarray(a))
    a_sl, ea = thpmm.hpmm_slice_a(torch.as_tensor(a))
    np.testing.assert_array_equal(a_sl.to(torch.float32).numpy(), np.asarray(a_slj, np.float32))
    np.testing.assert_array_equal(ea.numpy(), np.asarray(eaj))
    for seed in (1, 2):  # one pre-sliced operand serves several products
        b = np.random.default_rng(seed).standard_normal((k, n)) * 10.0 ** seed
        cj = np.asarray(jhpmm.hpmm_presliced(a_slj, eaj, jnp.asarray(b)))
        ct = thpmm.hpmm_presliced(a_sl, ea, torch.as_tensor(b)).numpy()
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(ct, thpmm.hpmm(torch.as_tensor(a), torch.as_tensor(b)).numpy())


def test_hpmm_presliced_matches_a_wider_k_pad():
    """b's K pad follows the pre-sliced operand's (the JAX package pads
    b_sl up to a_sl's width)."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((10, 100))
    b = rng.standard_normal((100, 6))
    a_slj, eaj = jhpmm.hpmm_slice_a(jnp.asarray(a))
    a_slj = jnp.pad(a_slj, ((0, 0), (0, 0), (0, 256)))
    a_sl, ea = thpmm.hpmm_slice(torch.as_tensor(a), 1, kpad=512)
    assert a_sl.shape == (6, 10, 512)
    cj = np.asarray(jhpmm.hpmm_presliced(a_slj, eaj, jnp.asarray(b)))
    ct = thpmm.hpmm_presliced(a_sl, ea, torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(ct, cj)


def test_hpmm_slice_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 8), dtype=torch.float64)
    with pytest.raises(TypeError):
        thpmm.hpmm_slice(x.float(), 1)
    with pytest.raises(TypeError):
        thpmm.hpmm_slice((x, x), 1)  # an f64 pair
    with pytest.raises(TypeError):
        thpmm.hpmm_slice(x[0], 1)  # not 2-d
    with pytest.raises(ValueError):
        thpmm.hpmm_slice((x.float(), x.float()[:2]), 1)
    with pytest.raises(ValueError):
        thpmm.hpmm_slice(x, 2)


def test_hpmm_pairs_rejects_bad_exponents():
    a_sl = torch.zeros((6, 4, 256), dtype=torch.bfloat16)
    b_sl = torch.zeros((6, 256, 3), dtype=torch.bfloat16)
    ea = torch.zeros((4, 1), dtype=torch.int32)
    eb = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        thpmm.hpmm_pairs(a_sl, b_sl, 5, ea, None)
    with pytest.raises(ValueError):
        thpmm.hpmm_pairs(a_sl, b_sl, 5, out_f64=True)
    with pytest.raises(ValueError):
        thpmm.hpmm_pairs(a_sl, b_sl, 5, ea, eb.long())
    with pytest.raises(ValueError):
        thpmm.hpmm_pairs(a_sl, b_sl, 5, eb, ea)  # M and N swapped
    assert thpmm.hpmm_pairs(a_sl, b_sl, 5, ea, eb, out_f64=True).shape == (4, 3)


@pytest.mark.parametrize("name", sorted(cuda_build.SIGNATURES))
def test_ctypes_signatures_match_the_c_entry_points(name):
    """Every kernel source has its argtypes registered, one per C
    parameter and of the matching kind."""
    src = (cuda_build.CSRC / f"{name}.cu").read_text()
    for fn_name, argtypes in cuda_build.SIGNATURES[name].items():
        decl = re.search(r'extern "C" int ' + fn_name + r"\(([^)]*)\)", src)
        assert decl, f"{fn_name} is not declared in {name}.cu"
        params = [p.strip() for p in decl.group(1).split(",")]
        assert len(params) == len(argtypes)
        for param, ctype in zip(params, argtypes):
            want = (ctypes.c_void_p if "*" in param
                    else ctypes.c_longlong if param.startswith("long long") else ctypes.c_int)
            assert ctype is want, (param, ctype)
    assert sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")) == sorted(cuda_build.SIGNATURES)


@pytest.mark.cuda
def test_slice_kernel_bitwise_equals_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.standard_normal((501, 500)), device="cuda")
    for operand in (x, x.T, thpmm.dd.from_f64(x)):
        for axis in (0, 1):
            before = thpmm.SLICE_LAUNCHES
            sl, e = thpmm.hpmm_slice(operand, axis)
            assert thpmm.SLICE_LAUNCHES == before + 1
            sl_r, e_r = thpmm.slice_ref(operand, axis)
            torch.cuda.synchronize()
            assert torch.equal(sl, sl_r) and torch.equal(e, e_r)


@pytest.mark.cuda
def test_hpmm_is_three_launches_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(9)
    a = torch.as_tensor(rng.standard_normal((64, 300)), device="cuda")
    b = torch.as_tensor(rng.standard_normal((300, 48)), device="cuda")
    k0, s0 = thpmm.KERNEL_LAUNCHES, thpmm.SLICE_LAUNCHES
    c = thpmm.hpmm(a, b)
    assert (thpmm.KERNEL_LAUNCHES - k0, thpmm.SLICE_LAUNCHES - s0) == (1, 2)
    a_sl, b_sl, ea, eb = (t.cpu() for t in thpmm.slice_operands(a, b))
    assert torch.equal(c.cpu(), thpmm.pairs_ref(a_sl, b_sl, 5, ea, eb, out_f64=True))


@pytest.mark.cuda
def test_kernel_bitwise_equals_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    for m, k, n in [(501, 500, 500), (501, 500, 501), (37, 300, 45)]:
        a = torch.as_tensor(rng.standard_normal((m, k)), device="cuda")
        b = torch.as_tensor(rng.standard_normal((k, n)), device="cuda")
        a_sl, b_sl, _, _ = thpmm.slice_operands(a, b)
        before = thpmm.KERNEL_LAUNCHES
        ch, cl = thpmm.hpmm_pairs(a_sl, b_sl, 5)
        assert thpmm.KERNEL_LAUNCHES == before + 1
        rh, rl = thpmm.matmul_sliced_ref(a_sl, b_sl, 5)
        torch.cuda.synchronize()
        assert torch.equal(ch, rh) and torch.equal(cl, rl)
    # the kernel stages K-contiguous rows only; anything else is refused
    with pytest.raises(ValueError, match="K-contiguous"):
        thpmm.hpmm_pairs(a_sl, b_sl.contiguous(), 5)


# -- the fleet axis (solver.batch): K1/K1s take N same-shape operands ------


def _fleet_operands(seed, n_f, m, k, n, b_view=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_f, m, k)) * np.logspace(-3, 3, m)[None, :, None]
    b = rng.standard_normal((n_f, k, n))
    bt = torch.as_tensor(b)
    if b_view:  # the pair products' B: a transposed view, as ops/schur.py passes it
        bt = torch.as_tensor(np.ascontiguousarray(np.swapaxes(b, 1, 2))).transpose(1, 2)
    return a, b, torch.as_tensor(a), bt


@pytest.mark.parametrize("n_f,m,k,n,b_view", [(3, 37, 300, 45, False), (4, 21, 256, 21, True),
                                              (2, 9, 513, 5, False)])
def test_fleet_hpmm_equals_stacked_singles_and_jax_vmap(n_f, m, k, n, b_view):
    """A fleet's product is bitwise the stack of its single products, and
    bitwise jax.vmap of the JAX package's hpmm."""
    import jax

    a, b, ta, tb = _fleet_operands(n_f * 100 + m, n_f, m, k, n, b_view)
    fleet = thpmm.hpmm(ta, tb)
    singles = torch.stack([thpmm.hpmm(ta[i], tb[i]) for i in range(n_f)])
    assert torch.equal(fleet, singles)
    cj = np.asarray(jax.vmap(jhpmm.hpmm)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(fleet.numpy(), cj)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dd_input", [False, True], ids=["f64", "dd"])
def test_fleet_slice_ref_equals_stacked_singles(axis, dd_input):
    rng = np.random.default_rng(11 + axis)
    x = torch.as_tensor(rng.standard_normal((3, 40, 300)) * np.logspace(-20, 20, 40)[:, None])
    x[1, 5, 7] = float("nan")
    op = thpmm.dd.from_f64(x) if dd_input else x
    sl, e = thpmm.slice_ref(op, axis)
    assert sl.shape[:2] == (3, 6) and e.shape[0] == 3
    for i in range(3):
        sl_i, e_i = thpmm.slice_ref(tuple(t[i] for t in op) if dd_input else op[i], axis)
        assert torch.equal(sl[i].isnan(), sl_i.isnan())
        assert torch.equal(sl[i].nan_to_num(), sl_i.nan_to_num()) and torch.equal(e[i], e_i)


@pytest.mark.parametrize("out_f64", [False, True])
def test_fleet_pairs_ref_equals_stacked_singles(out_f64):
    _, _, ta, tb = _fleet_operands(5, 3, 30, 300, 17)
    a_sl, b_sl, ea, eb = thpmm.slice_operands(ta, tb)
    assert a_sl.shape == (3, 6, 30, 512) and b_sl.shape == (3, 6, 512, 17)
    assert ea.shape == (3, 30, 1) and eb.shape == (3, 1, 17)
    got = thpmm.hpmm_pairs(a_sl, b_sl, 5, ea, eb, out_f64=out_f64)
    for i in range(3):
        want = thpmm.pairs_ref(a_sl[i], b_sl[i], 5, ea[i], eb[i], out_f64=out_f64)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g[i], w)
    ch, cl = thpmm.matmul_sliced_ref(a_sl, b_sl, 5)
    assert torch.equal(ch[1], thpmm.matmul_sliced_ref(a_sl[1], b_sl[1], 5)[0])


def test_fleet_hpmm_pairs_rejects_mismatched_fleets():
    a_sl = torch.zeros((2, 6, 4, 256), dtype=torch.bfloat16)
    b_sl = torch.zeros((3, 6, 256, 3), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        thpmm.hpmm_pairs(a_sl, b_sl, 5)
    with pytest.raises(ValueError):
        thpmm.hpmm_pairs(a_sl, b_sl[0], 5)
    ea = torch.zeros((2, 4, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        thpmm.hpmm_pairs(a_sl, b_sl[:2], 5, ea, torch.zeros((1, 3), dtype=torch.int32))


@pytest.mark.cuda
def test_fleet_kernels_bitwise_equal_single_launches_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(12)
    fs = torch.as_tensor(rng.standard_normal((4, 501, 500)), device="cuda")
    u = torch.as_tensor(rng.standard_normal((4, 500, 500)), device="cuda")
    for a, b in ((fs, u), (fs, fs.transpose(1, 2))):
        k0, s0 = thpmm.KERNEL_LAUNCHES, thpmm.SLICE_LAUNCHES
        c = thpmm.hpmm(a, b)
        assert (thpmm.KERNEL_LAUNCHES - k0, thpmm.SLICE_LAUNCHES - s0) == (1, 2)
        singles = torch.stack([thpmm.hpmm(a[i], b[i]) for i in range(4)])
        a_sl, b_sl, ea, eb = (t.cpu() for t in thpmm.slice_operands(a, b))
        torch.cuda.synchronize()
        assert torch.equal(c, singles)
        assert torch.equal(c.cpu(), thpmm.pairs_ref(a_sl, b_sl, 5, ea, eb, out_f64=True))
