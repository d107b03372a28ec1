"""High-precision matmul via bf16 mantissa slicing (Ozaki scheme).

The JAX package uses this to get ~48-bit-accurate products out of the
TPU's bf16 matrix unit.  The port keeps the same numerics so that the
``kkt_hp="on"`` Schur assembly is bit-for-bit the same algorithm:

  1. scale each row of A (column of B) by a power of two so the row max
     lands in ~[0.5, 1) (exact);
  2. cut each normalized value into q = gmax + 1 bf16 slices of 8 bits
     (steps 1 and 2: kernel K1s, ``csrc/hpmm_slice.cu``, one launch per
     operand);
  3. for each slice pair (t, u) with t + u <= gmax, accumulate the bf16
     products in f32, exactly within 256-wide K chunks, and fold the pairs
     into a double-single (hi, lo) accumulator (kernel K1,
     ``csrc/hpmm_pairs.cu``);
  4. rescale in f64 (K1's epilogue).

Result: C = A @ B with relative error ~2^-45.  On a CUDA tensor one
:func:`hpmm` is three kernel launches (:func:`hpmm_slice` twice, then
:func:`hpmm_pairs` with its f64 epilogue) and no other device work.  For
CPU tensors, and only for them, the wrappers run the plain versions
:func:`slice_ref` and :func:`matmul_sliced_ref`.

Every function also takes a FLEET: operands with one leading axis of N
same-shape instances (a [N, M, K], b [N, K, N'], slices [N, q, M, Kp] and
[N, q, Kp, N'], exponents [N, M, 1] and [N, 1, N']), as ``jax.vmap`` of
the JAX package's hpmm gives its Pallas kernel one more grid axis.  On the
card the fleet is one more grid dimension of each kernel, so a fleet's
product is still three launches, and each instance's result is bitwise
the one its single launch gives.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hdsdp_tpu_torch.ops import dd

_CHUNK = 256  # K-chunk size for exact in-chunk f32 accumulation
_KERNEL_MAX_GMAX = 7  # both CUDA kernels take gmax 0..7

# Launches of the CUDA kernels (hpmm_pairs_launch, hpmm_slice_launch); the
# plain versions and the CPU path never count.
KERNEL_LAUNCHES = 0
SLICE_LAUNCHES = 0


def _exp_of(m: torch.Tensor) -> torch.Tensor:
    """Power-of-two exponent of positive m via f32 frexp (the JAX
    package takes it from the f32 cast; the port matches it bit for bit).
    Clamping to the f32 normal range means inputs outside ~[1e-36, 1e36]
    get cruder normalization; the f64 rescale absorbs it."""
    mf = torch.clamp(m, 2.0**-120, 2.0**120).to(torch.float32)
    return torch.frexp(mf).exponent


def _pow2(e: torch.Tensor, dtype) -> torch.Tensor:
    """Exact 2^e for |e| <= 126, built in f32 then cast."""
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e).to(dtype)


def _slices(nh: torch.Tensor, nl: torch.Tensor, q: int, dim: int = 0) -> torch.Tensor:
    """q bf16 slices of 8 bits each from normalized DD values, stacked
    along ``dim`` (1 for a fleet).

    Slice t holds bits [8t, 8t+8) below the unit scale and has <= 9
    significant bits, so the bf16 cast is exact."""
    out = []
    rh, rl = nh, nl
    for t in range(q):
        # truncate rh to a multiple of 2^-8(t+1); powers of two are exact
        s = torch.trunc(rh * 2.0 ** (8 * (t + 1))) * 2.0 ** (-8 * (t + 1))
        out.append(s.to(torch.bfloat16))
        # rh - s is exact; two_sum pulls rl's bits into later slices
        rh, rl = dd.two_sum(rh - s, rl)
    return torch.stack(out, dim=dim)


def _padded_k(k_dim: int, kpad: int | None) -> int:
    """K rounded up to a multiple of 256, or the caller's larger pad."""
    kp = k_dim + (-k_dim) % _CHUNK
    if kpad is None:
        return kp
    if kpad < kp or kpad % _CHUNK:
        raise ValueError(f"kpad = {kpad} must be a multiple of {_CHUNK} and >= {kp}")
    return kpad


def _split_operand(x):
    """(h, l or None) of a slicing input: one f64 matrix, or an f32
    double-single pair; 2-d, or 3-d for a fleet."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.float64 or x.ndim not in (2, 3):
            raise TypeError("hpmm_slice takes a 2-d (3-d for a fleet) float64 tensor "
                            "or an (h, l) float32 pair")
        return x, None
    h, l = x
    if not (isinstance(h, torch.Tensor) and isinstance(l, torch.Tensor)
            and h.dtype == l.dtype == torch.float32 and h.ndim in (2, 3)):
        raise TypeError("hpmm_slice takes a 2-d (3-d for a fleet) float64 tensor "
                        "or an (h, l) float32 pair")
    if h.shape != l.shape or h.device != l.device:
        raise ValueError("the (h, l) pair disagrees in shape or device")
    return h, l


def slice_ref(x, axis: int, gmax: int = 5, kpad: int | None = None):
    """Plain PyTorch version of the slicing kernel K1s.

    x is an f64 matrix or an f32 double-single pair (h, l); axis is the
    axis the scale is taken over and K runs along: 1 for a left operand
    [M, K] (row scales), 0 for a right operand [K, N] (column scales).
    Returns (slices [q, M, Kp] or [q, Kp, N] bf16 with K zero-padded to a
    multiple of 256, e int32 [M, 1] or [1, N]: the scales are 2^e).  A
    fleet x [B, ., .] gives slices [B, q, ., .] and exponents [B, ., .]."""
    h, l = _split_operand(x)
    fleet = h.ndim - 2
    ax = axis + fleet
    e = _exp_of(torch.amax(torch.abs(h), dim=ax, keepdim=True))
    inv = _pow2(-e, h.dtype)  # exact scaling
    nh, nl = dd.from_f64(h * inv) if l is None else (h * inv, l * inv)
    sl = _slices(nh, nl, gmax + 1, dim=fleet)
    pad = _padded_k(h.shape[ax], kpad) - h.shape[ax]
    if pad:
        sl = F.pad(sl, [0, pad] if axis == 1 else [0, 0, 0, pad])
    return sl.contiguous(), e


def hpmm_slice(x, axis: int, gmax: int = 5, kpad: int | None = None):
    """Slices and scale exponents of one operand (see :func:`slice_ref`):
    the CUDA kernel K1s for CUDA tensors, the plain version for CPU
    tensors.  On the card a right operand's slices come back as the
    [q, Kp, N] view of K-contiguous [q, N, Kp] storage, the layout K1
    reads fastest.  A fleet [B, ., .] is one launch (B grid rows)."""
    global SLICE_LAUNCHES
    if axis not in (0, 1):
        raise ValueError(f"axis = {axis} must be 0 or 1")
    h, l = _split_operand(x)
    if h.device.type == "cpu":
        return slice_ref(x, axis, gmax, kpad)
    if h.device.type != "cuda":
        raise ValueError(f"hpmm_slice: unsupported device {h.device}")
    if not 0 <= gmax <= _KERNEL_MAX_GMAX:
        raise ValueError(f"the CUDA kernel takes 0 <= gmax <= {_KERNEL_MAX_GMAX}, got {gmax}")
    from hdsdp_tpu_torch.ops import cuda_build

    lib, _ = cuda_build.load("hpmm_slice")
    q = gmax + 1
    fleet = h.ndim - 2
    batch = h.shape[0] if fleet else 1
    keep_ax, k_ax = 1 - axis + fleet, axis + fleet
    n_keep, k_dim = h.shape[keep_ax], h.shape[k_ax]
    kp = _padded_k(k_dim, kpad)
    lead = (batch,) if fleet else ()
    out = torch.empty(lead + (q, n_keep, kp), dtype=torch.bfloat16, device=h.device)
    e = torch.empty(lead + (n_keep,), dtype=torch.int32, device=h.device)

    def strides(t):
        return (t.stride(0) if fleet else 0, t.stride(keep_ax), t.stride(k_ax))

    with torch.cuda.device(h.device):
        err = lib.hpmm_slice_launch(
            h.data_ptr(), None if l is None else l.data_ptr(),
            out.data_ptr(), e.data_ptr(), n_keep, k_dim, kp, q, batch,
            *strides(h), *((0, 0, 0) if l is None else strides(l)),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hpmm_slice kernel launch failed: cudaError {err}")
    SLICE_LAUNCHES += 1
    if axis == 1:
        return out, e.view(lead + (n_keep, 1))
    return out.transpose(-1, -2), e.view(lead + (1, n_keep))


def matmul_sliced_ref(a_sl: torch.Tensor, b_sl: torch.Tensor, gmax: int):
    """Plain PyTorch version of the pair accumulation (the JAX package's
    ``_matmul_sliced``): a_sl [q, M, K] bf16, b_sl [q, K, N] bf16, K a
    multiple of 256, or a fleet of both ([B, q, M, K], [B, q, K, N]).
    Returns (Ch, Cl) f32 [M, N] ([B, M, N]) in normalized units."""
    m_dim, k_dim = a_sl.shape[-2:]
    n_dim = b_sl.shape[-1]
    ch = torch.zeros(a_sl.shape[:-3] + (m_dim, n_dim), dtype=torch.float32,
                     device=a_sl.device)
    cl = torch.zeros_like(ch)
    for c0 in range(0, k_dim, _CHUNK):
        ac = a_sl[..., c0:c0 + _CHUNK].to(torch.float32)
        bc = b_sl[..., c0:c0 + _CHUNK, :].to(torch.float32)
        high = None  # f32 accumulator for pairs with t+u >= 4
        for g in range(gmax + 1):
            for t in range(g + 1):
                # exact in any order (module docstring), so a fleet's
                # batched product equals its single ones bit for bit
                p = ac[..., t, :, :] @ bc[..., g - t, :, :]
                if g <= 3:
                    s, e = dd.two_sum(ch, p)
                    ch, cl = dd.quick_two_sum(s, e + cl)
                else:
                    high = p if high is None else high + p
        if high is not None:
            s, e = dd.two_sum(ch, high)
            ch, cl = dd.quick_two_sum(s, e + cl)
    return ch, cl


def pairs_ref(a_sl, b_sl, gmax, ea=None, eb=None, out_f64=False):
    """Plain PyTorch version of kernel K1 with its epilogues: the pair
    accumulation, then nothing, the f32 scale 2^ea * 2^eb on (Ch, Cl), or
    the f64 rescale C = (Ch + Cl) * 2^ea * 2^eb."""
    ch, cl = matmul_sliced_ref(a_sl, b_sl, gmax)
    if ea is None:
        return ch, cl
    if out_f64:
        c = ch.to(torch.float64) + cl.to(torch.float64)
        # rescale as a product of two in-f32-range factors (|e| <= 121 each)
        return c * _pow2(ea, torch.float64) * _pow2(eb, torch.float64)
    s = _pow2(ea, torch.float32) * _pow2(eb, torch.float32)  # powers of two, exact
    return ch * s, cl * s


def _check_slices(a_sl, b_sl, gmax, ea, eb, out_f64):
    if a_sl.dtype != torch.bfloat16 or b_sl.dtype != torch.bfloat16:
        raise TypeError("hpmm_pairs takes bf16 slices")
    if a_sl.ndim not in (3, 4) or b_sl.ndim != a_sl.ndim:
        raise ValueError("hpmm_pairs takes [q, M, K] and [q, K, N] slices, or a fleet "
                         "of both ([B, q, M, K] and [B, q, K, N])")
    q, m_dim, k_dim = a_sl.shape[-3:]
    if a_sl.shape[:-3] != b_sl.shape[:-3]:
        raise ValueError(f"fleet sizes of {tuple(a_sl.shape)} and {tuple(b_sl.shape)} disagree")
    batch = a_sl.shape[0] if a_sl.ndim == 4 else 1
    if b_sl.shape[-3] != q or b_sl.shape[-2] != k_dim:
        raise ValueError(f"slice shapes {tuple(a_sl.shape)} and {tuple(b_sl.shape)} disagree")
    if k_dim % _CHUNK:
        raise ValueError(f"K = {k_dim} is not a multiple of {_CHUNK}")
    if not 0 <= gmax < q:
        raise ValueError(f"gmax = {gmax} needs 0 <= gmax < q = {q}")
    if a_sl.device != b_sl.device:
        raise ValueError("slices lie on different devices")
    if (ea is None) != (eb is None) or (out_f64 and ea is None):
        raise ValueError("the scaled forms of hpmm_pairs need both ea and eb")
    if ea is not None:
        n_dim = b_sl.shape[-1]
        for e, n in ((ea, m_dim), (eb, n_dim)):
            if e.dtype != torch.int32 or e.numel() != batch * n or e.device != a_sl.device:
                raise ValueError("ea / eb must be int32 exponents of M / N entries "
                                 "on the slices' device")


def hpmm_pairs(a_sl: torch.Tensor, b_sl: torch.Tensor, gmax: int,
               ea: torch.Tensor | None = None, eb: torch.Tensor | None = None,
               out_f64: bool = False):
    """Pair accumulation of the slices: the CUDA kernel K1 for CUDA tensors,
    the plain version :func:`pairs_ref` for CPU tensors.

    Returns (Ch, Cl) f32; with the exponents ea [M, 1], eb [1, N] of the
    operands' scales, (Ch, Cl) times the f32 scale 2^ea * 2^eb; with
    ``out_f64`` the f64 product (Ch + Cl) * 2^ea * 2^eb instead.  On the
    card both operands must be K-contiguous with 16-byte-aligned rows:
    a_sl as [q, M, K] storage, b_sl as the [q, K, N] view of [q, N, K]
    storage, which is how :func:`hpmm_slice` returns them (row-strided
    views of either are taken too).  A fleet ([B, q, M, K] x [B, q, K, N],
    exponents [B, M, 1] and [B, 1, N]) is one launch with B grid layers."""
    global KERNEL_LAUNCHES
    _check_slices(a_sl, b_sl, gmax, ea, eb, out_f64)
    if a_sl.device.type == "cpu":
        return pairs_ref(a_sl, b_sl, gmax, ea, eb, out_f64)
    if a_sl.device.type != "cuda":
        raise ValueError(f"hpmm_pairs: unsupported device {a_sl.device}")
    if gmax > _KERNEL_MAX_GMAX:
        raise ValueError(f"the CUDA kernel takes gmax <= {_KERNEL_MAX_GMAX}, got {gmax}")
    fleet = a_sl.ndim == 4
    sa = a_sl.stride() if fleet else (0,) + a_sl.stride()
    sb = b_sl.stride() if fleet else (0,) + b_sl.stride()
    for name, sl, (s_b, s_q, s_row, s_k) in (
        ("a_sl", a_sl, sa),
        ("b_sl", b_sl, (sb[0], sb[1], sb[3], sb[2])),
    ):
        if s_k != 1 or s_b % 8 or s_q % 8 or s_row % 8 or sl.data_ptr() % 16:
            raise ValueError(
                f"the CUDA kernel takes K-contiguous slices with 16-byte-aligned rows "
                f"(as hpmm_slice returns them); {name} has strides {sl.stride()}")
    from hdsdp_tpu_torch.ops import cuda_build

    lib, _ = cuda_build.load("hpmm_pairs")
    m_dim, k_dim = a_sl.shape[-2:]
    n_dim = b_sl.shape[-1]
    lead = a_sl.shape[:-3]
    batch = lead[0] if fleet else 1
    dev = a_sl.device
    if out_f64:
        outs = (torch.empty(lead + (m_dim, n_dim), dtype=torch.float64, device=dev),)
        ptrs = (None, None, outs[0].data_ptr())
    else:
        outs = (torch.empty(lead + (m_dim, n_dim), dtype=torch.float32, device=dev),
                torch.empty(lead + (m_dim, n_dim), dtype=torch.float32, device=dev))
        ptrs = (outs[0].data_ptr(), outs[1].data_ptr(), None)
    sc = outs[0].stride() if fleet else (0,) + outs[0].stride()
    if ea is not None:
        # views of [M], [N] (per instance, [B, M], [B, N]): no copy
        ea, eb = ea.contiguous(), eb.contiguous()
    with torch.cuda.device(dev):
        err = lib.hpmm_pairs_launch(
            a_sl.data_ptr(), b_sl.data_ptr(), *ptrs,
            None if ea is None else ea.data_ptr(),
            None if eb is None else eb.data_ptr(),
            m_dim, n_dim, k_dim, gmax, batch, *sa, *sb, *sc,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hpmm_pairs kernel launch failed: cudaError {err}")
    KERNEL_LAUNCHES += 1
    return outs[0] if out_f64 else outs


def slice_operands(a: torch.Tensor, b: torch.Tensor, gmax: int = 5):
    """The prologue of :func:`hpmm`: (a_sl [q, M, Kp], b_sl [q, Kp, N]
    bf16 slices with K zero-padded to a multiple of 256, ea [M, 1] and
    eb [1, N] power-of-two exponents of the row/column scales); a fleet
    gets the leading axis on each."""
    a_sl, ea = hpmm_slice(a, 1, gmax)
    b_sl, eb = hpmm_slice(b, 0, gmax)
    return a_sl, b_sl, ea, eb


def hpmm(a: torch.Tensor, b: torch.Tensor, gmax: int = 5) -> torch.Tensor:
    """f64 a [M, K] @ b [K, N] -> f64 [M, N] through bf16 slices (a fleet
    [B, M, K] @ [B, K, N] -> [B, M, N] in the same three launches).

    Keeps ~48 of f64's 52 mantissa bits; the rescale happens in f64 so
    inputs may use the full f64 exponent range.  NaN propagates to the
    affected rows and columns.

    A float32 operand is sliced as the pair (x, 0) (what the JAX
    package's ``dd.from_f64`` makes of it), and a float32 ``a`` gives a
    float32 product, the sum of the double-single result, as the JAX
    package's hpmm casts its result to a's dtype (a float32 solve,
    Params.dtype)."""
    if a.dtype == torch.float64 and b.dtype == torch.float64:
        a_sl, b_sl, ea, eb = slice_operands(a, b, gmax)
        return hpmm_pairs(a_sl, b_sl, gmax, ea, eb, out_f64=True)

    def operand(x):
        return x if x.dtype == torch.float64 else (x, torch.zeros_like(x))

    a_sl, ea = hpmm_slice(operand(a), 1, gmax)
    b_sl, eb = hpmm_slice(operand(b), 0, gmax)
    if a.dtype == torch.float64:
        return hpmm_pairs(a_sl, b_sl, gmax, ea, eb, out_f64=True)
    ch, cl = hpmm_pairs(a_sl, b_sl, gmax, ea, eb)
    return ch + cl


def hpmm_dd(ah, al, bh, bl, gmax: int = 5):
    """(Ah+Al) @ (Bh+Bl) -> (Ch, Cl), all f32 double-single pairs.

    Callers must keep magnitudes within f32 range; the internal slicing
    is range-safe via power-of-two normalization."""
    a_sl, ea = hpmm_slice((ah, al), 1, gmax)
    b_sl, eb = hpmm_slice((bh, bl), 0, gmax)
    return hpmm_pairs(a_sl, b_sl, gmax, ea, eb)


def hpmm_dd_syrk(ah, al, gmax: int = 5):
    """(Ah+Al) @ (Ah+Al).T -> (Ch, Cl) with a single slice extraction."""
    a_sl, ea = hpmm_slice((ah, al), 1, gmax)
    return hpmm_pairs(a_sl, a_sl.transpose(-1, -2), gmax, ea, ea.transpose(-1, -2))


def hpmm_slice_a(a: torch.Tensor, gmax: int = 5):
    """Pre-slice the left operand of :func:`hpmm` for reuse across many
    products with the same a.  Returns (a_sl [q, M, Kp] bf16, ea [M, 1]
    int32 row exponents)."""
    return hpmm_slice(a, 1, gmax)


def hpmm_presliced(a_sl: torch.Tensor, ea: torch.Tensor, b: torch.Tensor,
                   gmax: int = 5) -> torch.Tensor:
    """f64 (pre-sliced a) @ b, the per-product half of :func:`hpmm`; b's
    K pad is made to match the pre-sliced operand's."""
    b_sl, eb = hpmm_slice(b, 0, gmax, kpad=a_sl.shape[-1])
    return hpmm_pairs(a_sl, b_sl, gmax, ea, eb, out_f64=True)


def hpmm_syrk(a: torch.Tensor, gmax: int = 5) -> torch.Tensor:
    """f64 a @ a.T with a single slice extraction."""
    a_sl, ea = hpmm_slice(a, 1, gmax)
    return hpmm_pairs(a_sl, a_sl.transpose(-1, -2), gmax, ea, ea.transpose(-1, -2),
                      out_f64=True)
