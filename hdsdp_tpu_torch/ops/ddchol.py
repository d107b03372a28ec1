"""Blocked Cholesky in double-single (f32 pair) arithmetic.

Port of the JAX package's ops/ddchol.py, the f64-grade (~2^-45) factor
it builds from f32 and bf16 hardware (ref: LAPACK dpotrf/dtrsm/dpotri,
linalg/hdsdp_linsolver.c:1044-1286):

  * storage: (hi, lo) f32 pairs (ops.dd);
  * panel factorization: a right-looking rank-1 sweep in DD arithmetic
    that produces the panel factor and its inverse in one pass (the
    inverse replaces dtrsm in the blocked update).  On a CUDA tensor this
    is kernel K8 (csrc/dd_panel.cu, :func:`panel_factor`), on a CPU
    tensor its plain version :func:`panel_factor_ref`;
  * the L21 strips and the trailing updates: the Ozaki matmul
    (ops.hpmm.hpmm_dd / hpmm_dd_syrk, kernels K1s and K1 on the card).

PSD-check semantics match the reference's try-Cholesky predicate
(ref hdsdp_linsolver.c:1112-1144): a non-PD input turns the factor NaN
through dd.sqrt, and :func:`ok` is the arithmetic NaN test.

The matrix is padded to a block multiple with an identity tail.
:func:`factor`, :func:`ok`, :func:`tri_inverse` and :func:`spd_inverse`
also take a FLEET, a leading axis of N same-size matrices (solver.batch,
where the JAX package vmaps ``factor``): every kernel then takes the N
instances in one launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from hdsdp_tpu_torch.ops import dd, hpmm

# Launches of kernel K8 (dd_panel_launch); the plain version and the CPU
# path never count.
PANEL_LAUNCHES = 0

KERNEL_BLOCKS = (32, 64, 128, 256)  # the panel sizes K8 is built for


class DDFactor(NamedTuple):
    """Lower-triangular DD factor plus per-panel diagonal-block inverses
    (each with a leading instance axis for a fleet)."""

    lh: torch.Tensor  # [np, np] f32
    ll: torch.Tensor
    wh: torch.Tensor  # [npan, B, B] f32: inverses of L's diagonal blocks
    wl: torch.Tensor


def panel_factor_ref(ph: torch.Tensor, pl: torch.Tensor):
    """Plain version of kernel K8: factor a [B, B] DD block ([N, B, B]
    for a fleet) and return (Lh, Ll, Wh, Wl) with W = L^-1.

    One right-looking rank-1 sweep (the JAX package's ``_panel_factor``,
    a lax.fori_loop, step for step); the inverse row j is built from the
    already final rows of W (forward substitution interleaved with the
    factorization), so no separate triangular solve is needed."""
    b = ph.shape[-1]
    rid = torch.arange(b, device=ph.device)
    ph, pl = ph.clone(), pl.clone()
    lh, ll = torch.zeros_like(ph), torch.zeros_like(ph)
    wh, wl = torch.zeros_like(ph), torch.zeros_like(ph)
    zero = torch.zeros((), dtype=ph.dtype, device=ph.device)
    for j in range(b):
        ch, cl = ph[..., :, j], pl[..., :, j]
        djh, djl = ch[..., j:j + 1], cl[..., j:j + 1]
        sh, sl = dd.sqrt(djh, djl)  # NaN if the pivot is <= 0 (PSD check)
        ish, isl = dd.inv(sh, sl)
        ch, cl = dd.mul(ch, cl, ish, isl)  # column / sqrt; row j -> sqrt
        keep = rid >= j
        ch = torch.where(keep, ch, zero)
        cl = torch.where(keep, cl, zero)
        lh[..., :, j] = ch
        ll[..., :, j] = cl
        # trailing update P -= c c^T (c is zero above j)
        oh, ol = dd.mul(ch[..., :, None], cl[..., :, None], ch[..., None, :], cl[..., None, :])
        ph, pl = dd.sub(ph, pl, oh, ol)
        # inverse row j: w_j = (e_j - L[j, :j] W) / L[j, j]
        left = rid < j
        rjh = torch.where(left, lh[..., j, :], zero)
        rjl = torch.where(left, ll[..., j, :], zero)
        th, tl = dd.mul(rjh[..., :, None], rjl[..., :, None], wh, wl)
        vh, vl = dd.dd_sum(th, tl, axis=-2)
        eh = torch.where(rid == j, 1.0, 0.0).to(ph.dtype)
        uh, ul = dd.sub(eh, torch.zeros_like(eh), vh, vl)
        wjh, wjl = dd.mul(uh, ul, ish, isl)
        wh[..., j, :] = wjh
        wl[..., j, :] = wjl
    return lh, ll, wh, wl


def panel_factor(ph: torch.Tensor, pl: torch.Tensor):
    """DD panel factor and inverse (see :func:`panel_factor_ref`): kernel
    K8 for CUDA tensors, the plain version for CPU tensors.  A fleet
    [N, B, B] is one launch of N thread-block clusters.  On the card B must
    be 32, 64, 128 or 256; anything else, or a launch the card refuses,
    raises."""
    global PANEL_LAUNCHES
    if not (ph.dtype == pl.dtype == torch.float32 and ph.shape == pl.shape
            and ph.ndim in (2, 3) and ph.shape[-1] == ph.shape[-2]
            and ph.device == pl.device):
        raise TypeError("panel_factor takes an (h, l) float32 pair of [B, B] or [N, B, B]")
    if ph.device.type == "cpu":
        return panel_factor_ref(ph, pl)
    if ph.device.type != "cuda":
        raise ValueError(f"panel_factor: unsupported device {ph.device}")
    b = ph.shape[-1]
    if b not in KERNEL_BLOCKS:
        raise ValueError(f"the CUDA kernel takes panels of B in {KERNEL_BLOCKS}, got {b}")
    from hdsdp_tpu_torch.ops import cuda_build

    lib, _ = cuda_build.load("dd_panel")
    fleet = ph.ndim == 3
    n_inst = ph.shape[0] if fleet else 1
    # the kernel reads the panel's lower triangle and writes nothing there
    work_h, work_l = ph.contiguous(), pl.contiguous()
    outs = [torch.empty_like(work_h) for _ in range(4)]
    with torch.cuda.device(ph.device):
        err = lib.dd_panel_launch(
            work_h.data_ptr(), work_l.data_ptr(), *(o.data_ptr() for o in outs),
            b, n_inst, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dd_panel kernel launch failed: cudaError {err}")
    PANEL_LAUNCHES += 1
    return tuple(outs)


def _pad_spd(a: torch.Tensor, block: int) -> torch.Tensor:
    """Pad an SPD matrix ([..., n, n]) to a block multiple with an
    identity tail."""
    n = a.shape[-1]
    npad = -(-n // block) * block
    if npad == n:
        return a
    out = torch.zeros(a.shape[:-2] + (npad, npad), dtype=a.dtype, device=a.device)
    out[..., :n, :n] = a
    out.diagonal(dim1=-2, dim2=-1)[..., n:].fill_(1.0)
    return out


def _below(npad: int, row0: int, device) -> torch.Tensor:
    """[npad, 1] mask of the rows at or below ``row0``."""
    return (torch.arange(npad, device=device) >= row0)[:, None]


def factor(a: torch.Tensor, block: int = 256) -> DDFactor:
    """DD blocked Cholesky of f64 SPD ``a`` ([n, n], or [N, n, n] for a
    fleet) -> DDFactor, internally padded (ref lapackLinSolverNumeric /
    dpotrf, hdsdp_linsolver.c:1146-1166)."""
    a = _pad_spd(a, block)
    lead = a.shape[:-2]
    npad = a.shape[-1]
    npan = npad // block
    ah, al = dd.from_f64(a)
    lh, ll = torch.zeros_like(ah), torch.zeros_like(ah)
    whs = torch.zeros(lead + (npan, block, block), dtype=torch.float32, device=a.device)
    wls = torch.zeros_like(whs)
    for k in range(npan):
        kb, ke = k * block, (k + 1) * block
        plh, pll, pwh, pwl = panel_factor(ah[..., kb:ke, kb:ke], al[..., kb:ke, kb:ke])
        whs[..., k, :, :] = pwh
        wls[..., k, :, :] = pwl
        # L21 = A[below, panel] @ W^T (replaces dtrsm)
        below = _below(npad, ke, a.device)
        sth = torch.where(below, ah[..., :, kb:ke], 0.0)
        stl = torch.where(below, al[..., :, kb:ke], 0.0)
        l21h, l21l = hpmm.hpmm_dd(sth, stl, pwh.mT, pwl.mT)
        l21h = torch.where(below, l21h, 0.0)
        l21l = torch.where(below, l21l, 0.0)
        lh[..., :, kb:ke] = l21h
        ll[..., :, kb:ke] = l21l
        lh[..., kb:ke, kb:ke] = plh
        ll[..., kb:ke, kb:ke] = pll
        # trailing update A -= L21 L21^T (nonzero only in the trailing block)
        uh, ul = hpmm.hpmm_dd_syrk(l21h, l21l)
        ah, al = dd.sub(ah, al, uh, ul)
    return DDFactor(lh, ll, whs, wls)


def ok(f: DDFactor) -> torch.Tensor:
    """Factorization-success predicate: sum(Lh - Lh) + sum(Wh - Wh) == 0,
    which NaN and inf both fail (a 0-dim bool tensor, one per instance
    of a fleet)."""
    lead = f.wh.ndim - 3
    s = (f.lh - f.lh).flatten(lead).sum(-1) + (f.wh - f.wh).flatten(lead).sum(-1)
    return s == 0.0


def logdet(f: DDFactor, n: int) -> torch.Tensor:
    """log det(A) = 2 sum log diag(L) over the first n rows."""
    d = dd.to_f64(torch.diagonal(f.lh, dim1=-2, dim2=-1)[..., :n],
                  torch.diagonal(f.ll, dim1=-2, dim2=-1)[..., :n])
    return 2.0 * torch.sum(torch.log(d), dim=-1)


def _block_matvec_dd(wh, wl, rh, rl):
    """[B, B] DD block times a [B, r] DD block by elementwise DD products
    and the dd_sum tree."""
    th, tl = dd.mul(wh[:, :, None], wl[:, :, None], rh[None], rl[None])
    return dd.dd_sum(th, tl, axis=1)


def solve(f: DDFactor, b: torch.Tensor) -> torch.Tensor:
    """A x = b with the DD factor; b is f64 [n] or [n, r] -> same shape.

    Blocked forward and backward substitution: the diagonal blocks apply
    the stored panel inverses, the off-diagonal strips are DD products
    with the dd_sum tree (r is small on the KKT path: <= 3 right-hand
    sides, ref hdsdp_algo.c:1099-1101)."""
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    n, r = b.shape
    npad = f.lh.shape[0]
    block = f.wh.shape[1]
    npan = npad // block
    bh, bl = dd.from_f64(F.pad(b, (0, 0, 0, npad - n)))
    rows = torch.arange(npad, device=b.device)

    rh, rl = bh, bl
    yh, yl = torch.zeros_like(bh), torch.zeros_like(bh)
    for k in range(npan):
        kb, ke = k * block, (k + 1) * block
        ykh, ykl = _block_matvec_dd(f.wh[k], f.wl[k], rh[kb:ke], rl[kb:ke])
        yh[kb:ke] = ykh
        yl[kb:ke] = ykl
        below = (rows >= ke)[:, None]
        sth = torch.where(below, f.lh[:, kb:ke], 0.0)
        stl = torch.where(below, f.ll[:, kb:ke], 0.0)
        dh, dl = dd.mul(sth[:, :, None], stl[:, :, None], ykh[None], ykl[None])
        dh, dl = dd.dd_sum(dh, dl, axis=1)
        rh, rl = dd.sub(rh, rl, dh, dl)

    rh, rl = yh, yl
    xh, xl = torch.zeros_like(bh), torch.zeros_like(bh)
    for k in reversed(range(npan)):
        kb, ke = k * block, (k + 1) * block
        xkh, xkl = _block_matvec_dd(f.wh[k].T, f.wl[k].T, rh[kb:ke], rl[kb:ke])
        xh[kb:ke] = xkh
        xl[kb:ke] = xkl
        # subtract L[kb:ke, :kb]^T x_k from the rows above the panel
        left = (rows < kb)[None, :]
        sth = torch.where(left, f.lh[kb:ke, :], 0.0)
        stl = torch.where(left, f.ll[kb:ke, :], 0.0)
        dh, dl = dd.mul(sth.T[:, :, None], stl.T[:, :, None], xkh[None], xkl[None])
        dh, dl = dd.dd_sum(dh, dl, axis=1)
        rh, rl = dd.sub(rh, rl, dh, dl)
    x = dd.to_f64(xh, xl)[:n]
    return x[:, 0] if vec else x


def tri_inverse(f: DDFactor):
    """G = L^-1 as a DD pair [np, np] ([N, np, np] for a fleet): blocked
    forward substitution on I, its strips through the Ozaki matmul (ref
    the dpotri path, hdsdp_linsolver.c:1238-1260)."""
    npad = f.lh.shape[-1]
    block = f.wh.shape[-1]
    npan = npad // block
    dev = f.lh.device
    rh = torch.eye(npad, dtype=torch.float32, device=dev).expand_as(f.lh).clone()
    rl = torch.zeros_like(f.lh)
    gh, gl = torch.zeros_like(f.lh), torch.zeros_like(f.lh)
    for k in range(npan):
        kb, ke = k * block, (k + 1) * block
        gkh, gkl = hpmm.hpmm_dd(f.wh[..., k, :, :], f.wl[..., k, :, :],
                                rh[..., kb:ke, :], rl[..., kb:ke, :])
        gh[..., kb:ke, :] = gkh
        gl[..., kb:ke, :] = gkl
        below = _below(npad, ke, dev)
        sth = torch.where(below, f.lh[..., :, kb:ke], 0.0)
        stl = torch.where(below, f.ll[..., :, kb:ke], 0.0)
        dh, dl = hpmm.hpmm_dd(sth, stl, gkh, gkl)
        rh, rl = dd.sub(rh, rl, dh, dl)
    return gh, gl


def spd_inverse(f: DDFactor, n: int) -> torch.Tensor:
    """A^-1 = G^T G in f64, cut to the original size."""
    gh, gl = tri_inverse(f)
    ch, cl = hpmm.hpmm_dd(gh.mT, gl.mT, gh, gl)
    return dd.to_f64(ch, cl)[..., :n, :n]


def factor_from_f64_tri(L: torch.Tensor, block: int = 256) -> DDFactor:
    """Wrap an EXISTING f64 lower-triangular factor ([n, n] or [N, n, n])
    as a DDFactor.

    The panels' diagonal-block inverses W come from batched f64
    triangular solves (O(n B^2) flops; the JAX package leaves them to
    XLA), so the strip products of tri_inverse / spd_inverse / solve can
    run against a factor made elsewhere (the f64 L the cone system
    already carries)."""
    Lp = _pad_spd(L, block)
    npad = Lp.shape[-1]
    npan = npad // block
    lh, ll = dd.from_f64(Lp)
    blocks = torch.stack([Lp[..., k * block:(k + 1) * block, k * block:(k + 1) * block]
                          for k in range(npan)], dim=-3)
    eye = torch.eye(block, dtype=L.dtype, device=L.device).expand_as(blocks)
    W = torch.linalg.solve_triangular(blocks, eye, upper=False)
    wh, wl = dd.from_f64(W)
    return DDFactor(lh, ll, wh, wl)


def spd_inverse_from_f64_tri(L: torch.Tensor, block: int = 256) -> torch.Tensor:
    """A^-1 = L^-T L^-1 from an f64 lower factor through the DD blocked
    inverse (ops.chol.chol_inverse with ``use_dd``: the U = S^-1 of the
    KKT build at large single blocks, ref HFpLinsysInvert -> dpotri)."""
    return spd_inverse(factor_from_f64_tri(L, block=block), L.shape[-1])


def chol_f64(a: torch.Tensor, block: int = 256) -> torch.Tensor:
    """The f64 lower Cholesky factor of ``a`` through the DD path."""
    f = factor(a, block=block)
    n = a.shape[-1]
    return dd.to_f64(f.lh, f.ll)[..., :n, :n]
