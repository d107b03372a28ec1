"""Cholesky-based primitives: PSD check, inverse, logdet, triangular solves.

Parity: the reference uses dpotrf success/failure as the PSD predicate
(lapackLinSolverPsdCheck, ref linalg/hdsdp_linsolver.c:1112-1144);
``torch.linalg.cholesky_ex`` reports the same failure as ``info > 0``.
A failed factor is filled with NaN, as the JAX package's factor is, so
every quantity derived from it (log-det, inverse) is NaN too.

All functions accept batched inputs [..., n, n].  Where a function
reduces over its batch, ``lead`` names the leading axes it keeps apart: a
fleet's (N,) holds N independent instances (solver.batch), each reduced
on its own; a single solve's () reduces everything.
"""

from __future__ import annotations

import torch

from hdsdp_tpu_torch.utils import profile
from hdsdp_tpu_torch.utils.device import jlift


def psd_check(S: torch.Tensor, lead: tuple = ()):
    """(is_interior, L): a bool tensor of shape ``lead`` (0-dim for a
    single solve, one per instance of a fleet) and the lower factor.

    ``is_interior`` stays on the device; reading it is the caller's
    choice of sync point.  A failed factor stays per instance: it sets
    only its own instance's flag and its own matrix to NaN."""
    L, info = torch.linalg.cholesky_ex(S)
    bad = info != 0
    # a NaN input need not raise info on every backend: check the factor
    ok = torch.logical_not(bad.reshape(lead + (-1,)).any(-1)) & torch.isfinite(
        L).reshape(lead + (-1,)).all(-1)
    L = torch.where(bad[..., None, None], torch.nan, L)
    return ok, L


def psd_factor(S: torch.Tensor, use_dd: bool = False, lead: tuple = ()):
    """(ok, L) as :func:`psd_check`, with the JAX package's double-single
    backend: ``use_dd`` routes a single block [1, n, n] with n >= 512
    (a fleet's [N, 1, n, n]) through the blocked DD Cholesky (ops.ddchol)
    and converts the factor back to f64.  The PSD predicate is the same (a
    non-PD input NaNs the panel's pivot sqrt, as dpotrf's info > 0), the
    factor ~2^-45 accurate.  Several blocks keep the f64 factor, as in the
    JAX package."""
    n = S.shape[-1]
    if use_dd and S.ndim - len(lead) == 3 and S.shape[-3] == 1 and n >= 512:
        from hdsdp_tpu_torch.ops import dd, ddchol

        f = ddchol.factor(S[..., 0, :, :])
        L = dd.to_f64(f.lh, f.ll)[..., :n, :n].unsqueeze(-3)
        return ddchol.ok(f), L
    return psd_check(S, lead)


def chol_logdet(L: torch.Tensor, lead: tuple = ()) -> torch.Tensor:
    """log det(S) = 2 sum log diag(L) (ref sdpDenseConeGetBarrier,
    hdsdp_conic_sdp.c:2279-2287), summed over the batch but ``lead``."""
    logs = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    return 2.0 * logs.reshape(lead + (-1,)).sum(-1)


def chol_inverse(L: torch.Tensor, use_dd: bool = False) -> torch.Tensor:
    """S^{-1} from the Cholesky factor (ref HFpLinsysInvert -> dpotri).

    ``use_dd`` routes a single large block ([1, n, n], n >= 512; [N, 1, n,
    n] for a fleet) through the double-single blocked inverse built from
    the existing f64 factor (ops.ddchol.spd_inverse_from_f64_tri, whose
    strips run through the Ozaki matmul).  The JAX package forces that
    route at n >= 8192 on a TPU, where XLA cannot compile the n-RHS
    triangular solve; the same gate (utils.device.is_tpu) is false on every
    device the port runs on.

    Each call counts one ``sinv`` and records one ``sinv`` span (the
    host's enqueue; no sync) while a ``utils.profile`` recording is open."""
    profile.count("sinv")
    with profile.span("sinv"):
        n = L.shape[-1]
        single = L.ndim >= 3 and L.shape[-3] == 1
        if not use_dd and single and n >= 8192:
            from hdsdp_tpu_torch.utils import device

            use_dd = device.is_tpu()
        if use_dd and single and n >= 512:
            from hdsdp_tpu_torch.ops import ddchol

            return ddchol.spd_inverse_from_f64_tri(L[..., 0, :, :]).unsqueeze(-3)
        eye = torch.eye(n, dtype=L.dtype, device=L.device).expand(L.shape)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        return Linv.mT @ Linv


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L L^T x = b; b is [..., n] or [..., n, k]."""
    vec = b.ndim == L.ndim - 1
    B = b[..., None] if vec else b
    y = torch.linalg.solve_triangular(L, B, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0] if vec else x


def blocked_tri_inverse(L: torch.Tensor, block: int = 512) -> torch.Tensor:
    """L^-1 of a lower-triangular [m, m] matrix by the row-block forward
    recurrence

        X[i, :] = W_i (E_i - L[i, :i] X[:i, :]),   W_i = inv(L[i, i]),

    one [B, m] x [m, m] product per panel (the JAX package's replacement
    for XLA's multi-RHS triangular solve on a TPU; the port reaches it
    through the gated pre-inverted preconditioner of ops.cg).  m is padded
    to a multiple of 128 with an identity tail (exact), and the panel is
    the largest power-of-two multiple of 128 that divides the padded size
    and fits ``block``.  The diagonal-block inverses W are one batched
    small triangular solve."""
    m = L.shape[0]
    mp = -(-m // 128) * 128
    B = 128
    while B * 2 <= min(block, mp) and mp % (B * 2) == 0:
        B *= 2
    if mp != m:
        Lp = torch.eye(mp, dtype=L.dtype, device=L.device)
        Lp[:m, :m] = L
    else:
        Lp = L
    npan = mp // B
    diag_blocks = torch.stack([Lp[k * B:(k + 1) * B, k * B:(k + 1) * B] for k in range(npan)])
    eye = torch.eye(B, dtype=L.dtype, device=L.device).expand_as(diag_blocks)
    W = torch.linalg.solve_triangular(diag_blocks, eye, upper=False)
    X = torch.zeros((mp, mp), dtype=L.dtype, device=L.device)
    for i in range(npan):
        row0 = i * B
        # columns >= row0 contribute nothing (those rows of X are still
        # zero) but the diagonal block, which must not enter the recurrence
        prod = Lp[row0:row0 + B, :row0] @ X[:row0]
        X[row0:row0 + B] = -(W[i] @ prod)
        X[row0:row0 + B, row0:row0 + B] = W[i]
    return X[:m, :m]


def congruence(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """L^{-1} W L^{-T} for symmetric W, batched.

    Used by the ratio test: S + a*dS >= 0 iff I + a L^{-1} dS L^{-T} >= 0
    (ref sdpDenseConeILanczosMultiply, hdsdp_conic_sdp.c:462-505).  L and
    W of different dtypes (a float32 solve's factor against a float64
    step) compute in the wider one, as the JAX package's solve does."""
    L, W = jlift(L, W)
    X = torch.linalg.solve_triangular(L, W, upper=False)
    return torch.linalg.solve_triangular(L, X.mT, upper=False)
