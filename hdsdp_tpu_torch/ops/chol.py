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
    strips run through the Ozaki matmul).

    Each call counts one ``sinv`` and records one ``sinv`` span (the
    host's enqueue; no sync) while a ``utils.profile`` recording is open."""
    profile.count("sinv")
    with profile.span("sinv"):
        n = L.shape[-1]
        single = L.ndim >= 3 and L.shape[-3] == 1
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


def congruence(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """L^{-1} W L^{-T} for symmetric W, batched.

    Used by the ratio test: S + a*dS >= 0 iff I + a L^{-1} dS L^{-T} >= 0
    (ref sdpDenseConeILanczosMultiply, hdsdp_conic_sdp.c:462-505).  L and
    W of different dtypes (a float32 solve's factor against a float64
    step) compute in the wider one, as the JAX package's solve does."""
    L, W = jlift(L, W)
    X = torch.linalg.solve_triangular(L, W, upper=False)
    return torch.linalg.solve_triangular(L, X.mT, upper=False)
