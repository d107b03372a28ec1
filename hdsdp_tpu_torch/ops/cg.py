"""Preconditioned conjugate gradients for the Schur system.

Port of the JAX package's ops/cg.py (ref HDSDP_LINSYS_DENSE_ITERATIVE,
linalg/hdsdp_linsolver.c:1289-1660 and interface/hdsdp_schur.c:19):
Jacobi-preconditioned CG with periodic restarts, an early bail-out when
convergence stalls, and escalation to a Cholesky preconditioner on
failure.  ``AdaptiveCG`` carries the ADPCG side-car's rule-based
preconditioner-refresh policy (ref derivative/ADPCG/src/adpcg.c) across
IPM iterations: the Cholesky preconditioner may be REUSED (stale) for
several consecutive KKT systems and is refreshed only when the sweep
count degrades.

The loops run on the host and read one scalar per step (the JAX package
runs them as one ``lax.while_loop``).  ``factor_scaled_f32`` is the
inverted f32 factor behind the preconditioner of the matrix-free operator
(solver.algo).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from hdsdp_tpu_torch.ops import chol as chol_ops
from hdsdp_tpu_torch.utils import device, profile

STATUS_OK = 0
STATUS_MAXITER = 1
STATUS_NUMERICAL = 2

_EPS64 = 2.220446049250313e-16


class CGResult(NamedTuple):
    x: torch.Tensor
    status: int
    iters: int
    resi_norm: torch.Tensor


def pcg(M, rhs, precond, max_iter: int, restart_freq: int = 20,
        abs_tol: float = 1e-06, rel_tol: float = 1e-06,
        use_chol: bool = False) -> CGResult:
    """Single-RHS PCG on symmetric PD M (ref conjGradSolve, :1446-1588).

    ``precond``: the diagonal vector (Jacobi) or, with ``use_chol``, a
    Cholesky factor L."""

    def apply_p(v):
        if use_chol:
            return chol_ops.chol_solve(precond, v)
        return v / precond

    profile.count("host_reads")
    rhs_norm = float(torch.linalg.vector_norm(rhs))
    tol = max(min(abs_tol, rhs_norm * rel_tol), 0.1 * abs_tol)

    x = torch.zeros_like(rhs)
    r = rhs
    d = apply_p(r)
    z = d
    Md = M @ d
    it = 0
    status = STATUS_OK if rhs_norm < tol else -1
    while status < 0:
        rz = z @ r
        alpha = rz / (d @ Md)
        x = x + alpha * d
        if not use_chol and it % restart_freq == 5:
            r = rhs - M @ x
            d = apply_p(r)
            Md = M @ d
            z = d
        else:
            r = r - alpha * Md
            z = apply_p(r)
            d = z + ((r @ z) / rz) * d
            Md = M @ d
        profile.count("host_reads")
        rn = float(torch.linalg.vector_norm(r))  # host read, one per step
        if rn != rn:
            status = STATUS_NUMERICAL
        elif rn < tol:
            status = STATUS_OK
        elif it > 20 and rn > 0.01 * rhs_norm:  # stall bail-out (ref :1543-1546)
            status = STATUS_MAXITER
        elif it + 1 >= max_iter:
            status = STATUS_MAXITER
        it += 1
    return CGResult(x=x, status=status, iters=it, resi_norm=torch.linalg.vector_norm(r))


def _equilibrated_factor(M: torch.Tensor, f32: bool = True):
    """Jacobi-equilibrated Cholesky preconditioner of an f64 SPD M.

    D^-1/2 M D^-1/2 has unit diagonal and entries in [-1, 1] (SPD), so an
    f32 cast can neither overflow nor lose the scale; the equilibration
    is also the optimal diagonal preconditioning up to a factor n.
    Returns (L, s, ok) with s = 1/sqrt(diag(M)); L is f32 (the fast path)
    or f64 (the escalation tier for kappa > 1/eps_f32).  ``ok`` is a
    bool tensor: the factorization's own failure report (the JAX
    package reads the same failure from non-finite entries of L).

    M may carry a leading instance axis ([N, m, m], a fleet of
    solver.batch): s, L and ok then carry it too, one factor per instance."""
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.where(d > 0.0, d, 1.0))
    Ms = M * s[..., :, None] * s[..., None, :]
    if f32:
        Ms = Ms.to(torch.float32)
    ok, L = chol_ops.psd_check(Ms, tuple(M.shape[:-2]))
    return L, s, ok


def factor_scaled_f32(Ms: torch.Tensor):
    """Inverted Cholesky factor of an ALREADY-equilibrated f32 SPD matrix
    (unit diagonal): (Linv, ok), with Linv None when the factorization
    fails.  The operator-mode preconditioner path materializes M directly
    in equilibrated f32 row chunks (no f64 m x m ever exists), so this is
    ``_equilibrated_factor`` minus the scaling, plus the explicit inverse:
    the preconditioner is then applied as two matrix products.

    The factor reads the LOWER triangle of Ms.  A matrix assembled row by
    row is symmetric only to rounding (an f32 unit in the last place),
    which moves the preconditioner by no more than the f32 factorization
    itself does; Linv^T Linv is symmetric whatever was read, and CG on
    the f64 operator removes the rest.  Failure is the factorization's
    own report (``info``) or a non-finite inverse (a near-zero pivot
    overflows the explicit inverse where a triangular solve would have
    limped through)."""
    L, info = torch.linalg.cholesky_ex(Ms)
    profile.count("host_reads")
    if int(info) != 0:
        return None, False
    eye = torch.eye(Ms.shape[0], dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    del L, eye
    profile.count("host_reads")
    if not bool(torch.isfinite(Linv).all()):
        return None, False
    return Linv, True


def chol_apply(L: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 U with both triangular solves in L's dtype."""
    T = torch.linalg.solve_triangular(L, U, upper=False)
    return torch.linalg.solve_triangular(L.mT, T, upper=True)


def refine_solve(M, L, s, B, max_iter: int = 40, abs_tol: float = 1e-10,
                 rel_tol: float = 1e-10, live=None):
    """Mixed-precision iterative refinement: f32 (or f64) factor of the
    equilibrated M, f64 residuals.  Solves M X = B [m, k]:

        X += D^-1/2 (L L^T)^-1 D^-1/2 R,   R = B - M X.

    Each sweep contracts the error by ~kappa(M) * eps of the factor; near
    an IPM's endgame kappa can exceed 1/eps_f32, the loop stalls (a sweep
    that leaves more than 0.9 of the residual) and the caller escalates
    to a better factor (ref conjGradSolve with a stale factor + the ADPCG
    refresh policy).  Accepted below max(abs_tol, rel_tol |B|, 16 eps
    (|B| + |M|_inf |X|)): the residual a backward-stable direct solve
    would leave; demanding less is unreachable at high kappa.

    A FLEET (solver.batch): M [N, m, m], L, s and B [N, m, k] with a
    leading instance axis, each instance refined on its own, as
    ``jax.vmap`` runs the JAX package's while_loop: the sweeps go on
    while some instance goes on, and an instance that has stopped keeps
    its X from then on.  ``live`` (a host bool mask [N]) leaves the
    others frozen from the start.  Status and sweeps are then numpy
    arrays [N].  Each instance's products are its own matrix products,
    so a member rounds as a single solve of it does.

    Returns (X, status, sweeps).  One host read of the norms per sweep
    (of every instance's)."""
    fleet = M.ndim == 3
    if fleet:
        def mdot(X):
            return torch.stack([device.jdot(Mi, Xi) for Mi, Xi in zip(M, X)])
    else:
        def mdot(X):
            # a float32 M (Params.dtype) against the float64 iterate
            # computes in float64, as the JAX package's product does
            return device.jdot(M, X)

    def apply_p(R):
        U = (s[..., :, None] * R).to(L.dtype)
        return s[..., :, None] * chol_apply(L, U).to(torch.float64)

    def colnorm(A):
        return torch.linalg.vector_norm(A, dim=-2).amax(-1)

    profile.count("host_reads")
    bnorm, mnorm = (torch.stack([colnorm(B), torch.sum(torch.abs(M), dim=-1).amax(-1)])
                    .cpu().numpy())

    def state(X, R):
        profile.count("host_reads")
        rn, xn = torch.stack([colnorm(R), colnorm(X)]).cpu().numpy()
        tol = np.maximum(np.maximum(abs_tol, rel_tol * bnorm),
                         16.0 * _EPS64 * (bnorm + mnorm * xn))
        return rn, tol

    X = apply_p(B)
    R = B - mdot(X)
    rn, tol = state(X, R)
    it = np.zeros(rn.shape, dtype=np.int64)
    status = np.where(rn != rn, STATUS_NUMERICAL, np.where(rn < tol, STATUS_OK, -1))
    going = status < 0
    if live is not None:
        going &= np.asarray(live, dtype=bool)
    while going.any():
        rn_prev = rn
        X_new = X + apply_p(R)
        R_new = B - mdot(X_new)
        if going.all():
            X, R = X_new, R_new
        else:
            keep = torch.as_tensor(going, device=X.device)[:, None, None]
            X, R = torch.where(keep, X_new, X), torch.where(keep, R_new, R)
        rn_new, tol_new = state(X, R)
        rn = np.where(going, rn_new, rn)
        tol = np.where(going, tol_new, tol)
        it = it + going
        done = np.where(rn != rn, STATUS_NUMERICAL,
                        np.where(rn < tol, STATUS_OK,
                                 np.where((rn > 0.9 * rn_prev) | (it >= max_iter),
                                          STATUS_MAXITER, -1)))
        status = np.where(going, done, status)
        going = going & (status < 0)
    if not fleet:
        return X, int(status), int(it)
    return X, status, it


class AdaptiveCG:
    """Host-side policy around the mixed-precision Schur solver.

    Carries a possibly STALE f32 preconditioner across consecutive KKT
    systems (the ADPCG idea): the factor is refreshed only when
    refinement with the stale one stops converging quickly.  Near
    convergence M changes slowly, so many iterations reuse one
    factorization (the reference's phase-B behavior with its default
    HDSDP_LINSYS_DENSE_ITERATIVE backend).

    Callers must check the ``ok`` flag of the *_checked entry points: on
    failure the caller escalates to a full-precision direct factorization
    (ref HFpLinsysSwitchToIndefinite, hdsdp_linsolver.c:1827-1857)
    instead of iterating on NaNs."""

    def __init__(self, max_iter=40, abs_tol=1e-10, rel_tol=1e-10, reuse_threshold=8):
        self.max_iter = max_iter
        self.abs_tol = abs_tol
        self.rel_tol = rel_tol
        self.reuse_threshold = reuse_threshold
        # stale preconditioner: (L, s) with L f32 or f64
        self.chol_fac = None
        self._fresh = False  # factor computed for the current M
        self._f64_left = 0  # systems left before retrying the f32 tier
        self.n_factor = 0
        self.n_solve = 0
        self.last_iters = 0
        self.last_status = STATUS_OK
        self.history = []  # per-call ledger: (kind, detail, seconds)

    def update(self, M) -> None:
        """New KKT system: the stale factor stays unless flagged."""
        self._fresh = False
        if self._f64_left > 0:
            self._f64_left -= 1

    def _factor(self, M, f32: bool) -> bool:
        t0 = time.time()
        L, s, ok = _equilibrated_factor(M, f32=f32)
        self.n_factor += 1
        self._fresh = True
        kind = "factor32" if f32 else "factor64"
        profile.count("host_reads")
        if not bool(ok):
            self.chol_fac = None
            self.history.append((kind, "fail", time.time() - t0))
            return False
        self.chol_fac = (L, s)
        self.history.append((kind, "ok", time.time() - t0))
        return True

    def _refine(self, M, rhs_mat):
        t0 = time.time()
        L, s = self.chol_fac
        X, status, iters = refine_solve(
            M, L, s, rhs_mat, max_iter=self.max_iter,
            abs_tol=self.abs_tol, rel_tol=self.rel_tol,
        )
        self.last_iters = int(iters)
        self.last_status = int(status)
        self.history.append((
            "refine" + ("_stale" if not self._fresh else ""),
            f"st={self.last_status} it={self.last_iters}",
            time.time() - t0,
        ))
        return X, self.last_status == STATUS_OK

    def summary(self) -> dict:
        """Aggregate the call ledger: where does the KKT-solve time go?
        (Host seconds; a refine ends in a host read, a factor in its
        ``ok`` read.)"""
        agg: dict = {}
        for kind, _, dt in self.history:
            e = agg.setdefault(kind, {"n": 0, "s": 0.0})
            e["n"] += 1
            e["s"] += dt
        for e in agg.values():
            e["s"] = round(e["s"], 2)
        refine_iters = [
            int(d.split("it=")[1]) for k, d, _ in self.history if k.startswith("refine")
        ]
        if refine_iters:
            agg["refine_iters"] = {
                "mean": round(sum(refine_iters) / len(refine_iters), 1),
                "max": max(refine_iters),
            }
        return agg

    def solve_mat_checked(self, M, rhs_mat):
        """Solve M X = rhs_mat [m, k].  Returns (X [m, k], ok).

        Tiers: stale factor -> fresh f32 factor -> fresh f64 factor ->
        report failure (the caller escalates to the direct ladder).
        After an f32 fresh-factor failure the policy prefers f64 factors
        for the next few systems, then retries f32 (conditioning
        fluctuates across IPM iterations)."""
        self.n_solve += rhs_mat.shape[1]

        if self.chol_fac is not None:
            X, ok = self._refine(M, rhs_mat)
            if ok:
                if self.last_iters > self.reuse_threshold:
                    self.chol_fac = None  # refresh on the next system
                return X, True
            full_tier = self.chol_fac[0].dtype == torch.float64
            self.chol_fac = None
            if self._fresh and full_tier:
                return X, False  # fresh full-precision factor failed
            # stale (or fresh-f32): escalate below

        if self._f64_left == 0:
            if self._factor(M, f32=True):
                X, ok = self._refine(M, rhs_mat)
                if ok:
                    return X, True
            self._f64_left = 8  # prefer f64 for a while, then retry f32

        if not self._factor(M, f32=False):
            self.last_status = STATUS_NUMERICAL
            return rhs_mat, False
        X, ok = self._refine(M, rhs_mat)
        if not ok:
            self.chol_fac = None
        return X, ok

    def solve_checked(self, M, rhs):
        """Solve M x = rhs.  Returns (x, ok)."""
        x, ok = self.solve_mat_checked(M, rhs[:, None])
        return x[:, 0], ok
