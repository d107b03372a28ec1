"""Standalone LP interior-point solver (hybrid primal-dual / primal) on torch.

The port of the JAX package's ``solver/lpsolve.py``, itself a re-derivation
of the reference's LP module (ref interface/hdsdp_lpsolve.c +
hdsdp_lpkkt.c):

  * Ruiz / geometric / L2 data scaling      (ref HLpSolverIScaleData, :280-311)
  * Mehrotra starting point                 (ref :313-382)
  * Mehrotra predictor-corrector steps on the normal equations
    A D^2 A' dy = rhs with D^2 = x/s        (ref HLpSolverITakePrimalDualStep,
                                             :558-681)
  * primal-only phase with one FIXED factorization used as preconditioner
    (ref HLpSolverIPreparePrimal :683-722, HLpSolverITakePrimalStep
     :949-1092; the reference's inner CG short-circuits after the
     preconditioner application, hdsdp_lpsolve.c:1046 'goto exit_cleanup'
     right after the initial guess, so the direction is M0^{-1} rhs; that
     is the default here too, and ``n_inner_cg`` runs real PCG steps)
  * primal convergence statistics driving the switch-over
    (ref HPrimalStatsUpdate :75-130, HLpSolverICheckPrimalStats :491-531)

Design: A is a dense [nrow, ncol] float64 tensor on the solver's device
(default "cuda"); each step is one plain function of device tensors that
forms M = A D^2 A' with a matmul, factors it by Cholesky
(``torch.linalg.cholesky_ex``, the PSD predicate of ``ops/chol.py``) and
runs both predictor and corrector solves.  The outer loop runs on the
host, as in the JAX package, and reads the device once an iteration: the
step's flag and scalars together with the residual norms, objectives and
switch-over metrics, in one stacked copy.  A factor that fails every rung
of the regularization ladder ends the solve (``NUMERICAL``, or optimal if
the best iterate already was); nothing moves to the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from hdsdp_tpu_torch.io.mps import read_mps
from hdsdp_tpu_torch.ops.chol import chol_solve, psd_check
from hdsdp_tpu_torch.utils.device import DTYPE, resolve_device
from hdsdp_tpu_torch.utils.profile import PhaseStats, profile_fn

# statuses shared with the SDP side
OPTIMAL = "PRIMAL_DUAL_OPTIMAL"
MAXITER = "MAXITER"
TIMELIMIT = "TIMELIMIT"
NUMERICAL = "NUMERICAL"
UNKNOWN = "UNKNOWN"


@dataclass
class LPParams:
    """Defaults mirror HLpSolverIGetDefaultParams (ref hdsdp_lpsolve.c:188-219)."""

    abs_opt_tol: float = 1.0
    abs_feas_tol: float = 1.0
    rel_opt_tol: float = 1e-10
    rel_feas_tol: float = 1e-10
    kkt_primal_reg: float = 1e-14
    kkt_dual_reg: float = 1e-12
    potential_rho: float = 2.0
    primal_update_step: float = 0.995
    dual_update_step: float = 0.995
    iterative_tol: float = 1e-12
    scaling_thresh_tol: float = 1e-04
    barrier_lower_coeff: float = 1e-03
    time_limit: float = 7200.0
    n_scal_iter: int = 10
    max_iter: int = 100
    scal_method: str = "geometric"  # ruiz | geometric | l2 | none
    primal_method: bool = True
    # measured factor:solve wall-time ratio above which the primal-only
    # phase may engage (ref hdsdp_lpsolve.c:501-503 uses 50.0)
    primal_switch_ratio: float = 50.0
    n_inner_cg: int = 0  # ref default: preconditioner-only (see module doc)
    verbose: bool = True


@dataclass
class LPResult:
    status: str
    p_obj: float
    d_obj: float
    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    n_iters: int
    solve_time: float
    p_infeas: float = 0.0
    d_infeas: float = 0.0
    # which phase ended the solve ("pd" or "primal") and the measured
    # factor:solve wall-time ratio that gates the switch (inf: not measured)
    last_method: str = "pd"
    factor_solve_ratio: float = float("inf")


# ----------------------------------------------------------------------
# scaling (ref csp_ruizscal / csp_geoscal / csp_l2scal, linalg/sparse_opts.c)
# ----------------------------------------------------------------------


def scale_data(A: np.ndarray, method: str, n_iter: int):
    """Returns (row_scal, col_scal) with A_scaled = R^-1 A C^-1 semantics
    matching the reference (entries divided by the scalers)."""
    nrow, ncol = A.shape
    r = np.ones(nrow)
    c = np.ones(ncol)
    B = np.abs(A).astype(np.float64)
    if method == "ruiz":
        for _ in range(n_iter):
            rmax = np.sqrt(B.max(axis=1))
            rmax[rmax == 0] = 1.0
            B /= rmax[:, None]
            r *= rmax
            cmax = np.sqrt(B.max(axis=0))
            cmax[cmax == 0] = 1.0
            B /= cmax[None, :]
            c *= cmax
    elif method == "geometric":
        with np.errstate(divide="ignore"):
            for _ in range(2):
                nzmask = B > 0
                rmin = np.where(nzmask, B, np.inf).min(axis=1)
                rmax = B.max(axis=1)
                g = np.sqrt(rmin * rmax)
                g[~np.isfinite(g) | (g == 0)] = 1.0
                B /= g[:, None]
                r *= g
                cmin = np.where(B > 0, B, np.inf).min(axis=0)
                cmax = B.max(axis=0)
                g = np.sqrt(cmin * cmax)
                g[~np.isfinite(g) | (g == 0)] = 1.0
                B /= g[None, :]
                c *= g
    elif method == "l2":
        g = np.linalg.norm(B, axis=1)
        g[g == 0] = 1.0
        r *= g
        B /= g[:, None]
        g = np.linalg.norm(B, axis=0)
        g[g == 0] = 1.0
        c *= g
    return r, c


# ----------------------------------------------------------------------
# device steps: plain functions of tensors on one device
# ----------------------------------------------------------------------


def _read(*xs) -> list:
    """Several 0-dim device values in one host copy."""
    return torch.stack([x.to(torch.float64) for x in xs]).tolist()


def _ratio(v, dv):
    """Max step with v + a*dv >= 0, capped at 100
    (ref HLpSolverISingleRatioTest, :533-547)."""
    t = torch.min(dv / v)
    return torch.where(t >= 0.0, 100.0, 1.0 / torch.abs(t))


def _plus_diag(M, d):
    """M + d I (d a 0-dim tensor or a float), as a new tensor."""
    out = M.clone()
    out.diagonal().add_(d)
    return out


def _normal_matrix(A, d2, reg):
    """A diag(d2) A' + reg I."""
    return _plus_diag((A * d2[None, :]) @ A.T, reg)


def _ladder_base(M):
    return torch.max(torch.diagonal(M)) * 1e-14 + 1e-300


def _attempt(M, base, k: int):
    """(L, ok) of rung k: the factor of M + base 100^k I (rung 0: M).
    A failed factor is NaN (``ops.chol.psd_check``)."""
    ok, L = psd_check(_plus_diag(M, base * 100.0 ** k) if k > 0 else M)
    return L, ok


def _factor_ladder(M, k0: int = 0, first=None):
    """Cholesky with a diagonal regularization ladder.

    Degenerate LPs (redundant equality rows: acc-tight*) make the normal
    equations A D^2 A' singular; the reference's LDL' backends absorb this
    with static regularization (ref hdsdp_lpkkt.c / qdldl).  Rung ``k``
    adds ``max(diag) * 1e-14 * 100^k`` to the diagonal (rung 0 = none);
    the first attempt is at the carried rung ``k0`` so a persistently
    singular system pays the escalation once, not every iteration; on
    failure rungs k0+1 .. k0+7 are tried in order and the first that
    factors is taken.  ``first`` is the (L, ok) of rung k0 where the
    caller already has it.  Reads the device once per rung tried.
    Returns (L, ok, rung) with Python ``ok`` and ``rung``; when every rung
    fails, the NaN factor of rung k0."""
    base = _ladder_base(M)
    L, ok = first if first is not None else _attempt(M, base, k0)
    if bool(ok):
        return L, True, k0
    for k in range(k0 + 1, k0 + 8):
        Lk, okk = _attempt(M, base, k)
        if bool(okk):
            return Lk, True, k
    return L, False, k0


def _mehrotra_start(A, b, c, dual_reg):
    """ref HLpSolverIComputeMehrotraStartingPoint (:313-382)."""
    nrow, ncol = A.shape
    M = _plus_diag(A @ A.T, dual_reg)
    L, _, _ = _factor_ladder(M)
    x = A.T @ chol_solve(L, b)
    y = chol_solve(L, A @ c)
    s = c - A.T @ y
    s = torch.where(torch.sum(torch.abs(s)) < 1e-08, s + 1.0, s)
    dx = torch.clamp(-1.5 * torch.min(x), min=0.0)
    ds = torch.clamp(-1.5 * torch.min(s), min=0.0)
    dxs = 0.5 * torch.sum((x + dx) * (s + ds))
    dxc = dx + dxs / (torch.sum(s) + ncol * ds)
    dsc = ds + dxs / (torch.sum(x) + ncol * dx)
    x = x + dxc
    s = s + dsc
    mu = torch.sum(x * s) / ncol
    return x, y, s, mu


def _pd_update(A, b, c, x, y, s, mu, d2, M, L, barrier_lb, p_upd, d_upd):
    """The predictor-corrector update from the factor L of M."""
    ncol = A.shape[1]
    rp = A @ x - b  # primal residual vector (A x - b)
    rd = s + A.T @ y - c  # dual residual (A'y + s - c)

    def msolve(r):
        """Cholesky solve + one iterative-refinement sweep: stabilizes the
        late-IPM normal equations whose conditioning grows like mu^-2."""
        t = chol_solve(L, r)
        return t + chol_solve(L, r - M @ t)

    # predictor: dy = M \ (b - A*(d2 .* rd));  (rd enters with ref's sign)
    xsinv_rd = d2 * (-rd)
    rhs = b - A @ (-xsinv_rd)  # = b - A(d2 .* rd_ref), rd_ref = c - A'y - s
    dy_a = msolve(rhs)
    dx_a = -xsinv_rd - x + d2 * (A.T @ dy_a)
    ds_a = -s - dx_a / d2

    ap = torch.clamp(_ratio(x, dx_a), max=1.0)
    ad = torch.clamp(_ratio(s, ds_a), max=1.0)

    mu_aff = torch.sum((x + ap * dx_a) * (s + ad * ds_a)) / ncol
    sigma3 = (mu_aff / mu) ** 3
    mu_t = torch.minimum(torch.clamp(mu * sigma3, min=barrier_lb),
                         torch.as_tensor(mu, dtype=x.dtype, device=x.device))

    # corrector
    rmu = x * s + dx_a * ds_a - mu_t
    rhs = A @ (rmu / s) - rp - A @ (-xsinv_rd)
    dy = msolve(rhs)
    dx = -xsinv_rd - rmu / s + d2 * (A.T @ dy)
    ds = -rmu / x - dx / d2

    ap = torch.clamp(p_upd * _ratio(x, dx), max=1.0)
    ad = torch.clamp(d_upd * _ratio(s, ds), max=1.0)

    x = x + ap * dx
    s = s + ad * ds
    y = y + ad * dy
    mu = torch.clamp(torch.sum(x * s) / ncol, min=barrier_lb)
    return x, y, s, mu, ap, ad


def _pd_step(A, b, c, x, y, s, mu, barrier_lb, p_upd, d_upd, p_reg, d_reg, rung,
             extra=None):
    """One Mehrotra predictor-corrector iteration
    (ref HLpSolverITakePrimalDualStep, :558-681).

    The step runs on the factor of the carried rung; the device is read
    once, for that factor's flag together with (mu, ap, ad) and the 0-dim
    tensors ``extra(x, y, s)`` gives on the new iterate.  Only when that
    factor failed does the regularization ladder climb (one read per rung)
    and the step run again on the factor it found.  Returns (x, y, s, mu,
    ap, ad) as tensors, ``ok`` and ``rung`` as Python values, and the host
    values [mu, ap, ad, *extra]."""
    d2 = x / s + p_reg
    M = _normal_matrix(A, d2, d_reg)
    first = _attempt(M, _ladder_base(M), rung)

    def run(L, ok):
        new = _pd_update(A, b, c, x, y, s, mu, d2, M, L, barrier_lb, p_upd, d_upd)
        more = extra(*new[:3]) if extra is not None else ()
        vals = _read(ok, *new[3:], *more)
        return new, vals[0] != 0.0, vals[1:]

    new, ok, vals = run(*first)
    if not ok:
        L, ok, rung = _factor_ladder(M, rung, first=(first[0], False))
        if ok:
            new, _, vals = run(L, torch.ones((), dtype=torch.bool, device=x.device))
    return (*new, ok, rung, vals)


def _primal_step(A, b, c, x, y, s, mu, L0, d0, rho, thresh, p_upd, d_upd, d_reg,
                 n_inner: int):
    """Primal-only step with frozen preconditioner L0 of A diag(d0^2) A'
    (ref HLpSolverITakePrimalStep, :949-1092)."""
    ncol = A.shape[1]
    rp = A @ x - b
    # the reference stores dDualInfeasVec = A'y + s - c (ref :404-411)
    rd = -(c - A.T @ y - s)

    # shifted scaling matrix (ref :969-982)
    small = x < thresh
    v = torch.where(small, x, d0)
    err = torch.where(small, 1.0, v / x)
    v2 = v * v

    rhs = A @ (v * ((v * s) / mu - err))
    d_inf_rel = torch.linalg.norm(rd) / (torch.linalg.norm(c) + 1.0)
    rhs = rhs - (d_inf_rel > 1e-12).to(A.dtype) * (A @ (v2 * rd / mu))
    rhs = rhs - rp

    # fixed-preconditioner solve (+ optional true PCG refinement)
    dy_over_mu = chol_solve(L0, rhs)

    def matvec(p):
        return A @ (v2 * (A.T @ p)) + d_reg * p

    if n_inner > 0:
        r = rhs - matvec(dy_over_mu)
        z = chol_solve(L0, r)
        p, rz = z, r @ z
        for _ in range(n_inner):
            Mp = matvec(p)
            alpha = rz / (p @ Mp)
            dy_over_mu = dy_over_mu + alpha * p
            r = r - alpha * Mp
            z = chol_solve(L0, r)
            rz_new = r @ z
            p = z + (rz_new / rz) * p
            rz = rz_new

    dy = mu * dy_over_mu
    ds = -rd - A.T @ dy
    dx = err * v - (v2 * (s + ds)) / mu

    ap = torch.clamp(p_upd * _ratio(x, dx), max=1.0)
    ad = torch.clamp(d_upd * _ratio(s, ds), max=1.0)

    x = x + ap * dx
    s_cand = s + ad * ds
    y_cand = y + ad * dy

    # additional dual ratio test (ref :1040-1054): accept the full dual
    # update only if c - A'y stays nonnegative
    s_full = c - A.T @ y_cand
    dual_feas = torch.all(s_full >= 0.0)
    s_new = torch.where(dual_feas, s_full, s_cand)

    compl = x * s_new
    gap = torch.sum(compl) / ncol
    target_feas = torch.clamp(torch.sum(x * s_new) / (ncol * rho), max=mu)
    bstep = torch.clamp(torch.minimum(ap, ad), max=0.6)
    target_infeas = mu * (1.0 - bstep)
    target = torch.where(dual_feas, target_feas, target_infeas)
    target = torch.maximum(target, gap / 10.0)

    prox = torch.max(torch.abs(compl / gap - 1.0))
    p_inf_rel = torch.linalg.norm(A @ x - b) / (torch.linalg.norm(b) + 1.0)
    target = torch.where(prox < 1.0, target * 0.3, target)
    target = torch.where((prox > 100.0) & (p_inf_rel > 1e-10), torch.clamp(gap, max=mu),
                         target)
    return x, y_cand, s_new, target, ap, ad


def _factor_normal(A, d2, reg):
    """Factor A diag(d2) A' + reg I (the measured 'factor' op)."""
    L, _, _ = _factor_ladder(_normal_matrix(A, d2, reg))
    return L


# ----------------------------------------------------------------------
# solver driver
# ----------------------------------------------------------------------


class LPSolver:
    """min c'x s.t. Ax = b, x >= 0 (dense A) on one device (default
    "cuda", which raises when no card is usable)."""

    def __init__(self, A: np.ndarray, b: np.ndarray, c: np.ndarray, params=None,
                 device="cuda"):
        self.params = params or LPParams()
        self.device = resolve_device(device)
        self.nrow, self.ncol = A.shape
        p = self.params

        method = p.scal_method
        if method not in ("ruiz", "geometric", "l2", "none"):
            raise ValueError(f"unknown scaling method {method}")
        self.rscal, self.cscal = (
            scale_data(A, method, p.n_scal_iter)
            if method != "none"
            else (np.ones(self.nrow), np.ones(self.ncol))
        )
        As = A / self.rscal[:, None] / self.cscal[None, :]
        bs = b / self.rscal
        cs = c / self.cscal

        # adaptive thresholds (ref HLpSolverICollectLpStats, :270-277)
        a_fro = float(np.linalg.norm(As))
        self.thresh = 1e-03 / max(a_fro, 1e-300)
        self.barrier_lower_coeff = p.barrier_lower_coeff
        if float(np.abs(cs).max(initial=0.0)) < 1e-08:
            self.thresh = 1e-03 / np.sqrt(self.ncol)
            self.barrier_lower_coeff = 1e-05

        def dev(v):
            return torch.as_tensor(np.ascontiguousarray(v), dtype=DTYPE, device=self.device)

        self.A, self.b, self.c = dev(As), dev(bs), dev(cs)
        self._rscal_t, self._cscal_t = dev(self.rscal), dev(self.cscal)
        self.b_norm = float(np.linalg.norm(bs))
        self.c_norm = float(np.linalg.norm(cs))

    def _stats_t(self, x, y, s):
        """Unscaled residual norms and objectives as 0-dim device tensors
        (ref HLpSolverIComputeSolutionStats)."""
        rp = (self.A @ x - self.b) * self._rscal_t
        rd = (s + self.A.T @ y - self.c) * self._cscal_t
        return (torch.linalg.norm(rp), torch.linalg.norm(rd), self.c @ x, self.b @ y)

    def _stats(self, x, y, s):
        return tuple(_read(*self._stats_t(x, y, s)))

    def _switch_t(self, x_new, x_old):
        """(euclid, thr_metric) of the switch-over test on the device."""
        diff = torch.abs(x_new - x_old)
        scal_diff = diff / torch.clamp(x_old, min=1e-300)
        thr = torch.where(x_new > self.thresh, scal_diff, diff)
        return torch.max(diff), torch.max(thr)

    def optimize(self) -> LPResult:
        p = self.params
        t0 = time.time()
        barrier_lb = p.rel_feas_tol * self.barrier_lower_coeff

        x, y, s, mu = _mehrotra_start(self.A, self.b, self.c, p.kkt_dual_reg)
        mu = float(mu)

        status = UNKNOWN
        method = "pd"
        L0 = None
        d0 = None
        ap = ad = 0.0
        n_iter = 0
        # best-iterate safeguard: the normal equations' conditioning grows
        # like mu^-2, so late iterations can regress; keep the best point
        # (analogue of the reference's primal-stats stall machinery,
        # ref HPrimalStatsSuperlinerTest / HLpSolverICheckPrimalStats)
        best_metric = np.inf
        best_point = None
        n_stall = 0
        # factor:solve WALL-TIME ratio, measured on the actual device ops
        # (ref uses measured times as the policy signal,
        # def_hdsdp_lpkkt.h:42-46, hdsdp_lpsolve.c:501-503); measured once
        # after warm-up at iteration 2
        self.stats = PhaseStats()
        factor_solve_ratio = 0.0
        reg_rung = 0  # carried regularization-ladder rung (see _factor_ladder)

        if p.verbose:
            print(
                f"Optimizing an LP of {self.ncol} variables and "
                f"{self.nrow} constraints (hybrid primal-dual)"
            )
            print(
                f"    {'nIter':>5s} {'pObj':>15s} {'dObj':>15s} "
                f"{'pInf':>8s} {'dInf':>8s} {'Mu':>8s} {'P/D Step':>10s}"
            )

        for n_iter in range(1, p.max_iter + 1):
            x_old = x

            def extra(xn, yn, sn):
                # the residuals and objectives of the new iterate, and the
                # switch-over metrics, read with the step's own scalars
                more = self._stats_t(xn, yn, sn)
                if method == "pd" and p.primal_method:
                    more = more + self._switch_t(xn, x_old)
                return more

            if method == "primal":
                *new, mu_t, ap_t, ad_t = _primal_step(
                    self.A, self.b, self.c, x, y, s, mu, L0, d0,
                    p.potential_rho, self.thresh, p.primal_update_step,
                    p.dual_update_step, p.kkt_dual_reg, p.n_inner_cg,
                )
                vals = _read(mu_t, ap_t, ad_t, *extra(*new))
            else:
                *new, _, _, _, ok, rung, vals = _pd_step(
                    self.A, self.b, self.c, x, y, s, mu, barrier_lb,
                    p.primal_update_step, p.dual_update_step,
                    p.kkt_primal_reg, p.kkt_dual_reg, reg_rung, extra,
                )
                reg_rung = min(int(rung), 8)
                if not ok:
                    # even the regularization ladder failed: classify via
                    # the best iterate below
                    status = OPTIMAL if best_metric <= 1e-06 else NUMERICAL
                    break
            mu_new, ap, ad, p_inf, d_inf, p_obj, d_obj, *sw = vals
            if not np.isfinite(mu_new):
                status = NUMERICAL
                break
            x, y, s = new
            mu = mu_new

            if n_iter == 2 and p.primal_method and factor_solve_ratio == 0.0:
                # one-time measurement of the factor:solve wall-time ratio
                # on the warm device ops
                d2m = x / s + p.kkt_primal_reg
                tf = profile_fn(_factor_normal, self.A, d2m, p.kkt_dual_reg, n=2)
                Lm = _factor_normal(self.A, d2m, p.kkt_dual_reg)
                ts = profile_fn(chol_solve, Lm, self.b, n=2)  # the measured 'solve' op
                self.stats.factor_s += tf
                self.stats.solve_s += max(ts, 1e-12)
                self.stats.n_factor += 1
                self.stats.n_solve += 1
                factor_solve_ratio = self.stats.factor_solve_ratio

            gap = abs(p_obj - d_obj)
            gap_rel = gap / (abs(p_obj) + abs(d_obj) + 1.0)
            p_inf_rel = p_inf / (self.b_norm + 1.0)
            d_inf_rel = d_inf / (self.c_norm + 1.0)

            if p.verbose:
                print(
                    f"    {n_iter:5d} {p_obj:+15.8e} {d_obj:+15.8e} "
                    f"{p_inf_rel:8.2e} {d_inf_rel:8.2e} {mu:8.2e} "
                    f"{float(ap):5.2f} {float(ad):5.2f}"
                )

            metric = max(gap_rel, p_inf_rel, d_inf_rel)
            if metric < best_metric:
                best_metric = metric
                best_point = (x, y, s)  # tensors are never updated in place
                n_stall = 0
            else:
                n_stall += 1

            if (
                gap_rel <= p.rel_opt_tol
                and p_inf_rel <= p.rel_feas_tol
                and d_inf_rel <= p.rel_feas_tol
                and gap <= p.abs_opt_tol
                and p_inf <= p.abs_feas_tol
                and d_inf <= p.abs_feas_tol
            ):
                status = OPTIMAL
                break
            if n_stall >= 8 or metric > 1e+04 * best_metric:
                # no progress: restore the best point and classify (1e-6
                # relative acceptance; cf. the 1e-2 DIMACS gate on the SDP
                # side, ref hdsdp.c:905-921)
                status = OPTIMAL if best_metric <= 1e-06 else NUMERICAL
                if p.verbose:
                    print(
                        f"Stalling detected; returning best iterate "
                        f"(metric {best_metric:.2e})"
                    )
                break
            if not np.isfinite(gap):
                status = NUMERICAL
                break
            if time.time() - t0 > p.time_limit:
                status = TIMELIMIT
                break

            # switch-over test (ref HLpSolverICheckPrimalStats, :491-531)
            if method == "pd" and p.primal_method:
                euclid, thr_metric = sw
                cond_est = (
                    ((1 + thr_metric) / (1 - thr_metric)) ** 2
                    if thr_metric < 1.0
                    else np.inf
                )
                cond2 = (cond_est < 100.0 or euclid < 1e-05) and (
                    gap_rel < 1e-03 and gap_rel > p.rel_opt_tol * 1e+02
                )
                cond3 = euclid < 1e-05 and float(ap) >= 0.1
                if factor_solve_ratio >= p.primal_switch_ratio and (cond2 or cond3):
                    if p.verbose:
                        print("Primal interior point method starts")
                    d0 = x.clone()
                    M0 = _normal_matrix(self.A, d0 * d0, p.kkt_dual_reg)
                    _, L0 = psd_check(M0)  # NaN on failure, as in JAX
                    method = "primal"
        else:
            status = MAXITER

        if best_point is not None:
            # report the best iterate seen, not the last one
            p_inf, d_inf, p_obj, d_obj = self._stats(x, y, s)
            cur_metric = max(
                abs(p_obj - d_obj) / (abs(p_obj) + abs(d_obj) + 1.0),
                p_inf / (self.b_norm + 1.0),
                d_inf / (self.c_norm + 1.0),
            )
            if best_metric < cur_metric:
                x, y, s = best_point

        self.last_method = method  # "pd" or "primal" (which phase ended)
        self.factor_solve_ratio = self.stats.factor_solve_ratio
        p_inf, d_inf, p_obj, d_obj = self._stats(x, y, s)

        def host(v):
            return v.detach().cpu().numpy()

        return LPResult(
            status=status,
            p_obj=p_obj,
            d_obj=d_obj,
            x=host(x) / self.cscal,
            y=host(y) / self.rscal,
            s=host(s) * self.cscal,
            n_iters=n_iter,
            solve_time=time.time() - t0,
            p_infeas=p_inf,
            d_infeas=d_inf,
            last_method=method,
            factor_solve_ratio=self.factor_solve_ratio,
        )


def solve_mps_file(path: str, device="cuda", **param_overrides) -> LPResult:
    """Extension-dispatch driver for .mps (ref tests/test_file_io.c:89-183)."""
    device = resolve_device(device)  # before any parsing
    data = read_mps(path)
    A = np.zeros((data.nrow, data.ncol))
    for j in range(data.ncol):
        lo, hi = data.col_ptr[j], data.col_ptr[j + 1]
        A[data.row_idx[lo:hi], j] += data.val[lo:hi]
    params = LPParams(**param_overrides)
    solver = LPSolver(A, data.b, data.c, params, device=device)
    res = solver.optimize()
    # map back to the original objective space
    res.p_obj = data.objsense * res.p_obj + data.obj_shift
    res.d_obj = data.objsense * res.d_obj + data.obj_shift
    if params.verbose:
        print(f"\nLP Status: {res.status}")
        print(f"  pObj {res.p_obj:+15.10e}")
        print(f"  dObj {res.d_obj:+15.10e}")
    return res
