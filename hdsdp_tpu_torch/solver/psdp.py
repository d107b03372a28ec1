"""PSDP primal refinement (ref interface/hdsdp_psdp.c).

When Phase B nearly converges, a primal-dual pair (X, y, S) is refined by a
primal interior-point method: the Schur machinery is reused with X in place
of S^-1 (KKT_TYPE_PRIMAL, ref hdsdp_conic_sdp.c:1745-1756) and factored
ONCE; each iteration solves

    M dy = A(XSX/mu - X) + (b - A(X)),        M_ij = tr(A_i X A_j X)

then steps  y += a_d*dy,  X += a_p*(X - XSX/mu - Xs dS Xs / mu)
(ref HPSDPOptimize, hdsdp_psdp.c:164-457), with ratio tests on both the
dual cone (S + a*dS >= 0) and the primal factor (X + a*dX >= 0).
On any failure the dual iterate is restored (ref HPSDPIRecover, :31-47).

X / XSX / dX are batched per block group; the X-weighted Schur build runs
the same buckets as the dual build (U -> X).  After a matrix-free dual
solve the refiner either materializes its X-weighted M once (in row chunks
from 8192 rows on) or, where a dense M is not affordable, runs every solve
as CG on the X-weighted operator.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from hdsdp_tpu_torch.ops import chol as chol_ops
from hdsdp_tpu_torch.ops import ratio as ratio_ops
from hdsdp_tpu_torch.ops import schur as schur_ops
from hdsdp_tpu_torch.utils import profile
from hdsdp_tpu_torch.utils.device import jdot, jlift


def _build_primal_kkt(groups, X_list, m, hp=False):
    """M_ij = sum tr(A_i X A_j X) (KKT_TYPE_PRIMAL: X replaces S^-1)."""
    M = torch.zeros((m, m), dtype=X_list[0].dtype, device=X_list[0].device)
    for ga, X in zip(groups, X_list):
        M = M + schur_ops.group_schur(ga, X, m, with_m=True, hp=hp).M
    return M


def _xsx(X, S):
    """Batched congruence X S X (ref fds_trimultiply), in the wider
    dtype of the two (Params.dtype)."""
    X, S = jlift(X, S)
    return X @ S @ X


def _psd_check_sym(X):
    """``chol_ops.psd_check`` of (X + X^T)/2, which is what the JAX
    package's check sees (``jnp.linalg.cholesky`` symmetrizes by default).
    LAPACK reads one triangle, and the iterate X + a dX carries the
    rounding asymmetry of X S X / mu, which is of the size of the smallest
    eigenvalues of a nearly singular X: on one triangle every refinement
    ends with "stepped X not PSD"."""
    return chol_ops.psd_check(0.5 * (X + X.mT))


def _primal_ratio(X, dX):
    """PSD-check every block of X and bound max a with X + a dX >= 0:
    (ok, step) as 0-dim tensors.  Large blocks go through the Lanczos
    ratio test exactly as the dual side does (the reference gives each
    cone its own primal Lanczos, hdsdp_psdp.c:19-29).  The flag is read
    on the host before the ratio tests: torch's eigensolver raises on the
    NaN factor of a failed check, where the caller wants the flag."""
    ok = None
    Ls = []
    for Xg in X:
        okg, LX = _psd_check_sym(Xg)
        ok = okg if ok is None else ok & okg
        Ls.append(LX)
    step = torch.full((), 1e30, dtype=X[0].dtype, device=X[0].device)
    profile.count("host_reads")
    if not bool(ok):
        return ok, step
    for LX, dXg in zip(Ls, dX):
        steps = ratio_ops.block_ratio(LX, dXg, mode="auto")
        step = torch.minimum(step, torch.min(steps))
    return ok, step


def _post_step(X, S):
    """Joint PSD check of the stepped X and complementarity tr(XS)."""
    ok = None
    compl = torch.zeros((), dtype=X[0].dtype, device=X[0].device)
    for Xg, Sg in zip(X, S):
        okg, _ = _psd_check_sym(Xg)
        ok = okg if ok is None else ok & okg
        compl = compl + torch.sum(Xg * Sg)
    return ok, compl


class PSDPRefiner:
    """The primal refinement of one DualIPM instance."""

    def __init__(self, ipm):
        self.ipm = ipm
        self.X: Optional[List[torch.Tensor]] = None
        self.converged = False
        self.n_iter = 0  # refinement iterations taken
        self.used_operator = False  # the KKT solves ran matrix-free

    def get_primal(self) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        if self.X is None:
            raise RuntimeError("no refined primal: optimize() did not return True")
        return self.X, None

    def optimize(self) -> bool:
        with profile.span("psdp"):
            return self._optimize()

    def _optimize(self) -> bool:
        ipm = self.ipm
        from hdsdp_tpu_torch.solver import algo, dimacs
        from hdsdp_tpu_torch.solver.cones import KKTOut

        # preconditions (ref HPSDPInit: needs zero dual residual, no LP cone)
        if ipm.cones.has_lp or ipm.Rd != 0.0:
            return False
        maker = ipm.maker_acc if ipm.maker_acc.mu > 0.0 else ipm.maker_inacc
        if maker.mu <= 0.0:
            return False
        rec = dimacs.recover_primal(ipm, maker)
        if rec is None:
            return False
        X = [0.5 * (Xg + Xg.mT) for Xg in rec[0]]
        for Xg in X:
            ok, _ = _psd_check_sym(Xg)
            profile.count("host_reads")
            if not bool(ok):
                return False

        m = ipm.m
        b = ipm.b
        mu = ipm.mu
        y_backup = ipm.y
        sum_dims = ipm.all_cone_dims - 2.0 * m  # SDP dims only (ref :199)
        pd_scal = 1.0 / (ipm.rhs_scal * ipm.obj_scal)
        p = ipm.params

        Xscal = list(X)
        ipm.log.info("HDSDP nearly converges. Primal refinement starts.")

        # Operator-mode composition: when the dual solve ran matrix-free
        # the refiner either materializes its own X-weighted M once (the
        # reference's factor-once/solve-many, hdsdp_psdp.c:203-207) while
        # m is small enough to afford a dense system, or runs every PSDP
        # KKT solve through the same matrix-free CG machinery with X in
        # place of S^-1 (M_ij = tr(A_i X A_j X) has the identical
        # operator form).
        use_operator = ipm.kkt_free and (
            m > p.op_materialize_cap
            # a dense f64 M plus factor workspace budgeted at 24 m^2
            # bytes against 12 GB (the JAX package's constant, kept so
            # that both packages take the same branch)
            or 24.0 * m * m > 12e9
            or ipm._op_mat_unavailable
        )
        self.used_operator = use_operator
        op_state: dict = {}

        def fail(reason: str) -> bool:
            # ref HPSDPIRecover + "Primal method fails. Switch back to
            # dual method." (hdsdp_psdp.c:449-455)
            ipm.log.info(f"Primal method fails ({reason}). Switch back to dual method.")
            ipm.y = y_backup
            ipm.check_is_interior(1.0, ipm.y)
            return False

        def factor_primal_kkt():
            if use_operator:
                # the "factor" is the exact Jacobi diagonal of the
                # X-weighted Schur operator (the matrix-free analogue of
                # the reference's one-time HKKTFactorize), upgraded to the
                # chunk-materialized f32 Cholesky preconditioner when the
                # layout supports it (the dual operator path's machinery)
                diag = ipm.cones.kkt_diag(tuple(Xscal), None)
                profile.count("host_reads")
                reg = 1e-16 * float(torch.max(diag)) + 1e-300
                op_state["extra"] = torch.full_like(diag, reg)
                op_state["pinv"] = 1.0 / torch.clamp(diag + reg, min=1e-300)
                op_state["pc"] = None
                if (
                    p.op_precond_cap > 0
                    and m <= p.op_precond_cap
                    and ipm.cones.kkt_rows_supported()
                ):
                    op_state["pc"] = ipm._build_chunked_precond(
                        tuple(Xscal), None, op_state["extra"], diag + reg
                    )
                return

            if ipm._row_sharded():
                # on a mesh each rank builds its rows of the X-weighted M
                # and factor_kkt takes the sharded branch (the distributed
                # Cholesky, or the row-sharded CG from kkt_cg_threshold
                # rows on: JAX psdp.py:203 forces the direct factor only
                # off the mesh)
                M = ipm.cones.primal_kkt(Xscal)
                reg = 1e-16 * M.max_diag(true_rows=True) + 1e-300
                ipm.kkt = KKTOut(
                    M=M.plus_diag(reg, true_rows=True),
                    asinv=None, asinvrdsinv=None, asinvcsinv=None,
                    csinv=None, csinvcsinv=None, csinvrdsinv=None,
                    trace_sinv=None,
                )
                saved_free = ipm.kkt_free
                ipm.kkt_free = False
                try:
                    ipm.factor_kkt(force_direct=False)
                finally:
                    ipm.kkt_free = saved_free
                return

            # from 8192 rows on the X-weighted M comes from row chunks,
            # whose temporaries are [chunk, m] and not [m, m]
            if ipm.cones.kkt_rows_supported() and m >= 8192:
                M = ipm.cones.kkt_full_from_rows(
                    tuple(Xscal), None, ipm._zeros_m(), chunk=p.op_precond_chunk
                )
            else:
                # the cone data in X's dtype (a float32 solve's X is float64)
                groups = ipm.cones.data_for(*Xscal)[0]
                M = _build_primal_kkt(groups, Xscal, m, hp=bool(ipm.cones.kkt_hp))
            # regularize (ref HKKTRegularize with 1e-16 coefficient)
            profile.count("host_reads")
            reg = 1e-16 * float(torch.max(torch.diagonal(M))) + 1e-300
            ipm.kkt = KKTOut(
                M=M + reg * torch.eye(m, dtype=M.dtype, device=M.device),
                asinv=None, asinvrdsinv=None, asinvcsinv=None,
                csinv=None, csinvcsinv=None, csinvrdsinv=None,
                trace_sinv=None,
            )
            # factor-once / solve-many: bypass the CG policy (ref
            # HKKTFactorize once, hdsdp_psdp.c:203-207).  Under operator
            # mode factor_kkt would short-circuit to the dual operator
            # state, so the flag is dropped around the primal factor.
            saved_free = ipm.kkt_free
            ipm.kkt_free = False
            try:
                ipm.factor_kkt(force_direct=True)
            finally:
                ipm.kkt_free = saved_free

        def solve_primal_kkt(rhs):
            """M dy = rhs against the X-weighted system (direct factor,
            chol-preconditioned CG, or restarted Jacobi-PCG runs)."""
            if not use_operator:
                return ipm.solve_kkt(rhs)
            cones = ipm.cones
            Xs, extra = tuple(Xscal), op_state["extra"]
            budget = max(p.kkt_free_maxiter, 600)
            profile.count("host_reads")
            bscale = max(float(torch.linalg.vector_norm(rhs)), 1.0)
            B = rhs[:, None]
            sol = torch.zeros_like(B)
            R = B
            if op_state["pc"] is not None:
                Linv, s = op_state["pc"]
                sol, res, _ = cones.kkt_pcg_chol(
                    Xs, None, extra, Linv, s, B,
                    abs_tol=1e-10, rel_tol=1e-10, max_iter=budget,
                )
                profile.count("host_reads")
                if float(torch.max(res)) <= 1e-06 * bscale:
                    return sol[:, 0]
                # keep the chol iterate: the Jacobi runs below start
                # from its residual
                R = B - cones.kkt_matvec(Xs, None, extra, sol)
            for _ in range(8):
                dsol, _, _ = cones.kkt_pcg(
                    Xs, None, extra, op_state["pinv"], R,
                    abs_tol=1e-10, rel_tol=1e-10, max_iter=budget,
                )
                sol = sol + dsol
                R = B - cones.kkt_matvec(Xs, None, extra, sol)
                profile.count("host_reads")
                if float(torch.linalg.vector_norm(R)) <= 1e-08 * bscale:
                    break
            return sol[:, 0]

        factor_primal_kkt()

        n_bad = 0
        comp_prev = ipm.comp / pd_scal if np.isfinite(ipm.comp) else 1e30
        n_slow = 0  # diminishing-returns exit (beyond the reference)

        for _ in range(100):
            ax = ipm.cones.atx(X, None)
            rp = b - ax
            profile.count("host_reads")
            p_inf_norm = float(torch.linalg.vector_norm(rp))

            # rhs = A(XSX/mu - X) + rp  (ref :240-255)
            buf = [jlift(_xsx(Xg, Sg), by=(mu,))[0] / mu - Xg for Xg, Sg in zip(X, ipm.S)]
            rhs = ipm.cones.atx(buf, None) + rp
            dy = jlift(solve_primal_kkt(rhs), by=(mu,))[0] * mu

            # dual ratio test; dS = -A'dy (Rd = 0)
            dS, _ = ipm.cones.assemble(0.0, -1.0, dy, 0.0)
            profile.count("host_reads")
            d_step = float(ipm.cones.ratio_test(ipm.L, None, dS, None))

            # dX = X - XSX/mu - Xscal dS Xscal / mu  (ref :283-300)
            dX = [-bg - jlift(_xsx(Xs, dSg), by=(mu,))[0] / mu
                  for bg, Xs, dSg in zip(buf, Xscal, dS)]

            # primal ratio test: X + a dX >= 0 (Lanczos at size, exact
            # eigh for small blocks)
            okX, p_step_dev = _primal_ratio(tuple(X), tuple(dX))
            profile.count("host_reads")
            if not bool(okX):
                return fail("X not PSD at ratio test")
            profile.count("host_reads")
            p_step = float(p_step_dev)

            p_step = min(0.5 * p_step, 1.0)
            d_step = min(0.5 * d_step, 1.0)

            # take step (ref :327-339)
            y_new = ipm.y + d_step * dy
            X = [Xg + p_step * dXg for Xg, dXg in zip(X, dX)]

            if not ipm.check_is_interior(1.0, y_new):
                return fail("dual step leaves the cone")
            ipm.y = y_new

            ok_all, compl_dev = _post_step(tuple(X), tuple(ipm.S))
            profile.count("host_reads")
            if not bool(ok_all):
                return fail("stepped X not PSD")

            # objective + barrier update (ref :352-383)
            profile.count("host_reads", 3)
            d_obj = float(jdot(b, ipm.y))
            p_obj = float(ipm.cones.ctx(X, None))
            compl = float(compl_dev)
            if p_obj < d_obj:
                return fail("pObj crossed below dObj")

            target = (p_obj - d_obj) / (2.0 * sum_dims)
            if mu < 1e-09:
                target = min(mu, compl / sum_dims)
            mu = target * (1.0 - 1.0 / np.sqrt(sum_dims))

            # synchronize to solver state (ref :386-401)
            ipm.p_obj_internal = p_obj
            ipm.d_obj_internal = d_obj
            ipm.d_obj_val = d_obj * pd_scal
            ipm.p_obj_val = p_obj * pd_scal
            ipm.p_infeas = p_inf_norm / (1.0 + ipm.f.rhs_one_norm)
            ipm.mu = mu
            ipm.d_step = d_step
            ipm.comp = ipm.p_obj_val - ipm.d_obj_val
            ipm.n_iter += 1
            self.n_iter += 1
            ipm.log.iter_row(
                "psdp", ipm.n_iter + 1, ipm.p_obj_val, ipm.d_obj_val,
                ipm.p_infeas, mu, d_step, p_step,
                time.time() - ipm.time_begin,
            )

            if (
                ipm.comp
                < (abs(ipm.p_obj_val) + abs(ipm.d_obj_val) + 1.0) * p.rel_opt_tol
                and ipm.comp < p.abs_opt_tol * pd_scal
            ):
                ipm.status = algo.PRIMAL_DUAL_OPTIMAL
                self.converged = True
                break

            if n_bad > 2:
                break

            # small steps: refresh scaling matrix + refactor (ref :425-444);
            # X was PSD-verified by _post_step above
            if (p_step < 1e-02 and d_step < 1e-02) or p_step < 1e-03:
                Xscal = list(X)
                factor_primal_kkt()
                n_bad += 1
                ipm.log.info(f"Primal scaling refresh {n_bad}/3")

            if compl > 10.0 * comp_prev:
                break
            if ipm.p_infeas > 1e-06:
                return fail(f"primal infeasibility {ipm.p_infeas:.1e}")

            # Diminishing-returns exit (BEYOND the reference, which burns
            # the remaining iterations to its 100 cap): the per-iteration
            # gap contraction of this method is bounded by
            # (1 - 1/sqrt(sum_dims)), so once the relative gap is already
            # two orders inside the DIMACS acceptance gate (1e-2, ref
            # hdsdp.c:905-921) and contraction has flattened to near that
            # bound, further refinement buys nothing the gate can
            # measure.  Exit cleanly with the refined X; the gate decides.
            gap_rel = ipm.comp / (abs(ipm.p_obj_val) + abs(ipm.d_obj_val) + 1.0)
            # "slow" means slower than halfway between the method's
            # theoretical per-iteration contraction bound and 1: at large
            # blocks the bound itself approaches 1, and a fixed 0.95 would
            # take healthy geometric contraction for a stall
            slow_thresh = 0.5 * (1.0 + (1.0 - 1.0 / np.sqrt(sum_dims)))
            n_slow = n_slow + 1 if compl > slow_thresh * comp_prev else 0
            if n_slow >= 8 and gap_rel < 1e-04:
                ipm.log.info(
                    "Primal refinement has flattened inside the DIMACS "
                    f"gate (rel gap {gap_rel:.1e}); stopping early."
                )
                break
            comp_prev = compl

        self.X = X
        return True
