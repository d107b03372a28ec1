"""Three-phase dual interior-point method, host loop.

Port of the JAX package's ``DualIPM`` host loop (fused=False), itself a
re-derivation of the reference algorithm layer (ref
interface/hdsdp_algo.c):

  Phase A  infeasible-start dual IPM     HDSDP_PhaseA_BarInfeasSolve (:960)
  Phase A' self-dual embedding           HDSDP_PhaseA_BarHsdSolve    (:355)
  Phase B  dual potential reduction      HDSDP_PhaseB_BarDualPotentialSolve (:1658)
  correctors                             (:777, :1481)
  proximity + primal bound recovery      HDSDP_ProxMeasure (:548)

State: the dual iterate is (y, tau, Rd, mu); dual slacks per cone are
S = -Rd*I - A'y + tau*C (+ perturb*I).  The scalar bound cone l <= y <= u
is implicit and takes part in Phase A / B but not in the HSD method.

Control flow runs on the host; every ``bool(...)``/``float(...)`` of a
device tensor below is a sync point, exactly where the JAX host loop reads
a device value back.  Below ``kkt_free_threshold`` rows the Schur system
is dense (m x m): factored by Cholesky with a regularization ladder and an
LU fallback, or, from ``kkt_cg_threshold`` rows on, solved by AdaptiveCG
(ops.cg: refinement against a stale mixed-precision factor) with that
ladder as its escalation.  From ``kkt_free_threshold`` rows on (or with
``kkt_mode="free"``) M is never stored: the system is an operator
(``_build_kkt_operator``) solved by the CG ladder of ``_op_solve``, whose
preconditioner is an f32 Cholesky factor of M assembled in row chunks.
Near convergence phase B hands one-cone problems with n < m/3 to the PSDP
primal refinement (solver.psdp).

``DualIPM.solve`` picks its loop as the JAX package does
(``choose_fused_mode``): by default the fused, device-resident phase
bodies of solver.fused below the memory budget, and this loop above it,
in operator mode, on a mesh or with ``fused=False``.

On a mesh (``parallel``) every rank runs this loop alike: the cone system
is row-sharded (``RowShardedConeSystem`` when every group is a single
block, else ``ShardedConeSystem``), M is a ``RowShard`` factored by the
distributed blocked Cholesky ("shchol") or solved by the row-sharded
Jacobi-PCG ("shcg", from ``kkt_cg_threshold`` rows on), and ``y`` is
checked to agree bit for bit on every rank once an iteration.

The double-single arithmetic path (ops.ddchol, kernel K8): with
``cone_fp="dd"`` every cone factor and interior check of a single block
with n >= 512 is the DD blocked Cholesky (``cones.cone_dd``); with
``kkt_fp="dd"`` the Schur factor is the DD Cholesky with its 6-rung
regularization ladder, solved by f64 iterative refinement against the
kept M (``_dd_refined_solve``), escalating to the f64 ladder when the
refinement stalls.  Every other setting of the two, "auto" included,
takes the f64 factors.  On a mesh, as in the JAX package,
``cone_fp="dd"`` holds on every rank (both mesh systems inherit
``ConeSystem.factor``) and ``kkt_fp="dd"`` changes nothing: the Schur
factor leaves through the row-sharded branch of ``factor_kkt`` before
``_direct_factor``, the only reader of ``_use_dd``.

``dtype="float32"`` (Params.dtype) runs here and on a mesh as in the JAX
package: b, the cone data and the first iterate are float32, and every
operation takes the dtype the JAX package's promotion gives it
(utils.device.jdtype), so y widens to float64 where the JAX loop's does.
The fused driver refuses it (``refuse_f32_fused``), as the JAX one fails
on it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hdsdp_tpu_torch.models.problem import SDPProblem
from hdsdp_tpu_torch.ops import chol as chol_ops
from hdsdp_tpu_torch.ops.cg import AdaptiveCG, factor_scaled_f32
from hdsdp_tpu_torch.ops.ratio import vector_ratio_test
from hdsdp_tpu_torch.solver.cones import ConeSystem, chunk_starts
from hdsdp_tpu_torch.solver.params import Params, adjust_params
from hdsdp_tpu_torch.utils import profile
from hdsdp_tpu_torch.utils.device import jdot, jdtype, jlift, working_dtype
from hdsdp_tpu_torch.utils.log import Logger

INF = 1e30

# statuses (ref hdsdp.h:44-57)
UNKNOWN = "UNKNOWN"
DUAL_FEASIBLE = "DUAL_FEASIBLE"
DUAL_OPTIMAL = "DUAL_OPTIMAL"
PRIMAL_DUAL_OPTIMAL = "PRIMAL_DUAL_OPTIMAL"
MAXITER = "MAXITER"
SUSPECT_INFEAS_OR_UNBOUNDED = "SUSPECT_INFEAS_OR_UNBOUNDED"
INFEAS_OR_UNBOUNDED = "INFEAS_OR_UNBOUNDED"
TIMELIMIT = "TIMELIMIT"
NUMERICAL = "NUMERICAL"
INTERNAL = "INTERNAL_ERROR"
USER_INTERRUPT = "USER_INTERRUPT"


@dataclass
class Maker:
    mu: float = -1.0
    y: Optional[torch.Tensor] = None
    dy: Optional[torch.Tensor] = None


def _chol_ok(L, info) -> bool:
    """A Cholesky factor succeeded and is finite (one or two host reads)."""
    profile.count("host_reads")
    if int(info) != 0:
        return False
    profile.count("host_reads")
    return bool(torch.isfinite(L).all())


def choose_fused_mode(m: int, n_max: int, n_sum: int, kkt_free: bool, params: Params,
                      mesh: bool = False):
    """The IPM mode the JAX package's DualIPM.solve picks
    (hdsdp_tpu/solver/algo.py:1779-1812): "phase" for small problems,
    "iter" while the estimated resident state 128 (m^2 + n_max n_sum)
    bytes fits ``fused_hbm_budget``, else False, the host loop;
    ``fused=True`` means "phase"; operator mode (``kkt_free``) always
    runs the host loop, and so does a mesh (the fused bodies are the
    single-device kernels; the mesh wants the sharded assembly)."""
    if mesh:
        return False
    fused = params.fused
    if fused == "auto":
        est_bytes = 8.0 * 16.0 * (float(m) ** 2 + float(n_max) * float(n_sum))
        if m <= params.fused_max_m and n_max <= params.fused_max_n:
            fused = "phase"
        elif est_bytes <= params.fused_hbm_budget:
            fused = "iter"
        else:
            fused = False
    elif fused is True:
        fused = "phase"
    return False if kkt_free else fused


def _check_supported(params: Params) -> None:
    """Raise for a ``fused`` setting the port does not know."""
    p = params
    if not (isinstance(p.fused, bool) or p.fused in ("auto", "phase", "iter")):
        raise ValueError(f"fused={p.fused!r}: expected True, False, 'auto', 'phase' or 'iter'")


def refuse_f32_fused(params: Params) -> None:
    """The fused driver and solve_batch do not run dtype="float32": the
    JAX package's fused phase bodies fail on it (a lax.cond of an f32
    state against a float64 constant, hdsdp_tpu/solver/fused.py:799-818),
    so there is nothing to hold them to.  The host loop runs it."""
    if working_dtype(params.dtype) != torch.float64:
        raise NotImplementedError(
            f"dtype={params.dtype!r} on the fused driver or solve_batch: pass fused=False "
            "(the host loop runs it, as the JAX package's does)")


class DualIPM:
    """Driver owning the IPM state (ref struct hdsdp, def_hdsdp.h:60-143).
    With a ``mesh`` (parallel.mesh.Mesh) every rank of it runs this driver
    alike on the mesh's device."""

    def __init__(self, prob: SDPProblem, params: Params, device, mesh=None):
        self.prob = prob
        self.params = params
        self.f = prob.features
        adjust_params(params, self.f)
        _check_supported(params)

        self.m = prob.m
        self.dtype = working_dtype(params.dtype)
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"device {self.device} is not the mesh's device {mesh.device}")

        # scaling (ref hdsdp.c:314-320): C *= objScal, b *= rhsScal
        self.obj_scal = self.f.obj_scaling
        self.rhs_scal = self.f.rhs_scaling
        if mesh is None:
            self.cones = ConeSystem(prob, self.device, obj_scal=self.obj_scal, dtype=self.dtype)
        elif all(g.nblk == 1 for g in prob.groups):
            from hdsdp_tpu_torch.parallel.schur import RowShardedConeSystem

            # constraint-row-sharded assembly: M born sharded, stays
            # sharded through the distributed Cholesky / CG
            self.cones = RowShardedConeSystem(prob, mesh, obj_scal=self.obj_scal,
                                              dtype=self.dtype)
        else:
            from hdsdp_tpu_torch.parallel.schur import ShardedConeSystem

            self.cones = ShardedConeSystem(prob, mesh, obj_scal=self.obj_scal, dtype=self.dtype)
        self.cones.ratio_mode = params.ratio_test
        self.cones.lanczos_dim = params.lanczos_dim
        self.cones.cone_dd = self._use_cone_dd()
        self.cones.kkt_hp = params.kkt_hp == "on"
        self.cones.dual_hp = self._use_dual_hp()
        # matrix-free Schur operator (sparse-Schur analogue, ref
        # hdsdp_schur.c:60,227): M never materializes; solves are CG on
        # M v = A(S^-1 (sum_j v_j A_j) S^-1)
        self.kkt_free = self._use_kkt_free()
        self._op_Us = None  # frozen S^-1 per group (the solve operator)
        self._op_slp = None  # frozen LP slack at the full build
        self._op_bound = None  # bound-cone diagonal [m]
        self._op_diag = None  # exact diag(M) incl. bound
        self._op_reg = 0.0
        self._op_pc = None  # (Linv f32, s): stale Cholesky preconditioner
        self._op_pc_refresh = False  # rebuild it before the next system
        self._op_pc_unavailable = False  # its factor failed at every boost
        self._op_escalated = None  # direct factor from a CG stall
        self._op_mat_unavailable = False  # the dense M did not fit
        self.b = self._vec(prob.b * self.rhs_scal)

        # bound cone box (ref hdsdp.c:675-690)
        self.bound_lo = params.dual_box_low
        self.bound_up = params.dual_box_up

        # sum of cone dims + 2*m for the box (ref hdsdp.c:55)
        self.all_cone_dims = float(self.cones.sum_cone_dims + 2 * self.m)

        # iterate (y0 = optional dual warm start, ref HDSDPSetDualStart)
        self.y0 = None
        self.y = self._zeros_m()
        self.tau = 1.0
        self.Rd = 0.0  # scalar dual residual (negative)
        self.mu = 1e+10
        self.perturb = 0.0
        self.p_obj_internal = params.p_obj_start
        self.d_obj_internal = 0.0
        self.p_infeas = 1.0
        self.prox_norm = 0.0
        self.d_step = 0.0
        self.comp = INF
        self.p_obj_val = INF
        self.d_obj_val = 0.0
        self.obj_improve = 0.0

        self.n_iter = 0
        self.n_small_step = 0
        self.status = UNKNOWN
        self.which_method = "infeas"
        self.time_begin = time.time()

        # current factors / buffers
        self.S = self.s_lp = self.L = None
        self.Lchk = self.Schk = self.s_lp_chk = None
        self.dS = self.ds_lp = None
        # bound cone slack vectors
        self.sl = self.su = self.dsl = self.dsu = None
        self.sl_chk = self.su_chk = None

        # KKT exports (device)
        self.kkt = None
        # ("chol", L), ("lu", (LU, pivots)), ("ddchol", (DDFactor, M)),
        # ("cg", M), ("opcg", None), and on a mesh ("shchol",
        # ShardedCholFactor) or ("shcg", RowShard)
        self.Mfac = None
        self._cg: Optional[AdaptiveCG] = None  # made at the first CG system
        self.psdp = None  # the PSDPRefiner that ended the solve, if one did
        self._lz_fused = None  # the fused bodies' Lanczos warm vectors, across phases
        self.d1 = self.d2 = self.d3 = self.d4 = None

        # primal solution makers (ref def_hdsdp.h:107-118)
        self.maker_acc = Maker()
        self.maker_inacc = Maker()

        self.log = Logger(enabled=params.verbose)
        self._factor_stats = {"n_factor": 0, "n_solve": 0, "n_kkt": 0}

    def _vec(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _axpy(self, a, d: torch.Tensor) -> torch.Tensor:
        """y + a d with the JAX package's promotions: a d in the dtype of d
        and a, the sum in the wider of that and y's."""
        d, = jlift(d, by=(a,))
        y, ad = jlift(self.y, a * d)
        return y + ad

    def _zeros_m(self) -> torch.Tensor:
        return torch.zeros((self.m,), dtype=self.dtype, device=self.device)

    def _eye(self, n: int) -> torch.Tensor:
        return torch.eye(n, dtype=self.dtype, device=self.device)

    def _use_kkt_free(self) -> bool:
        """Matrix-free Schur operator gate: engages where a dense m x m M
        would crowd the device (the analogue of the reference's sparse-
        Schur storage decision, hdsdp_schur.c:60,227; there by pattern
        density, here by absolute size)."""
        mode = self.params.kkt_mode
        if mode == "free":
            return True
        if mode != "auto" or self.mesh is not None:
            # "auto" never engages on a mesh (the mesh path row-shards a
            # materialized M); kkt_mode="free" composes with it through
            # the sharded operator matvec (parallel.schur)
            return False
        return self.m >= self.params.kkt_free_threshold

    def _use_cone_dd(self) -> bool:
        """The DD backend of the cone factor and the interior checks: on
        with cone_fp="dd" only ("auto" is the f64 factor)."""
        return self.params.cone_fp == "dd"

    def _use_dd(self) -> bool:
        """The DD backend of the Schur factor: on with kkt_fp="dd" only
        ("auto" is the f64 factor)."""
        return self.params.kkt_fp == "dd"

    def _use_dual_hp(self) -> bool:
        """Ozaki dual-slack assembly: only when kkt_hp is on and the
        O(r m n^2) contraction reaches ~1e11 flops (theta12/torus-22
        scale), as in the JAX package."""
        if not self.cones.kkt_hp:
            return False
        work = 0.0
        for ga in self.cones.groups:
            if ga.Fs is not None and ga.dpos is None and ga.spos is None:
                r, m_, n = ga.Fs.shape
                work += 2.0 * r * m_ * n * n
        return work >= 1e11

    # ------------------------------------------------------------------
    # bound cone helpers (ref hdsdp_conic_bound.c)
    # ------------------------------------------------------------------
    def _bound_step(self, dtau, dy):
        """dsl, dsu for direction (dtau, dy) (ref sBoundConeIUpdateBuffer)."""
        dy, = jlift(dy, by=(dtau,))
        return dy - dtau * self.bound_lo, dtau * self.bound_up - dy

    def _bound_ratio(self, sl, su, dsl, dsu):
        return vector_ratio_test(torch.cat([sl, su]), torch.cat([dsl, dsu]))

    # ------------------------------------------------------------------
    # interior checks (ref HDSDP_CheckIsInterior, hdsdp_algo.c:196-216)
    # ------------------------------------------------------------------
    def check_is_interior(self, tau, y, with_bound=True) -> bool:
        """Assemble S at (tau, y) with the current Rd/perturb and factor."""
        with profile.span("check_interior"):
            S, s_lp, L, sl, su, flags = self.cones.interior_check(
                tau, -1.0, y, -self.Rd + self.perturb, tau,
                self.bound_lo, self.bound_up,
            )
            profile.count("host_reads")
            ok, bound_ok = flags.tolist()  # one host sync for both flags
        if ok:
            self.S, self.s_lp, self.L = S, s_lp, L
        interior = ok
        if with_bound and self.which_method != "hsd":
            if bound_ok:
                self.sl, self.su = sl, su
            interior = interior and bound_ok
        return interior

    def check_expert_chk(self, dC, scal, vec, dEye, with_bound=True) -> bool:
        """Assemble the checker buffer and PSD-check it (BUFFER_DUALCHECK)."""
        S, s_lp = self.cones.assemble(dC, scal, vec, dEye + self.perturb)
        ok, L = self.cones.factor(S, s_lp)
        self.Schk, self.s_lp_chk, self.Lchk = S, s_lp, L
        interior = bool(ok)
        if with_bound:
            # bound cone expert check (ref sBoundConeInteriorCheckExpert)
            vec, = jlift(vec, by=(dC, scal))
            su = dC * self.bound_up + scal * vec
            sl = -dC * self.bound_lo - scal * vec
            self.sl_chk, self.su_chk = sl, su
            interior = interior and bool(torch.all(sl > 0) & torch.all(su > 0))
        return interior

    def logdet_cur(self) -> float:
        """-(sum log det over cones) at the current DUALVAR factors (ref
        HDSDP_GetLogBarrier, hdsdp_algo.c:218-239 returns -logdet)."""
        val = self.cones.logdet(self.L, self.s_lp)
        if self.which_method != "hsd":
            val = val + torch.sum(torch.log(self.sl)) + torch.sum(torch.log(self.su))
        return -float(val)

    # ------------------------------------------------------------------
    # KKT assembly / factor / solve
    # ------------------------------------------------------------------
    def build_kkt(self, kind: str):
        """BuildUp + bound-cone extra (ref HKKTBuildUp).

        kind: "inf" | "hsd" | "corr" (ref KKT_TYPE_*, hdsdp_conic.h:16-19)."""
        self._factor_stats["n_kkt"] += 1
        if self.kkt_free:
            return self._build_kkt_operator(kind)
        kkt = self.cones.build_kkt(self.L, self.s_lp, self.Rd, kind)
        asinv = kkt.asinv
        M = kkt.M
        if self.which_method != "hsd":
            # bound cone contribution (ref sBoundConeGetKKT,
            # hdsdp_conic_bound.c:201-248)
            li = 1.0 / self.sl
            ui = 1.0 / self.su
            asinv = asinv + ui - li
            if kind != "corr":
                d = li * li + ui * ui
                M = M.plus_diag(d) if self._row_sharded() else M + torch.diag(d)
        self.kkt = kkt._replace(M=M, asinv=asinv)
        return self.kkt

    def _build_kkt_operator(self, kind: str):
        """Matrix-free KKT build: RHS vectors + frozen solve operator.

        A full build ("inf"/"hsd") refreshes the operator state (S^-1
        per group, LP slack, bound diagonal, exact Jacobi diagonal); a
        corrector build refreshes the RHS only and keeps solving against
        the operator frozen before, which is the reference's
        reuse-the-factorized-M corrector semantics (ref HKKTBuildUp
        KKT_TYPE_CORRECTOR, hdsdp_schur.c:256-268)."""
        Us = self.cones.inverses(self.L)
        kkt = self.cones.build_kkt_rhs(Us, self.s_lp, self.Rd, kind)
        asinv = kkt.asinv
        bound = self._zeros_m()
        if self.which_method != "hsd":
            li = 1.0 / self.sl
            ui = 1.0 / self.su
            asinv = asinv + ui - li
            bound = li * li + ui * ui
        if kind != "corr":
            self._op_Us = Us
            self._op_slp = self.s_lp
            self._op_bound = bound
            self._op_reg = 0.0
            self._op_diag = self.cones.kkt_diag(Us, self.s_lp) + bound
            self._op_escalated = None  # new operator: drop any stale factor
        self.kkt = kkt._replace(asinv=asinv)
        return self.kkt

    def regularize_kkt(self, reg_coef: float):
        """ref HKKTRegularize (hdsdp_schur.c:348-373)."""
        if self.kkt_free:
            if self._op_diag is None:
                return
            min_diag = float(torch.min(self._op_diag))
            reg = min(reg_coef * min_diag, 1e-05)
            self._op_reg = reg if reg >= 1e-14 else 0.0
            return
        if self.kkt.M is None:
            return
        sharded = self._row_sharded()
        min_diag = (self.kkt.M.min_diag() if sharded
                    else float(torch.min(torch.diagonal(self.kkt.M))))
        reg = min(reg_coef * min_diag, 1e-05)
        if reg < 1e-14:
            reg = 0.0
        if reg:
            # on a mesh the identity tail takes the shift too, as in the
            # JAX package
            M = self.kkt.M.plus_diag(reg) if sharded else self.kkt.M + reg * self._eye(self.m)
            self.kkt = self.kkt._replace(M=M)

    def _f64_factor_ladder(self, M):
        """f64 Cholesky + regularization ladder + LU fallback, as an Mfac
        tuple (the direct analogue of the CG -> LDL switch, ref
        hdsdp_linsolver.c:1827-1857)."""
        L, info = torch.linalg.cholesky_ex(M)
        if _chol_ok(L, info):
            return ("chol", L)
        profile.count("host_reads")
        base = float(torch.max(torch.diagonal(M))) * 1e-14 + 1e-300
        eye = self._eye(M.shape[0])
        for k in range(6):
            reg = base * (10.0 ** (2 * k))
            L, info = torch.linalg.cholesky_ex(M + reg * eye)
            if _chol_ok(L, info):
                return ("chol", L)
        return ("lu", torch.linalg.lu_factor(M))

    def _direct_factor(self, M) -> None:
        """The Schur factor.  With the DD backend (``_use_dd``): the DD
        blocked Cholesky with a 6-rung regularization ladder, kept WITH
        the unshifted M, since its raw solve has a forward error of ~kappa
        2^-45 and solve_kkt refines against M in f64; when every rung
        fails, the f64 ladder."""
        if self._use_dd():
            from hdsdp_tpu_torch.ops import ddchol

            fac = ddchol.factor(M)
            if bool(ddchol.ok(fac)):
                self.Mfac = ("ddchol", (fac, M))
                return
            base = float(torch.max(torch.diagonal(M))) * 1e-14 + 1e-300
            eye = self._eye(M.shape[0])
            for k in range(6):
                fac = ddchol.factor(M + base * (10.0 ** (2 * k)) * eye)
                if bool(ddchol.ok(fac)):
                    # the shifted factor is only the preconditioner: the
                    # refinement targets the original M
                    self.Mfac = ("ddchol", (fac, M))
                    return
        self.Mfac = self._f64_factor_ladder(M)

    def _row_sharded(self) -> bool:
        return getattr(self.cones, "is_row_sharded", False)

    def _sharded_factor(self, M):
        """("shchol", factor) of a RowShard: the distributed blocked
        Cholesky with the 6-rung regularization ladder (no LU rung: the
        JAX package has none on a mesh)."""
        from hdsdp_tpu_torch.parallel.dchol import sharded_cholesky

        self._count("shchol_factors")
        fac = sharded_cholesky(self.mesh, M)
        if not fac.ok:
            base = M.max_diag() * 1e-14 + 1e-300
            for k in range(6):
                fac = sharded_cholesky(self.mesh, M.plus_diag(base * (10.0 ** (2 * k))))
                if fac.ok:
                    break
        return ("shchol", fac)

    def factor_kkt(self, force_direct: bool = False) -> None:
        """Factor (or defer) the Schur system.  With kkt_solver="cg", or
        "auto" from kkt_cg_threshold rows on, the factorization is
        deferred: solves go through AdaptiveCG (ref conjGradSolve + ADPCG
        policy) and escalate to the direct ladder on CG failure.

        ``force_direct`` overrides the CG policy for factor-once /
        solve-many uses (PSDP factors its X-weighted KKT once and then
        performs ~100 solves against it, ref hdsdp_psdp.c:203-207; exact
        solves there decide the refinement step quality)."""
        self._factor_stats["n_factor"] += 1
        if self.kkt_free:
            # nothing to factor: solves run CG on the frozen operator
            # state (see _build_kkt_operator)
            self.Mfac = ("opcg", None)
            return
        M = self.kkt.M
        p = self.params
        use_cg = not force_direct and (
            p.kkt_solver == "cg"
            or (p.kkt_solver == "auto" and self.m >= p.kkt_cg_threshold)
        )
        if self._row_sharded():
            # M never materializes on one rank: the distributed Cholesky,
            # or the row-sharded CG where the policy picks CG
            if use_cg:
                self._count("shcg_factors")
                self.Mfac = ("shcg", M)
            else:
                self.Mfac = self._sharded_factor(M)
            return
        if use_cg:
            if self._cg is None:
                self._cg = AdaptiveCG(abs_tol=1e-10, rel_tol=1e-10)
            self._cg.update(M)
            self.Mfac = ("cg", M)
            return
        self._direct_factor(M)

    def release_solve_buffers(self) -> None:
        """Drop per-iteration device buffers before the final DIMACS
        check: everything the check and the public API need is recomputed
        from (y, makers, cone data).  The CG policy's evidence (factor and
        solve counts, its call ledger) is kept in the factor stats; the
        object itself holds a stale [m, m] preconditioner and goes."""
        self.S = self.s_lp = self.L = None
        self.Schk = self.s_lp_chk = self.Lchk = None
        self.dS = self.ds_lp = None
        self.kkt = None
        self.Mfac = None
        self.d1 = self.d2 = self.d3 = self.d4 = None
        self._op_Us = self._op_diag = self._op_bound = self._op_slp = None
        self._op_escalated = None
        self._op_pc = None
        if self._cg is not None:
            self._factor_stats["cg_n_factor"] = self._cg.n_factor
            self._factor_stats["cg_n_solve"] = self._cg.n_solve
            self._factor_stats["cg_summary"] = self._cg.summary()
            self._cg = None
        self.cones._lz_warm = None

    # ------------------------------------------------------------------
    # matrix-free Schur operator: preconditioner and the CG ladder
    # ------------------------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        self._factor_stats[key] = self._factor_stats.get(key, 0) + n

    def _build_chunked_precond(self, Us, slp, extra, diag):
        """Materialize an equilibrated f32 copy of the operator M (given
        scaling operands Us: S^-1 for the dual system, X for PSDP's) in
        row chunks and return its inverted Cholesky factor (Linv, s), or
        None.  No f64 m x m ever exists: the largest f64 temporaries are
        a few [op_precond_chunk, m] blocks."""
        t0 = time.time()
        p = self.params
        m = self.m
        s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-300))
        chunk = min(p.op_precond_chunk, m)
        Ms = torch.empty((m, m), dtype=torch.float32, device=self.device)
        for i0 in chunk_starts(m, chunk):
            rows = self.cones.kkt_rows(Us, slp, extra, i0, chunk)
            Ms[i0:i0 + chunk] = (s[i0:i0 + chunk, None] * rows * s[None, :]).to(torch.float32)
        del rows
        for dl in (0.0, 1e-06, 1e-04, 1e-02):
            # the equilibrated M has unit diagonal, so dl is a RELATIVE
            # boost; a boosted factor still preconditions M well
            if dl:
                boosted = Ms.clone()
                boosted.diagonal().add_(dl)
                Linv, ok = factor_scaled_f32(boosted)
                del boosted
            else:
                Linv, ok = factor_scaled_f32(Ms)
            if ok:
                self._count("op_pc_builds")
                self.log.info(
                    f"operator f32 preconditioner refreshed "
                    f"(boost {dl:g}, {time.time() - t0:.1f}s)"
                )
                return (Linv, s)
        self.log.info("operator f32 preconditioner factor failed")
        return None

    def _op_build_precond(self) -> bool:
        self._op_pc = None  # the stale factor goes before the new one is built
        pc = self._build_chunked_precond(
            self._op_Us, self._op_slp,
            self._op_bound + self._op_reg,
            self._op_diag + self._op_reg,
        )
        self._op_pc = pc
        if pc is None:
            self._op_pc_unavailable = True
        return pc is not None

    def _op_residual(self, B, X):
        """R = B - M X on the frozen operator and its worst column norm
        relative to max(|B|, 1)."""
        R = B - self.cones.kkt_matvec(
            self._op_Us, self._op_slp, self._op_bound + self._op_reg, X
        )
        bscale = torch.clamp(torch.linalg.vector_norm(B, dim=0), min=1.0)
        return R, float(torch.max(torch.linalg.vector_norm(R, dim=0) / bscale))

    def _op_solve(self, B: torch.Tensor) -> torch.Tensor:
        """CG solve of M X = B [m, k] on the matrix-free operator.

        Tier 0: Cholesky-preconditioned CG against a stale,
        chunk-materialized, inverted f32 factor of M (ADPCG policy:
        refresh on iteration regret or failure), the factorization-grade
        endgame that the Jacobi path lacks.

        The ladder below it (the counterpart of the reference's CG ->
        dense-LDL switch, hdsdp_linsolver.c:1827-1857):

          1. Jacobi-PCG at kkt_free_maxiter; when it proves inadequate
             the f32 preconditioner is built and stays engaged,
          2. on a stall: eight more runs of kkt_free_maxiter steps, each
             restarted from the residual of the iterate so far,
          3. still stalled and m small enough to afford a dense M once:
             materialize M by the dense build, factor it with the direct
             ladder, and solve every remaining system of this KKT round
             against it.
        """
        p = self.params
        max_iter = p.kkt_free_maxiter

        def finish(X, res, n_it, B0):
            # one host read for the step count and the worst residual
            bscale = torch.clamp(torch.linalg.vector_norm(B0, dim=0), min=1.0)
            n_it, worst = torch.stack([n_it.to(res.dtype), torch.max(res / bscale)]).tolist()
            self._count("opcg_iters", int(n_it))
            return X, worst, int(n_it)

        def pcg(B0):
            diag = self._op_diag + self._op_reg
            pinv = 1.0 / torch.clamp(diag, min=1e-300)
            X, res, n_it = self.cones.kkt_pcg(
                self._op_Us, self._op_slp, self._op_bound + self._op_reg, pinv,
                B0, abs_tol=1e-10, rel_tol=1e-10, max_iter=max_iter,
            )
            return finish(X, res, n_it, B0)[:2]

        def pcg_chol(B0):
            Linv, s = self._op_pc
            X, res, n_it = self.cones.kkt_pcg_chol(
                self._op_Us, self._op_slp, self._op_bound + self._op_reg,
                Linv, s, B0, abs_tol=1e-10, rel_tol=1e-10, max_iter=max_iter,
            )
            return finish(X, res, n_it, B0)

        if self._op_escalated is not None:
            # a direct factor from a previous stall this KKT round: keep
            # solving against it (factor-once / solve-many)
            return self._solve_escalated(B)

        use_pc = (
            p.op_precond_cap > 0
            and self.m <= p.op_precond_cap
            and self.mesh is None
            and not self._op_pc_unavailable
            and self.cones.kkt_rows_supported()
        )
        # tier 0: once engaged (a previous Jacobi solve was inadequate),
        # the stale factor carries every later system: the ADPCG
        # diagonal -> Cholesky escalation that STAYS escalated
        if use_pc and self._op_pc_refresh:
            # iteration regret was recorded on the previous system:
            # rebuild now (NOT dropping back to Jacobi first)
            self._op_pc_refresh = False
            self._op_build_precond()
        if use_pc and self._op_pc is not None:
            X, worst, n_it = pcg_chol(B)
            if worst <= 1e-06:
                if n_it > p.op_precond_refresh_iters:
                    # ADPCG iteration-regret rule: converged but slowly;
                    # refresh before the next system
                    self._op_pc = None
                    self._op_pc_refresh = True
                return X
            # the stale factor underperformed: refresh now, retry once
            if self._op_build_precond():
                X, worst, n_it = pcg_chol(B)
                if worst <= 1e-06:
                    return X
            self.log.info(
                f"operator chol-PCG stalled (rel {worst:.2e}); "
                "falling back to the Jacobi ladder"
            )

        X, worst = pcg(B)
        if worst <= 1e-06:
            return X
        # Jacobi proved inadequate for this conditioning: escalate to the
        # chunk-materialized f32 Cholesky preconditioner before the
        # brute-force extension tiers
        if use_pc and self._op_pc is None:
            if self._op_build_precond():
                Xc, worstc, _ = pcg_chol(B)
                if worstc <= 1e-06:
                    return Xc
                if worstc < worst:
                    X, worst = Xc, worstc
        # tier 2: eight RESTARTED runs of kkt_free_maxiter steps, each on
        # the residual of the iterate so far (not one run of eight times
        # the budget: a restart drops the search directions, so the
        # iterates differ)
        self.log.info(f"operator CG stalled (rel {worst:.2e}); extending")
        for _ in range(8):
            R, worst2 = self._op_residual(B, X)
            if worst2 <= 1e-06:
                return X
            dX, _ = pcg(R)
            X = X + dX
        R, worst2 = self._op_residual(B, X)
        if worst2 <= 1e-06:
            return X
        # tier 3: materialize M once and direct-factor it (only when a
        # dense m x m plus its factor plausibly fits).  The build and the
        # factor go through the regular dense machinery.  Running out of
        # device memory is remembered: the same build would fail at every
        # later stall.
        if self.m <= p.op_materialize_cap and not self._op_mat_unavailable:
            self.log.info(
                f"operator CG stalled twice (rel {worst2:.2e}); "
                "materializing M for a direct factor"
            )
            self._count("op_escalations")
            saved_kkt, saved_fac, saved_free = self.kkt, self.Mfac, self.kkt_free
            try:
                kkt = self.cones.build_kkt(self.L, self._op_slp, self.Rd, "inf")
                d = self._op_bound + self._op_reg
                # on a mesh: the padded row-sharded M -> distributed Cholesky
                self.kkt = kkt._replace(M=kkt.M.plus_diag(d) if self._row_sharded()
                                        else kkt.M + torch.diag(d))
                self.kkt_free = False
                self.factor_kkt(force_direct=True)
                self._op_escalated = self.Mfac
            except torch.cuda.OutOfMemoryError as e:
                # The best CG iterate (rel ~1e-5 here) is still a usable
                # step: the IPM corrects itself and the final DIMACS check
                # re-solves its own consistent system.  Any other error
                # propagates.
                self.log.info(
                    f"materialized escalation out of device memory ({e}); "
                    "returning the best CG iterate"
                )
                self._op_escalated = None
                self._op_mat_unavailable = True
                return X
            finally:
                self.kkt, self.Mfac, self.kkt_free = saved_kkt, saved_fac, saved_free
            return self._solve_escalated(B)
        self.log.info(
            f"operator CG stalled (rel {worst2:.2e}); m too large to "
            "materialize M: returning the best iterate"
        )
        return X

    def _solve_escalated(self, B: torch.Tensor) -> torch.Tensor:
        saved = self.Mfac
        self.Mfac = self._op_escalated
        n0 = self._factor_stats["n_solve"]
        try:
            return torch.stack(
                self.solve_kkt_multi([B[:, i] for i in range(B.shape[1])]), dim=1
            )
        finally:
            # the originating operator solve already counted these
            # right-hand sides
            self._factor_stats["n_solve"] = n0
            # a stalled DD refinement inside may have upgraded the factor
            # (ddchol -> chol): keep the upgrade
            self._op_escalated = self.Mfac
            self.Mfac = saved

    def _dd_refined_solve(self, fac_m, B: torch.Tensor) -> torch.Tensor:
        """DD-factor solve + f64 iterative refinement against the kept M:
        takes the forward error from kappa 2^-45 down to the f64 direct
        solve's grade.  Sweeps until the worst column's relative residual
        is <= 1e-12 or a sweep keeps more than 0.9 of the last one's; a
        non-finite residual also ends the sweeps at once (the JAX package's
        comparison never trips on NaN and runs all ten sweeps first,
        hdsdp_tpu/solver/algo.py:864; the outcome, the f64 ladder below, is
        the same).  Accepted at <= 1e-9; else the f64 ladder factors M and
        is KEPT for every later solve against this M."""
        from hdsdp_tpu_torch.ops import ddchol

        fac, M = fac_m
        X = ddchol.solve(fac, B)
        bscale = torch.clamp(torch.linalg.vector_norm(B, dim=0), min=1e-300)

        def worst_of(X):
            R = B - jdot(M, X)
            return R, float(torch.max(torch.linalg.vector_norm(R, dim=0) / bscale))

        prev = None
        for _ in range(10):
            R, worst = worst_of(X)
            if worst <= 1e-12:
                return X
            if worst != worst or (prev is not None and worst > 0.9 * prev):
                break  # stalled, or diverged: more sweeps cannot reach acceptance
            prev = worst
            X = X + ddchol.solve(fac, R)
        _, worst = worst_of(X)
        if worst <= 1e-09:
            return X
        self.log.info(f"DD refinement stalled (rel {worst:.2e}); f64 factor")
        self.Mfac = self._f64_factor_ladder(M)
        return self._solve_mat(B)

    def _solve_mat(self, B: torch.Tensor) -> torch.Tensor:
        kind, fac = self.Mfac
        if kind == "chol":
            return chol_ops.chol_solve(fac, B)
        LU, piv = fac
        return torch.linalg.lu_solve(LU, piv, B)

    def _sharded_solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve against a mesh factor: rhs [m] or [m, k], padded to the
        KKT's padded size and cut back."""
        kind, fac = self.Mfac
        if kind == "shchol":
            from hdsdp_tpu_torch.parallel.dchol import sharded_chol_solve

            return sharded_chol_solve(fac, rhs)[:self.m]
        from hdsdp_tpu_torch.parallel.cg import sharded_pcg

        # the JAX package drops the step count; it is kept in the stats
        x, it = sharded_pcg(self.mesh, fac, rhs, abs_tol=1e-10, rel_tol=1e-10)
        self._count("shcg_iters", it)
        return x[:self.m]

    def solve_kkt(self, rhs: torch.Tensor) -> torch.Tensor:
        self._factor_stats["n_solve"] += 1
        kind, fac = self.Mfac
        if kind == "opcg":
            return self._op_solve(rhs[:, None])[:, 0]
        if kind in ("shchol", "shcg"):
            return self._sharded_solve(rhs)
        if kind == "ddchol":
            return self._dd_refined_solve(fac, rhs[:, None])[:, 0]
        if kind == "cg":
            x, ok = self._cg.solve_checked(fac, rhs)
            if ok:
                return x
            # CG failed even with a fresh Cholesky preconditioner:
            # escalate to the direct ladder (ref hdsdp_linsolver.c:1827-1857)
            self._direct_factor(fac)
            return self.solve_kkt(rhs)
        return self._solve_mat(rhs[:, None])[:, 0]

    def solve_kkt_multi(self, rhs_list):
        """Batch several right-hand sides into one solve."""
        kind, fac = self.Mfac
        if kind == "opcg":
            self._factor_stats["n_solve"] += len(rhs_list)
            X = self._op_solve(torch.stack(rhs_list, dim=1))
            return [X[:, i] for i in range(len(rhs_list))]
        if kind == "shchol":
            self._factor_stats["n_solve"] += len(rhs_list)
            sols = self._sharded_solve(torch.stack(rhs_list, dim=1))
            return [sols[:, i] for i in range(len(rhs_list))]
        if kind == "shcg":
            # one system at a time, as the JAX package solves them
            return [self.solve_kkt(r) for r in rhs_list]
        if kind == "ddchol":
            self._factor_stats["n_solve"] += len(rhs_list)
            sols = self._dd_refined_solve(fac, torch.stack(rhs_list, dim=1))
            return [sols[:, i] for i in range(len(rhs_list))]
        if kind == "cg":
            self._factor_stats["n_solve"] += len(rhs_list)
            X, ok = self._cg.solve_mat_checked(fac, torch.stack(rhs_list, dim=1))
            if ok:
                return [X[:, i] for i in range(len(rhs_list))]
            self._direct_factor(fac)
            return [self.solve_kkt(r) for r in rhs_list]
        self._factor_stats["n_solve"] += len(rhs_list)
        sols = self._solve_mat(torch.stack(rhs_list, dim=1))
        return [sols[:, i] for i in range(len(rhs_list))]

    # ------------------------------------------------------------------
    # step assembly + ratio tests
    # ------------------------------------------------------------------
    def set_step(self, dtau, dy, gamma):
        """dS = gamma*Rd*I - A'dy + C*dtau (ref sdpDenseConeRatioTestImpl)."""
        self.dS, self.ds_lp = self.cones.assemble(dtau, -1.0, dy, gamma * self.Rd)
        self.dsl, self.dsu = self._bound_step(dtau, dy)

    def ratio_test(self, dtau, dy, gamma, buffer: str, with_bound=True) -> float:
        self.set_step(dtau, dy, gamma)
        L = self.L if buffer == "dual" else self.Lchk
        s = self.s_lp if buffer == "dual" else self.s_lp_chk
        step = float(self.cones.ratio_test(L, s, self.dS, self.ds_lp))
        if with_bound and self.which_method != "hsd":
            sl = self.sl if buffer == "dual" else self.sl_chk
            su = self.su if buffer == "dual" else self.su_chk
            step = min(step, float(self._bound_ratio(sl, su, self.dsl, self.dsu)))
        return step

    def add_step_to_checker(self, alpha) -> bool:
        """checker = dualvar + alpha * dstep, then PSD check
        (ref HConeAddStepToBufferAndCheck)."""
        ok, S, s, L = self.cones.add_step_check(
            self.S, self.s_lp, self.dS, self.ds_lp, alpha
        )
        self.Schk, self.s_lp_chk, self.Lchk = S, s, L
        interior = bool(ok)
        if self.which_method != "hsd":
            sl, dsl, su, dsu = jlift(self.sl, self.dsl, self.su, self.dsu, by=(alpha,))
            sl = sl + alpha * dsl
            su = su + alpha * dsu
            self.sl_chk, self.su_chk = sl, su
            interior = interior and bool(torch.all(sl > 0) & torch.all(su > 0))
        return interior

    # ------------------------------------------------------------------
    # starting points (ref HDSDP_SetStart / HDSDP_ResetStart)
    # ------------------------------------------------------------------
    def set_start(self, method: str, d_only: bool):
        self.y = self.y0 if self.y0 is not None else self._zeros_m()
        self.tau = 1.0
        obj_fro = max(self.f.obj_fro_norm * self.obj_scal, 100.0)
        if method == "hsd":
            self.mu = 1e+08
            if d_only:
                self.Rd = -obj_fro * self.params.dual_slack_start
            else:
                self.Rd = -obj_fro * 1e+01
        else:
            self.Rd = -obj_fro * self.params.dual_slack_start
            self.p_infeas = 1.0 + self.f.rhs_fro_norm
            self.p_obj_internal = self.params.p_obj_start
            self.mu = (
                self.p_obj_internal
                - self.d_obj_internal
                - self.Rd * self.params.trx_estimate
            ) / self.all_cone_dims
        self.log.info(f"Initialize with dual residual {-self.Rd:3.1e}")

    def reset_start(self):
        self.y = self._zeros_m()
        self.tau = 1.0
        self.p_obj_internal = 1e+15
        rd = -max(self.f.obj_fro_norm, 1e+02) * 1e+06
        self.Rd = max(rd, -1e+15)
        self.log.info(f"Reset with dual residual {-self.Rd:3.1e}")

    # ------------------------------------------------------------------
    # proximity measure + primal bound (ref HDSDP_ProxMeasure, :548-665)
    # ------------------------------------------------------------------
    def prox_measure(self) -> int:
        mu = self.mu
        p_obj_new = self.d_obj_internal
        acc = self.params.prec_ord_acc

        d1, d2 = jlift(self.d1, self.d2, by=(mu,))
        b, asinv = jlift(self.b, self.kkt.asinv, by=(mu,))
        dy1 = d1 / mu - d2
        v2 = b / mu - asinv
        prox2 = float(jdot(dy1, v2))
        if prox2 < 0.0:
            self.prox_norm = 1.0
            return 0
        self.prox_norm = float(np.sqrt(prox2))

        # primal feasibility: B = -Rd*I + A'(dy1 - y) + C  PSD?
        vec = dy1 - self.y
        # bound cone first (ref :582-583), then SDP/LP cones
        su = self.bound_up + vec
        sl = -self.bound_lo - vec
        self.sl_chk, self.su_chk = sl, su
        feas = bool(torch.all(sl > 0) & torch.all(su > 0))
        if feas:
            feas = self.check_expert_chk(1.0, 1.0, vec, -self.Rd, with_bound=False)
            self.sl_chk, self.su_chk = sl, su
        if not feas:
            return 0

        # relative gap estimate (ref :593-610)
        if self.which_method == "infeas":
            rel_gap = float(jdot(dy1, self.kkt.asinvrdsinv + self.kkt.asinv))
            rel_gap += float(self.kkt.trace_sinv) * self.Rd
        else:
            rel_gap = float(jdot(dy1, self.kkt.asinv))
        rel_gap += self.all_cone_dims
        p_obj_new += rel_gap * mu

        if rel_gap < 0:
            return -1 if rel_gap < -1.0 else 0

        self.p_obj_internal = p_obj_new
        inacc_tol = max(acc, 1e-04)  # (ref :626-627, second line overwrites)

        # primal infeasibility estimate via the bound cone
        # (ref sBoundConeGetPrimal, hdsdp_conic_bound.c:427-445)
        d = -dy1
        slc = self.y - self.bound_lo
        suc = self.bound_up - self.y
        d, slc, suc = jlift(d, slc, suc, by=(mu,))
        xl = mu * (1.0 / slc - d / (slc * slc))
        xu = mu * (1.0 / suc + d / (suc * suc))
        p_inf = float(torch.max(torch.abs(xu - xl)))
        self.p_infeas = 0.0 if p_inf < 1e-16 else p_inf

        if p_inf < 1.0:
            thresh = abs(self.d_obj_internal) + 1.0
            if rel_gap * mu > inacc_tol * thresh:
                self.maker_inacc = Maker(mu=mu, y=self.y, dy=dy1)
            elif rel_gap * mu > acc * thresh:
                self.maker_acc = Maker(mu=mu, y=self.y, dy=dy1)
        return 1

    # ------------------------------------------------------------------
    # Phase A adaptive residual-reduction rate (ref :667-739)
    # ------------------------------------------------------------------
    def adaptive_resi_rate(self) -> float:
        # corrector-like ratio test with dy = -d2
        step = self.ratio_test(0.0, -self.d2, 0.0, "dual")
        alpha_c = min(0.98 * step, 1.0)
        max_step = alpha_c

        # line search on the checker buffer
        interior = False
        while not interior and alpha_c > 1e-02 * max_step:
            interior = self.add_step_to_checker(alpha_c)
            if not interior:
                alpha_c *= 0.8

        # ratio test for s' + alpha * (Rd - A' d3) on the checker
        # (bound cone excluded, ref :719-720 commented out)
        self.set_step(0.0, self.d3, 1.0)
        alpha_inf = float(
            self.cones.ratio_test(self.Lchk, self.s_lp_chk, self.dS, self.ds_lp)
        )

        rate = alpha_inf / alpha_c if alpha_c > 0 else 0.0
        rate = min(0.98 * rate, 1.0)
        if self.prox_norm < 1.0:
            rate = max(0.9, rate)
        elif self.prox_norm < 10.0:
            rate = max(0.3, rate)
        elif self.prox_norm < 50.0:
            rate = max(0.1, rate)
        return rate

    # ------------------------------------------------------------------
    # infeasible corrector (ref HDSDP_Infeasible_Corrector, :777-958)
    # ------------------------------------------------------------------
    def infeasible_corrector(self) -> bool:
        n_max_corr = self.params.corrector_a
        if not self.check_is_interior(1.0, self.y):
            return False

        barrier = self.logdet_cur()
        ratio_max = 0.8

        for _ in range(n_max_corr):
            if self.Rd == 0.0:
                break

            self.build_kkt("corr")
            d2 = self.solve_kkt(self.kkt.asinv)
            d3 = self.solve_kkt(self.kkt.asinvrdsinv) if ratio_max else None

            dy = -d2
            step = self.ratio_test(0.0, dy, 0.0, "dual")
            step = min(0.8 * step, 1.0)

            # guarantee feasibility
            while True:
                cand = self._axpy(step, dy)
                interior = self.check_is_interior(1.0, cand)
                if not interior:
                    step *= 0.5
                if interior or step < 5e-03:
                    break

            if step < 5e-03:
                self.check_is_interior(1.0, self.y)
                break

            new_barrier = self.logdet_cur()
            if new_barrier > barrier:
                step *= 0.5
                cand = self._axpy(step, dy)
                self.check_is_interior(1.0, cand)
                barrier = -INF

            alpha_c = step

            # reduce infeasibility: max step for S' + a*(Rd - A'd3)
            step2 = self.ratio_test(0.0, d3, 1.0, "dual")
            rate = min(1.0, ratio_max * (step2 / alpha_c))

            resi = self.Rd
            while True:
                self.Rd = resi * (1 - alpha_c * rate)
                d2_, d3_ = jlift(d2, d3, by=(rate,))
                cand = self._axpy(alpha_c, rate * d3_ - d2_)
                if self.check_is_interior(1.0, cand):
                    break
                rate *= 0.8

            if alpha_c * rate < 5e-04:
                ratio_max = 0.0
            elif alpha_c * rate < 0.1:
                ratio_max *= 0.9
            if alpha_c * rate > 0.8:
                self.mu *= 0.8
                ratio_max = min(ratio_max * 2.0, 0.9)
            elif alpha_c * rate > 0.3:
                self.mu *= 0.95
                ratio_max = min(ratio_max * 2.0, 0.8)

            self.y = cand
            if ratio_max == 0.0:
                break
            barrier = new_barrier

        return True

    # ------------------------------------------------------------------
    # Phase A main loop (ref HDSDP_PhaseA_BarInfeasSolve, :960-1204)
    # ------------------------------------------------------------------
    def phase_a(self, d_only: bool = False):
        self.which_method = "infeas"
        p = self.params
        f = self.f
        allow_reset = not (f.many_cones or f.implied_trace or f.very_dense)
        feas_tol = max(p.abs_feas_tol, p.rel_feas_tol * (1 + f.obj_one_norm))
        feas_tol = feas_tol * self.obj_scal / np.sqrt(max(f.n_sum_cone_dims, 1))

        self.set_start("infeas", False)

        if not self.check_is_interior(self.tau, self.y):
            self.log.info("Initial point is not in the cone. Adding slack value.")
            self.reset_start()
            if not self.check_is_interior(self.tau, self.y):
                self.status = NUMERICAL
                return

        self.log.header("infeas")
        p_obj_found = 0

        while True:
            if self.n_iter == 3 and not p_obj_found and allow_reset:
                self.log.info("Increasing dual infeasibility")
                self.reset_start()
                if not self.check_is_interior(self.tau, self.y):
                    self.status = NUMERICAL
                    return

            self.build_kkt("inf")
            self.regularize_kkt(0.0)
            self.factor_kkt()
            self.d1, self.d2, self.d3 = self.solve_kkt_multi(
                [self.b, self.kkt.asinv, self.kkt.asinvrdsinv]
            )

            p_obj_type = self.prox_measure()
            if p_obj_type < 0:
                self.status = SUSPECT_INFEAS_OR_UNBOUNDED
            else:
                p_obj_found += p_obj_type

            if p_obj_type == 1 and self.prox_norm < 2.0:
                self.mu *= 0.7

            # barrier update by proximity thresholds (ref :1122-1138)
            target = (
                self.p_obj_internal
                - self.d_obj_internal
                - self.Rd * p.trx_estimate
            ) / (5.0 * self.all_cone_dims)
            if self.prox_norm < 1.0:
                self.mu *= 0.005
            elif self.prox_norm < 5.0:
                self.mu = max(self.mu * 0.01, target * 0.1)
            elif self.prox_norm < 10.0:
                self.mu = max(self.mu * 0.1, target * 0.8)
            else:
                self.mu = max(self.mu * 0.95, target)

            gamma = self.adaptive_resi_rate()

            # dy = d1/mu - d2 + gamma*d3 (ref HDSDP_Infeasible_BuildStep)
            d1, d2, d3 = jlift(self.d1, self.d2, self.d3, by=(self.mu, gamma))
            dy = d1 / self.mu - d2 + gamma * d3

            step = self.ratio_test(0.0, dy, gamma, "dual")
            self.d_step = min(0.95 * step, 1.0)
            if self.d_step < 1e-03:
                self.n_small_step += 1

            self.y = self._axpy(self.d_step, dy)
            self.Rd = self.Rd * (1.0 - gamma * self.d_step)

            if not self.infeasible_corrector():
                if self.status == SUSPECT_INFEAS_OR_UNBOUNDED:
                    break  # preserve SUSPECT: hand off to the HSD phase
                self.status = NUMERICAL
                return
            self.print_log("infeas")

            if abs(self.Rd) < feas_tol:
                self.status = DUAL_FEASIBLE
                break
            if self.n_small_step > 3:
                self.status = SUSPECT_INFEAS_OR_UNBOUNDED
                break
            if self.status == SUSPECT_INFEAS_OR_UNBOUNDED:
                break
            if time.time() - self.time_begin >= p.time_limit:
                self.status = TIMELIMIT
                break
            self.n_iter += 1
            if self.n_iter >= p.max_iter:
                self.status = MAXITER
                break

    # ------------------------------------------------------------------
    # logging (ref HDSDP_PrintLog, :152-194)
    # ------------------------------------------------------------------
    def print_log(self, method: str):
        if self.mesh is not None:
            # once an iteration: every rank must hold the same iterate
            self.mesh.assert_same(self.y, "y")
        pd_scal = 1.0 / (self.rhs_scal * self.obj_scal * self.tau)
        n_sum = max(self.f.n_sum_cone_dims, 1)
        self.d_infeas = np.sqrt(n_sum) * abs(self.Rd) / (self.rhs_scal * self.tau)
        self.d_obj_internal = float(jdot(self.b, self.y))
        self.d_obj_val = self.d_obj_internal * pd_scal
        self.p_obj_val = self.p_obj_internal * pd_scal
        self.comp = self.p_obj_val - self.d_obj_val
        elapsed = time.time() - self.time_begin
        self.log.iter_row(
            method,
            self.n_iter + 1,
            self.p_obj_val,
            self.d_obj_val,
            self.d_infeas if method != "potential" else self.p_infeas,
            self.mu,
            self.d_step,
            self.tau if method == "hsd" else self.prox_norm,
            elapsed,
        )

    # ------------------------------------------------------------------
    # HSD method (ref HDSDP_PhaseA_BarHsdSolve, :355-546)
    # ------------------------------------------------------------------
    def hsd_solve(self, d_only: bool):
        self.which_method = "hsd"
        p = self.params
        f = self.f

        abs_opt = p.abs_opt_tol if d_only else 1e+20
        feas_tol = min(p.abs_feas_tol, p.rel_feas_tol * (1.0 + f.obj_one_norm))
        feas_tol = feas_tol * self.obj_scal / np.sqrt(max(f.n_sum_cone_dims, 1))
        abs_opt = abs_opt * 1e-04
        rel_opt = abs_opt * 1e-04  # (ref :401-402 quirk: derived from abs)

        if self.status == UNKNOWN:
            self.set_start("hsd", d_only)

        self.log.header("hsd")

        while True:
            if not self.check_is_interior(self.tau, self.y, with_bound=False):
                if self.n_iter == 0:
                    self.log.info("Initial point is not in the cone. Adding slack value.")
                    self.Rd *= 100.0
                    self.reset_start()
                    self.n_iter += 1
                    continue
                self.status = NUMERICAL
                return

            self.build_kkt("hsd")
            self.regularize_kkt(0.0)
            self.factor_kkt()
            self.d1, self.d2, self.d3, self.d4 = self.solve_kkt_multi(
                [self.b, self.kkt.asinv, self.kkt.asinvrdsinv, self.kkt.asinvcsinv]
            )

            dtau, dy = self.hsd_build_step()

            # ratio test incl. tau (ref HDSDP_HSD_RatioTest, :316-353)
            max_step = INF
            if dtau != 0.0:
                t = self.tau / dtau
                if t < 0.0:
                    max_step = min(max_step, -t)
            step_c = self.ratio_test(dtau, dy, 1.0, "dual", with_bound=False)
            max_step = min(max_step, step_c)
            if max_step < 1e-02:
                self.n_small_step += 1
                if self.n_small_step > 2:
                    self.log.info("HDSDP stagnates at the cone boundary.")

            # step size ladder (ref :463-471)
            if max_step > 1.0:
                step = min(0.7 * max_step, 1.0)
            elif max_step > 0.5:
                step = min(0.5 * max_step, 1.0)
            elif max_step > 0.2:
                step = min(0.3 * max_step, 1.0)
            else:
                step = min(0.2 * max_step, 1.0)
            self.d_step = step

            self.print_log("hsd")

            self.tau += step * dtau
            self.y = self._axpy(step, dy)
            self.Rd = self.Rd * (1.0 - step)

            # barrier reduction (ref :484-499)
            if self.mu > 1e-12:
                if step > 0.8 and self.tau > 1.0:
                    t = max(0.1 * self.mu, -0.1 * self.Rd / self.tau)
                else:
                    t = max(p.hsd_gamma * self.mu, -0.1 * self.Rd / self.tau)
                self.mu = min(self.mu, t)
            else:
                self.mu = min(self.mu, 0.8 * self.mu)

            if (
                abs(self.Rd) < feas_tol * self.tau
                and self.mu < abs_opt
                and self.mu < rel_opt * (1 + 2.0 * abs(self.d_obj_val))
                and abs(self.obj_improve) < 1e-05 * (abs(self.d_obj_internal) + 1.0)
            ):
                self.status = DUAL_OPTIMAL if d_only else DUAL_FEASIBLE
                break
            if self.tau <= 1e-10:
                self.status = SUSPECT_INFEAS_OR_UNBOUNDED
                break
            if time.time() - self.time_begin >= p.time_limit:
                self.status = TIMELIMIT
                break
            self.n_iter += 1
            if self.n_iter >= p.max_iter:
                self.status = MAXITER
                break

    def hsd_build_step(self):
        """ref HDSDP_HSD_BuildStep (:263-314)."""
        mu, tau = self.mu, self.tau
        b = self.b
        old_obj = self.d_obj_internal
        bty = float(jdot(b, self.y))
        self.d_obj_internal = bty
        self.obj_improve = bty - old_obj

        b, asinvcsinv = jlift(b, self.kkt.asinvcsinv, by=(mu,))
        dd1 = b - mu * asinvcsinv
        csinvcsinv = float(self.kkt.csinvcsinv)
        csinv = float(self.kkt.csinv)
        csinvrdsinv = float(self.kkt.csinvrdsinv)

        num = -bty + mu / tau + mu * (csinv - csinvrdsinv)
        den = mu * csinvcsinv + mu / (tau * tau)
        tau_over_mu = tau / mu
        d1, d2, d3 = jlift(self.d1, self.d2, self.d3, by=(tau_over_mu,))
        num -= float(jdot(dd1, d1 * tau_over_mu - d2 + d3))
        d1, d4 = jlift(self.d1, self.d4, by=(mu,))
        den += float(jdot(dd1, d1 / mu + d4))

        dtau = 0.0 if abs(den) < 1e-12 else num / den
        d1, d2, d3, d4 = jlift(self.d1, self.d2, self.d3, self.d4, by=(tau + dtau, mu, dtau))
        dy = d1 * (tau + dtau) / mu + d4 * dtau - d2 + d3
        return dtau, dy

    # ------------------------------------------------------------------
    # Phase B (ref HDSDP_PhaseB_BarDualPotentialSolve, :1658-1851)
    # ------------------------------------------------------------------
    def phase_b(self):
        self.which_method = "potential"
        p = self.params
        f = self.f
        pd_scal = self.obj_scal * self.rhs_scal
        feas_tol = min(p.abs_feas_tol, p.rel_feas_tol * (1.0 + f.obj_one_norm))
        feas_tol = feas_tol * self.obj_scal / np.sqrt(max(f.n_sum_cone_dims, 1))

        if abs(self.Rd) > feas_tol:
            self.log.info("Dual infeasibility from previous algorithm exceeds tolerance")

        # perturbation absorbs the remaining residual (ref :1699-1708)
        self.perturb = -10.0 * self.Rd
        self.Rd = 0.0
        if self.perturb != 0.0:
            self.check_is_interior(1.0, self.y)

        no_p_obj_found = 0
        force_detect = True
        n_internal = 0
        p_obj_start = self.p_obj_internal
        use_psdp = p.psdp

        self.log.header("potential")

        while True:
            n_internal += 1
            if n_internal > 10:
                force_detect = False

            self.build_kkt("inf")
            if self.mu > 1.0:
                self.regularize_kkt(1e-06)
            self.factor_kkt()
            self.d1, self.d2 = self.solve_kkt_multi([self.b, self.kkt.asinv])

            p_obj_type = self.prox_measure()
            if p_obj_type < 0:
                self.status = SUSPECT_INFEAS_OR_UNBOUNDED
            else:
                no_p_obj_found = 0 if p_obj_type else no_p_obj_found + 1

            if not self.choose_barrier(p_obj_type):
                self.status = NUMERICAL
                return

            dy = self.feasible_build_step()

            if self.primal_infeas_check(force_detect):
                self.log.info("HDSDP detects a dual improving ray")
                self.status = INFEAS_OR_UNBOUNDED
                break

            if not self.reduce_potential(dy):
                self.status = NUMERICAL
                return
            if self.d_step < 1e-03:
                self.n_small_step += 1

            self.feasible_corrector()
            self.print_log("potential")

            if (
                self.comp < (abs(self.p_obj_val) + abs(self.d_obj_val) + 1.0) * p.rel_opt_tol
                and self.comp < p.abs_opt_tol / pd_scal
            ):
                self.status = PRIMAL_DUAL_OPTIMAL
                break

            if (
                (self.d_step == 1.0 or self.mu < 1e-05)
                and self.p_infeas < 1e-06
                and self.comp < (abs(self.p_obj_val) + abs(self.d_obj_val) + 1.0) * 0.1
                and use_psdp
            ):
                from hdsdp_tpu_torch.solver.psdp import PSDPRefiner

                refiner = PSDPRefiner(self)
                refined = refiner.optimize()
                self._count("psdp_runs")
                self._count("psdp_iters", refiner.n_iter)
                if refiner.used_operator:
                    self._count("psdp_op_runs")  # its KKT solves ran matrix-free
                if refined:
                    # A clean PSDP return ends the solve even when not
                    # converged to tolerance (ref hdsdp_algo.c:1806-1814:
                    # retcode OK -> break; the nBadIter/compl-growth exits
                    # return OK).  The DIMACS gate decides the final
                    # status from the refined (X, y) pair; resuming
                    # potential reduction here would move y while X stays
                    # frozen and can drive comp through zero, passing the
                    # comp test with a crude primal.
                    self.psdp = refiner
                    break
                use_psdp = 0

            if self.n_small_step > 3:
                self.status = NUMERICAL
                break
            if self.status == SUSPECT_INFEAS_OR_UNBOUNDED:
                break
            if time.time() - self.time_begin >= p.time_limit:
                self.status = TIMELIMIT
                break
            self.n_iter += 1
            if self.n_iter >= p.max_iter:
                self.status = MAXITER
                break
            if no_p_obj_found >= 10 and self.p_obj_internal != p_obj_start:
                self.status = NUMERICAL
                break

    def choose_barrier(self, p_obj_type: int) -> bool:
        """ref HDSDP_PhaseB_ChooseBarrier (:1235-1332)."""
        p = self.params
        gap = self.p_obj_internal - self.d_obj_internal
        upper = gap / self.all_cone_dims
        lower = upper / p.pot_rho
        max_step = INF

        if p_obj_type > 0:
            d1, = jlift(self.d1, by=(self.mu,))
            dy1 = -d1 / self.mu
            step = self.ratio_test(0.0, dy1, 0.0, "chk")
            step = min(step * 0.97, 1e+05)
            self.mu = self.mu / (1.0 + step)
        else:
            d1, d2 = jlift(self.d1, self.d2, by=(self.mu,))
            dy2 = -d1 / self.mu + d2
            step = self.ratio_test(0.0, dy2, 0.0, "dual", with_bound=False)
            max_step = min(max_step, step)  # SDP/LP cones only (ref :1273-1276)
            step_b = float(self._bound_ratio(self.sl, self.su, self.dsl, self.dsu))
            p_step = min(max_step, step_b)
            if p_step < 1.0:
                p_step = 0.97 * p_step

            n_try = 0
            while True:
                if self.add_step_to_checker(p_step):
                    break
                p_step = p_step * 0.97 if n_try > 2 else p_step * 0.5
                n_try += 1
                if p_step < 1e-05:
                    return False

            d1, = jlift(self.d1, by=(p_step, self.mu))
            dy1 = -p_step * d1 / self.mu
            # second ratio test continues the running min (ref :1314-1322)
            self.set_step(0.0, dy1, 0.0)
            step2 = float(
                self.cones.ratio_test(self.Lchk, self.s_lp_chk, self.dS, self.ds_lp)
            )
            max_step = min(max_step, step2)
            step_b = float(
                self._bound_ratio(self.sl_chk, self.su_chk, self.dsl, self.dsu)
            )
            max_step = min(max_step, step_b)
            max_step = min(max_step * 0.97, 1e+05)
            self.mu = p_step * self.mu / (1.0 + max_step) + (1.0 - p_step) * (
                self.p_obj_internal - self.d_obj_internal
            ) / self.all_cone_dims

        self.mu = max(self.mu, lower)
        self.mu = min(self.mu, upper)
        return True

    def feasible_build_step(self):
        """ref HDSDP_Feasible_BuildStep (:1334-1364)."""
        while True:
            d1, d2 = jlift(self.d1, self.d2, by=(self.mu,))
            b, asinv = jlift(self.b, self.kkt.asinv, by=(self.mu,))
            dy = d1 / self.mu - d2
            v = b / self.mu - asinv
            prox2 = float(jdot(v, dy))
            if prox2 < 0.0:
                self.prox_norm = 1e+02
                return dy
            self.prox_norm = float(np.sqrt(prox2))
            if self.prox_norm >= 0.1:
                return dy
            self.mu = 0.1 * self.mu

    def primal_infeas_check(self, force: bool) -> bool:
        """ref HDSDP_PhaseB_BarPrimalInfeasCheck (:1616-1656)."""
        f = self.f
        trigger = (
            self.p_infeas >= f.rhs_fro_norm
            or force
            or (self.p_infeas > 0.01 * f.rhs_one_norm and self.mu < 1e-03)
        )
        if not trigger:
            return False
        if self.d_obj_val < 0.0:
            return False
        norm = float(torch.linalg.vector_norm(self.y))
        if norm == 0.0:
            return False
        yn = self.y / norm
        # improving ray: 1e-8*I - A'yn PSD over SDP/LP cones
        S, s_lp = self.cones.assemble(0.0, -1.0, yn, 1e-08 + self.perturb)
        ok, L = self.cones.factor(S, s_lp)
        self.Schk, self.s_lp_chk, self.Lchk = S, s_lp, L
        return bool(ok)

    def get_potential(self, rho: float, y) -> float:
        """ref HDSDP_GetPotential (:1366-1387); uses current factors."""
        pot = self.logdet_cur()
        obj = float(jdot(self.b, y))
        return pot + rho * np.log(self.p_obj_internal - obj)

    def reduce_potential(self, dy) -> bool:
        """ref HDSDP_Reduce_Potential (:1389-1456)."""
        rho = (self.p_obj_val - self.d_obj_val) / self.mu
        min_step_tol = 0.5 if self.n_small_step >= 2 else 0.0
        required_dec = 0.05 if self.prox_norm < 0.5 else 0.0

        step = self.ratio_test(0.0, dy, 0.0, "dual")
        dual_step = min(step * 0.95, 1.0)

        pot_now = self.get_potential(rho, self.y)

        while True:
            cand = self._axpy(dual_step, dy)
            if not self.check_is_interior(1.0, cand):
                dual_step *= 0.33
                continue
            pot_new = self.get_potential(rho, cand)
            if (
                pot_new <= pot_now - required_dec
                or dual_step * self.prox_norm <= 0.001
                or dual_step < min_step_tol
            ):
                self.y = cand
                break
            if dual_step < 1e-04:
                if not self.check_is_interior(1.0, self.y):
                    return False
                break
            dual_step *= 0.3

        self.d_step = dual_step
        return True

    def get_barrier_fn(self, y) -> float:
        """ref HDSDP_GetBarrier (:1458-1479): -(b'y + mu*logdet)."""
        val = float(self.cones.logdet(self.L, self.s_lp))
        val += float(torch.sum(torch.log(self.sl)) + torch.sum(torch.log(self.su)))
        return -(float(jdot(self.b, y)) + self.mu * val)

    def feasible_corrector(self):
        """ref HDSDP_Feasible_Corrector (:1481-1614)."""
        p = self.params
        shrink = self.all_cone_dims / (self.all_cone_dims + np.sqrt(self.all_cone_dims))
        n_max_corr = p.corrector_b
        if n_max_corr == 0:
            return
        if self.prox_norm < 0.1 or self.d_step < 1e-02:
            n_max_corr = 0
        if self.d_step < 0.1 and self.mu < 1e-05:
            n_max_corr = 0
            p.corrector_b = 0
        if self.d_step < 1e-03:
            n_max_corr = 0
            p.corrector_b = 0
        if self.mu < 1e-06:
            n_max_corr = 0
            p.corrector_b = 0

        b_dot_d1 = float(jdot(self.b, self.d1))
        b_dot_corr = 0.0

        for _ in range(n_max_corr):
            if self.mu < 1e-05:
                break
            self.build_kkt("corr")
            d2 = self.solve_kkt(self.kkt.asinv)
            b_dot_d2 = float(jdot(self.b, d2))
            if b_dot_d2 > 0 and b_dot_d1 > 0:
                self.mu = b_dot_d1 / b_dot_d2
            self.mu *= shrink

            d1, d2 = jlift(self.d1, d2, by=(self.mu,))
            dy = d1 / self.mu - d2
            b_dot_corr += float(jdot(self.b, dy))  # accumulates across correctors
            # (faithful to ref :1520,1554-1557 where it is never reset)

            barrier_now = self.get_barrier_fn(self.y)
            step = self.ratio_test(0.0, dy, 0.0, "dual")
            step = min(step * 0.95, step)
            step = min(step, p.pot_rho / max(self.prox_norm, 1e-300))

            while True:
                cand = self._axpy(step, dy)
                if not self.check_is_interior(1.0, cand):
                    step *= 0.5
                    continue
                barrier_new = self.get_barrier_fn(cand)
                if step < 1e-04 or barrier_new <= barrier_now - abs(
                    0.05 * b_dot_corr * step
                ):
                    break
                denom = 2 * (barrier_new - barrier_now + b_dot_corr * step) / (step * step)
                if denom != 0 and 0 < b_dot_corr / denom < step:
                    step = b_dot_corr / denom
                else:
                    step *= 0.5

            if step < 1e-04:
                self.check_is_interior(1.0, self.y)
                break
            self.y = cand

    # ------------------------------------------------------------------
    # main entry (ref HDSDP_Conic_Solve, :1853-1870)
    # ------------------------------------------------------------------
    def solve(self, d_only: bool = False):
        fused = choose_fused_mode(self.m, self.f.n_max_cone_dim, self.f.n_sum_cone_dims,
                                  self.kkt_free, self.params, mesh=self.mesh is not None)
        self._factor_stats["fused"] = fused
        try:
            if fused:
                from hdsdp_tpu_torch.solver.fused import solve_fused

                refuse_f32_fused(self.params)
                return solve_fused(self, d_only, mode=fused)
            self.psdp = None
            self.phase_a(d_only)
            if self.status == SUSPECT_INFEAS_OR_UNBOUNDED:
                self.log.info("\nInfeasible method stops due to suspected infeasibility")
                self.hsd_solve(d_only)
            elif self.status == DUAL_FEASIBLE:
                self.log.info("\nInfeasible method finds a dual feasible solution")
                self.phase_b()
        except KeyboardInterrupt:
            # ref HUtilCheckCtrlC polling (hdsdp_utils.c:501-519)
            self.log.info("\nUser interrupt")
            self.status = USER_INTERRUPT
        return self.status


def load_state(ipm: DualIPM, d: dict, warm_start: bool = False) -> None:
    """Set the IPM iterate from a dict with the fields
    ``utils.checkpoint.save_checkpoint`` writes, in either package (y, tau,
    rd, mu, perturb, n_iter, status and both makers), e.g.
    ``load_checkpoint``'s result.  Both packages can then be driven from
    identical iterates.

    ``warm_start=True`` is what resuming a checkpoint does (the JAX
    package's ``apply_checkpoint``): y becomes the dual start ``y0`` of the
    next solve and only the makers are set besides, all in the IPM's dtype;
    the solve's own start sets the rest.  Otherwise each vector keeps its
    saved dtype where that is the wider (the y of a float32 solve that
    widened stays float64, as the solve left it)."""
    if int(d["m"]) != ipm.m:
        raise ValueError(f"state is for m={int(d['m'])}, problem has m={ipm.m}")
    if warm_start:
        ipm.y0 = ipm._vec(d["y"])
        _load_makers(ipm, d, ipm._vec)
        return

    def vec(x):
        t = torch.as_tensor(np.asarray(x), device=ipm.device)
        return t.to(jdtype(t, ipm._vec(())))

    ipm.y = vec(d["y"])
    ipm.tau = float(d["tau"])
    ipm.Rd = float(d["rd"])
    ipm.mu = float(d["mu"])
    ipm.perturb = float(d["perturb"])
    if "n_iter" in d:
        ipm.n_iter = int(d["n_iter"])
    if "status" in d:
        ipm.status = str(d["status"])
    _load_makers(ipm, d, vec)


def _load_makers(ipm: DualIPM, d: dict, vec) -> None:
    for name in ("acc", "inacc"):
        y = np.asarray(d[f"maker_{name}_y"])
        if y.size:
            setattr(ipm, f"maker_{name}", Maker(
                mu=float(d[f"maker_{name}_mu"]),
                y=vec(y),
                dy=vec(d[f"maker_{name}_dy"]),
            ))
