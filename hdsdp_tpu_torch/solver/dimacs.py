"""Primal recovery + DIMACS error check (ref HDSDPCheckSolution,
interface/hdsdp.c:771-933, and sdpDenseConeGetPrimal,
hdsdp_conic_sdp.c:2395-2446).

The primal matrix per cone is recovered from a recorded "maker"
(mu*, y*) as

    X = mu* ( Sbar^-1 + Sbar^-1 W Sbar^-1 ),   Sbar = C - A'y*,  W = A'(dy)

with ``dy`` RE-SOLVED at check time against M and ASinv built from the
SAME U = Sbar^-1 used for the recovery congruence (as in the JAX
package), so the triple (mu*, U, dy) is self-consistent:

    (M(U) + D_bound) dy = b/mu* - (ASinv(U) + u^-1 - l^-1).

In operator mode (``ipm.kkt_free``, M never materialized), on a mesh,
and above ``op_materialize_cap`` rows in any mode, the re-solve runs CG
on the matrix-free operator at the maker point (sharded over the mesh): against a fresh row-chunked f32
Cholesky preconditioner where the layout allows one, else restarted
Jacobi-PCG runs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from hdsdp_tpu_torch.ops import chol as chol_ops
from hdsdp_tpu_torch.ops import schur as schur_ops
from hdsdp_tpu_torch.solver import cones as cone_ops
from hdsdp_tpu_torch.utils import profile
from hdsdp_tpu_torch.utils.device import jdot, jlift

# above this block dimension the min-eigenvalue check switches from exact
# f64 eigh to f32 eigh + f64 Rayleigh refinement
_EXACT_EIG_DIM = 384

# above this block dimension no dense eigh runs: a Lanczos estimate plus
# the try-Cholesky certificate of _certified_block_min_eval
_LANCZOS_EIG_DIM = 8192


def _lanczos_min_one(X: torch.Tensor, krylov: int = 64, restarts: int = 3) -> torch.Tensor:
    """lambda_min estimate of one symmetric [n, n] block: restarted
    Lanczos on -X with full reorthogonalization + one f64 Rayleigh
    quotient.  An unconverged sweep can only make X look MORE PSD, so
    the caller certifies large blocks by Cholesky as well.  The start
    vector comes from a fixed numpy seed (the JAX package draws it from
    jax.random; only the estimate's refinement depends on it)."""
    n = X.shape[-1]

    def sweep(v):
        V = torch.zeros((krylov + 1, n), dtype=X.dtype, device=X.device)
        V[0] = v
        alpha = torch.zeros(krylov, dtype=X.dtype, device=X.device)
        beta = torch.zeros(krylov, dtype=X.dtype, device=X.device)
        for i in range(krylov):
            vi = V[i]
            w = -(X @ vi)
            a = vi @ w
            w = w - a * vi
            w = w - V.T @ (V @ w)  # rows > i are still 0
            b = torch.linalg.vector_norm(w)
            V[i + 1] = torch.where(b > 1e-300, w / b, 0.0)
            alpha[i] = a
            beta[i] = b
        T = torch.diag(alpha) + torch.diag(beta[:-1], 1) + torch.diag(beta[:-1], -1)
        profile.count("host_reads")
        _, evecs = torch.linalg.eigh(T)
        u = V[:krylov].T @ evecs[:, -1]  # Ritz vector of lambda_max(-X)
        return u / torch.linalg.vector_norm(u)

    v = torch.as_tensor(np.random.default_rng(7).standard_normal(n), dtype=X.dtype,
                        device=X.device)
    u = v / torch.linalg.vector_norm(v)
    for _ in range(restarts):
        u = sweep(u)
    return u @ (X @ u)


def _try_chol_ok(A: torch.Tensor) -> bool:
    """The reference's PSD predicate: a Cholesky succeeds (ref
    HFpLinsysPsdCheck, hdsdp_linsolver.c:1112-1144)."""
    ok, _ = chol_ops.psd_check(A)
    profile.count("host_reads")
    return bool(ok)


def _certified_block_min_eval(X: torch.Tensor, est: float) -> float:
    """CERTIFIED lambda_min lower bound for one huge [n, n] block: walks
    a shift ladder 0 < delta_1 < ... and returns -(delta* + eps) for the
    first delta* whose Cholesky of X + delta* I succeeds.  ``est`` only
    tightens the report when even the widest shift fails."""
    n = X.shape[0]
    profile.count("host_reads")
    scale = float(torch.max(torch.abs(torch.diagonal(X)))) + 1e-300
    u = 2.0 ** -45  # the JAX package's DD unit; dominates the f64 case too
    eps = 4.0 * n * u * scale
    deltas = [0.0] + [scale * 10.0 ** e for e in range(-14, -1)]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    for d in deltas:
        if _try_chol_ok(X if d == 0.0 else X + d * eye):
            return -(d + eps)
    return min(est, -deltas[-1])


def _batch_min_eval(Xg: torch.Tensor) -> torch.Tensor:
    """Min eigenvalue over a [g, n, n] symmetric block batch.

    Small blocks: exact eigvalsh.  Larger f64 blocks: the minimizing
    eigenvector from an f32 eigh, the eigenvalue from one f64 Rayleigh
    quotient (error O(||X|| sin^2 theta), far below the 1e-2 DIMACS gate,
    ref hdsdp.c:905-921).  Huge blocks: the Lanczos estimate."""
    n = Xg.shape[-1]
    if n >= _LANCZOS_EIG_DIM and Xg.dtype == torch.float64:
        return torch.min(torch.stack([_lanczos_min_one(x) for x in Xg]))
    # the eigensolvers see (X + X^T)/2, as jnp.linalg.eigvalsh and eigh do
    # by default: a PSDP-refined X carries a rounding asymmetry of the
    # size of its smallest eigenvalues, and LAPACK reads one triangle
    Xs = 0.5 * (Xg + Xg.mT)
    if n < _EXACT_EIG_DIM or Xg.dtype != torch.float64:
        profile.count("host_reads")
        return torch.min(torch.linalg.eigvalsh(Xs))
    profile.count("host_reads")
    _, V = torch.linalg.eigh(Xs.to(torch.float32))
    v = V[..., :, 0].to(Xg.dtype)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.min(torch.einsum("...i,...ij,...j->...", v, Xg, v))


# ----------------------------------------------------------------------
# check-time KKT at the maker point (consistency re-solve)
# ----------------------------------------------------------------------


def _maker_kkt(cones, b, mk_mu, mk_y, perturb, lo, up, m: int, hp: bool,
               with_m: bool = True):
    """Factor Sbar at the maker point (with a diagonal shift ladder for
    the last accurate maker, which sits closest to the cone boundary),
    compute U = Sbar^-1, and build (M + bound diag, rhs) from the SAME U.
    Returns (ok, Us, sbar_lp, M, d_bound, rhs); M is None without
    ``with_m`` (the matrix-free re-solve)."""
    groups, lp = cones.groups, cones.lp
    Sbar, sbar_lp = cone_ops.assemble(groups, lp, 1.0, -1.0, mk_y, perturb)
    ok, Lbar = cone_ops.factor(Sbar, sbar_lp)

    profile.count("host_reads", len(Sbar))
    scale = max(
        float(torch.max(torch.abs(torch.diagonal(Sg, dim1=-2, dim2=-1))))
        for Sg in Sbar
    ) if Sbar else 0.0
    k = 0
    while True:  # the five rungs of the JAX ladder
        profile.count("host_reads")
        if bool(ok) or k >= 5:
            break
        delta = scale * 1e-14 * (10.0 ** (2 * k))
        S_shift = tuple(
            Sg + delta * torch.eye(Sg.shape[-1], dtype=Sg.dtype, device=Sg.device)
            for Sg in Sbar
        )
        ok_s, L_s = cone_ops.factor(S_shift, sbar_lp)
        profile.count("host_reads")
        if bool(ok_s):
            Lbar = L_s
        ok = ok_s
        k += 1
    Us = cone_ops.inverses(Lbar, hp=hp)

    M = torch.zeros((m, m), dtype=b.dtype, device=b.device) if with_m else None
    asinv = torch.zeros((m,), dtype=b.dtype, device=b.device)
    for ga, U in zip(groups, Us):
        out = schur_ops.group_schur(ga, U, m, with_m=with_m, hp=hp)
        if with_m:
            M = M + out.M
        asinv = asinv + out.asinv
    if lp is not None:
        out = schur_ops.lp_schur(lp, sbar_lp, m, with_m=with_m)
        if with_m:
            M = M + out.M
        asinv = asinv + out.asinv

    # bound cone at the maker point, tau = 1 (ref sBoundConeGetKKT)
    li = 1.0 / (mk_y - lo)
    ui = 1.0 / (up - mk_y)
    d_bound = li * li + ui * ui
    if with_m:
        M = M + torch.diag(d_bound)
    rhs = b / mk_mu - (asinv + ui - li)
    profile.count("host_reads")
    return bool(ok), Us, sbar_lp, M, d_bound, rhs


def _chol_solve_ladder(M: torch.Tensor, rhs: torch.Tensor):
    """f64 Cholesky solve with a regularization ladder and one
    residual-correction sweep (the check-time system is factored once).
    Returns (ok, x)."""
    ok, L = chol_ops.psd_check(M)
    profile.count("host_reads")
    if not bool(ok):
        profile.count("host_reads")
        base = float(torch.max(torch.diagonal(M))) * 1e-14 + 1e-300
        eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
        for k in range(6):
            ok, L = chol_ops.psd_check(M + base * (10.0 ** (2 * k)) * eye)
            profile.count("host_reads")
            if bool(ok):
                break
    profile.count("host_reads")
    if not bool(ok):
        return False, None
    x = chol_ops.chol_solve(L, rhs)
    x = x + chol_ops.chol_solve(L, rhs - M @ x)  # one refinement sweep
    return True, x


def _restarted_pcg(solve, matvec, rhs, runs: int = 8):
    """X with M X ~ rhs from up to ``runs`` CG runs, each restarted on the
    residual of the iterate so far (a restart drops the search directions,
    so eight runs are not one run of eight times the budget); stops when
    the residual is below 1e-10 max(|rhs|, 1)."""
    B = rhs[:, None]
    X = torch.zeros_like(B)
    R = B
    profile.count("host_reads")
    goal = 1e-10 * max(float(torch.linalg.vector_norm(rhs)), 1.0)
    for _ in range(runs):
        X = X + solve(R)
        R = B - matvec(X)
        profile.count("host_reads")
        if float(torch.max(torch.linalg.vector_norm(R, dim=0))) <= goal:
            break
    return X[:, 0]


def _solve_maker_dy(ipm, Us, sbar_lp, M, d_bound, rhs):
    """dy from the check-time KKT: dense Cholesky when M exists, else CG
    on the matrix-free operator, with a fresh chunk-materialized f32
    Cholesky preconditioner at the MAKER point when the layout supports it
    (the Jacobi-only re-solve stalls at endgame conditioning and leaves
    err1/err5 at ~1e-6; the chol-PCG reaches the direct path's grade).
    The operator here is the cone system's whole one, on every rank of a
    mesh alike (the JAX package's check calls its module-level
    ``_kkt_pcg``, not the sharded matvec): no collective per CG step."""
    if M is not None:
        ok, dy = _chol_solve_ladder(M, rhs)
        return dy if ok else None
    cones = ipm.cones
    p = ipm.params
    diag = cones.kkt_diag(Us, sbar_lp) + d_bound
    # the check is one-time: a sane budget per run even when the solve
    # ran with a starved kkt_free_maxiter
    budget = max(p.kkt_free_maxiter, 600)

    def matvec(X):
        return cone_ops.kkt_matvec(cones.groups, cones.lp, Us, sbar_lp, d_bound, X, ipm.m)

    pc = None
    if (p.op_precond_cap > 0 and ipm.m <= p.op_precond_cap and ipm.mesh is None
            and cones.kkt_rows_supported()):
        try:
            pc = ipm._build_chunked_precond(Us, sbar_lp, d_bound, diag)
        except torch.cuda.OutOfMemoryError as e:
            ipm.log.info(f"check-time preconditioner out of device memory ({e}); "
                         "re-solving with Jacobi-PCG")
    if pc is not None:
        Linv, s = pc
        return _restarted_pcg(
            lambda R: cones.kkt_pcg_chol(Us, sbar_lp, d_bound, Linv, s, R,
                                         1e-10, 1e-10, budget)[0],
            matvec, rhs)
    pinv = 1.0 / torch.clamp(diag, min=1e-300)
    return _restarted_pcg(
        lambda R: cone_ops.kkt_pcg(cones.groups, cones.lp, Us, sbar_lp, d_bound, pinv, R,
                                   ipm.m, 1e-10, 1e-10, budget)[0],
        matvec, rhs)


def _consistent_maker_solve(ipm, maker):
    """(Us, sbar_lp, dy) for the maker, or None if Sbar is not PD."""
    # Never materialize and factor the full m x m M at check time in
    # operator mode, on a row-sharded mesh (whose design keeps M
    # distributed) or above the operator's materialization cap: the
    # consistency dy then comes from CG on the matrix-free operator.
    with_m = (not ipm.kkt_free and ipm.m <= ipm.params.op_materialize_cap
              and not getattr(ipm.cones, "is_row_sharded", False))
    # the maker point in the IPM's dtype, as the JAX package casts it: a
    # float32 solve checks in float32 (its y went float64 in phase B)
    ok, Us, sbar_lp, M, d_bound, rhs = _maker_kkt(
        ipm.cones, ipm.b, maker.mu, maker.y.to(ipm.dtype), ipm.perturb,
        ipm.bound_lo, ipm.bound_up, ipm.m, bool(ipm.cones.kkt_hp), with_m,
    )
    if not ok:
        return None
    dy = _solve_maker_dy(ipm, Us, sbar_lp, M, d_bound, rhs)
    del M, rhs  # free the m x m system before the recovery congruences
    if dy is None:
        return None
    return Us, sbar_lp, dy


def _recover(cones, Us, sbar_lp, mk_mu, dy, hp: bool):
    """X = mu (U + U W U) per group, W = A'dy (and the LP primal), in the
    dtype the JAX package's promotion gives it (``mk_mu`` a host scalar
    or a 0-dim tensor of the check's dtype)."""
    groups, lp = cones.data_for(dy)
    W, w_lp = cone_ops.assemble(groups, lp, 0.0, 1.0, dy, 0.0, hp=hp)
    X_list = []
    for U, Wg in zip(Us, W):
        U, Wg = jlift(U, Wg)
        X = jlift(U + U @ Wg @ U, by=(mk_mu,))[0] * mk_mu
        X_list.append(0.5 * (X + X.mT))
    x_lp = None
    if cones.has_lp:
        x_lp = jlift(sbar_lp + w_lp, by=(mk_mu,))[0] * mk_mu / (sbar_lp * sbar_lp)
    return X_list, x_lp


def recover_primal(ipm, maker) -> Optional[Tuple[List[torch.Tensor], Optional[torch.Tensor]]]:
    """X per SDP group + LP primal vector for a given maker; None if the
    maker's dual check matrix is not PD (recovery step infeasible)."""
    out = _consistent_maker_solve(ipm, maker)
    if out is None:
        return None
    Us, sbar_lp, dy = out
    return _recover(ipm.cones, Us, sbar_lp, maker.mu, dy, ipm.cones.dual_hp)


def check_solution(ipm) -> np.ndarray:
    """Compute the 6 DIMACS errors and set the final status, including
    the acc -> inacc maker retry (ref hdsdp.c:905-918)."""
    with profile.span("dimacs"):
        return _check_solution(ipm)


def _check_solution(ipm) -> np.ndarray:
    from hdsdp_tpu_torch.solver import algo

    errs = np.ones(6)
    if ipm.maker_acc.mu <= 0.0 and ipm.maker_inacc.mu <= 0.0:
        ipm.status = algo.NUMERICAL
        return errs

    ipm.release_solve_buffers()
    use_acc = ipm.maker_acc.mu > 0.0

    while True:
        maker = ipm.maker_acc if use_acc else ipm.maker_inacc
        errs = _dimacs_errors(ipm, maker)
        if errs is None:
            errs = np.ones(6)
        if float(np.max(np.abs(errs))) > 1e-02:
            if use_acc:
                # primal solution not good: switch maker (ref hdsdp.c:909-918)
                ipm.log.info("\nDealing with primal solution")
                use_acc = False
                if ipm.maker_inacc.mu > 0.0:
                    continue
            ipm.status = algo.NUMERICAL
        else:
            ipm.status = algo.PRIMAL_DUAL_OPTIMAL
        return errs


def _errors_from_parts(ipm, p_obj, d_obj, compl, min_eval, p_inf_norm):
    f = ipm.f
    pd_scal = ipm.rhs_scal * ipm.obj_scal
    d_obj = d_obj / pd_scal
    p_obj = p_obj / pd_scal
    p_infeas = p_inf_norm / ipm.rhs_scal
    d_infeas = ipm.perturb * np.sqrt(max(f.n_sum_cone_dims, 1)) / ipm.obj_scal

    errs = np.zeros(6)
    errs[0] = p_infeas / (1.0 + f.rhs_one_norm)
    errs[1] = -min_eval / (1.0 + f.rhs_one_norm) if min_eval < 0.0 else 0.0
    errs[2] = d_infeas / (1.0 + f.obj_one_norm)
    errs[3] = 0.0
    errs[4] = (p_obj - d_obj) / (abs(p_obj) + abs(d_obj) + 1.0)
    errs[5] = compl / (abs(p_obj) + abs(d_obj) + 1.0)

    ipm.p_obj_val = p_obj
    ipm.d_obj_val = d_obj
    return errs


def _min_eval(X_list, x_lp) -> float:
    """Smallest eigenvalue over the primal blocks and the LP primal."""
    min_eval = np.inf
    for Xg in X_list:
        profile.count("host_reads")
        me = float(_batch_min_eval(Xg))
        if Xg.shape[-1] >= _LANCZOS_EIG_DIM and Xg.dtype == torch.float64:
            # the estimate can only under-report a violation: the
            # try-Cholesky certificate decides
            for i in range(Xg.shape[0]):
                min_eval = min(min_eval, _certified_block_min_eval(Xg[i], est=me))
        else:
            min_eval = min(min_eval, me)
    if x_lp is not None:
        profile.count("host_reads")
        min_eval = min(min_eval, float(torch.min(x_lp)))
    return min_eval


def _dimacs_errors(ipm, maker) -> Optional[np.ndarray]:
    cones = ipm.cones
    if ipm.psdp is not None:  # set only by a refinement that returned its X
        # PSDP-refined primal: the errors of the explicit X
        X_list, x_lp = ipm.psdp.get_primal()
        y = ipm.y
    else:
        out = _consistent_maker_solve(ipm, maker)
        if out is None:
            return None
        Us, sbar_lp, dy = out
        # the check assembles without the Ozaki products, as the JAX
        # package's does; it takes mu and y in the IPM's dtype (a float32
        # solve's check is float32 through)
        mk_mu = torch.tensor(maker.mu, dtype=ipm.dtype, device=ipm.device)
        X_list, x_lp = _recover(cones, Us, sbar_lp, mk_mu, dy, hp=False)
        y = ipm.y.to(ipm.dtype)
    groups, lp = cones.data_for(y, ipm.Rd, ipm.perturb)
    y, = jlift(y, by=(ipm.Rd, ipm.perturb))
    S, s_lp = cone_ops.assemble(groups, lp, 1.0, -1.0, y, -ipm.Rd + ipm.perturb)
    profile.count("host_reads")
    d_obj = float(jdot(ipm.b, y))
    ax = cones.atx(X_list, x_lp)
    profile.count("host_reads")
    p_obj = float(cones.ctx(X_list, x_lp))
    compl = 0.0
    for Xg, Sg in zip(X_list, S):
        profile.count("host_reads")
        compl += float(torch.sum(Xg * Sg))
    if x_lp is not None:
        profile.count("host_reads")
        compl += float(jdot(x_lp, s_lp))
    profile.count("host_reads")
    p_inf_norm = float(torch.linalg.vector_norm(ax - ipm.b))
    return _errors_from_parts(ipm, p_obj, d_obj, compl, _min_eval(X_list, x_lp), p_inf_norm)
