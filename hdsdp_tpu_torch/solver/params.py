"""Solver parameters, defaults and feature-driven auto-tuning.

Parity: defaults from HDSDPIGetDefaultParams (ref interface/hdsdp.c:397-424),
adjustment logic from HDSDPIAdjustParams (ref hdsdp.c:280-395) and
HDSDPIAdjustConeParams (ref hdsdp.c:136-278).
"""

from __future__ import annotations

from dataclasses import dataclass

from hdsdp_tpu_torch.models.problem import Features


@dataclass
class Params:
    # int params (ref hdsdp.h:70-78)
    max_iter: int = 500
    corrector_a: int = 12
    corrector_b: int = 12
    threads: int = 12
    psdp: int = 0
    pre_level: int = 2
    # double params (ref hdsdp.h:80-92)
    abs_opt_tol: float = 1e-08
    abs_feas_tol: float = 1e-08
    rel_opt_tol: float = 1e-08
    rel_feas_tol: float = 1e-08
    time_limit: float = 3600.0
    pot_rho: float = 4.0
    hsd_gamma: float = 0.5
    dual_box_up: float = 1e+07
    dual_box_low: float = -1e+07
    bar_mu_start: float = 1e+05
    p_obj_start: float = 1e+10
    dual_slack_start: float = 1e+05
    trx_estimate: float = 1e+08
    prec_ord_acc: float = 1e-08
    # extensions over the reference (same names and defaults as the JAX
    # package, so one override dict drives both)
    dtype: str = "float64"
    ratio_test: str = "auto"  # "exact" | "lanczos" | "auto"
    lanczos_dim: int = 30
    # fixed Lanczos depth of the fused bodies, warm-started from the last
    # call's Ritz image (the host loop's adaptive Lanczos runs at
    # lanczos_dim)
    lanczos_warm_dim: int = 16
    verbose: bool = True
    model_notes: str = ""
    # stage profiling of the host loop (accepted, not ported yet)
    profile: bool = False
    # IPM mode (solver.fused, algo.choose_fused_mode): "phase" runs each
    # phase to its end in one call, "iter" drives the same iteration body
    # with a wall-clock check, True means "phase", False the host loop;
    # "auto" takes "phase" for m <= fused_max_m and blocks <= fused_max_n,
    # "iter" while 128 (m^2 + n_max n_sum) bytes <= fused_hbm_budget, else
    # the host loop.  The budget is the JAX package's, sized for 16 GB of
    # TPU memory and kept because it decides which loop runs.
    fused: object = "auto"
    fused_max_m: int = 512
    fused_max_n: int = 256
    fused_hbm_budget: float = 12e9
    # Schur system backend: "direct" dense Cholesky; "cg" AdaptiveCG
    # (refinement against a stale mixed-precision factor, ops.cg), which
    # "auto" takes from kkt_cg_threshold rows on
    kkt_solver: str = "auto"
    kkt_cg_threshold: int = 4096
    # Matrix-free Schur operator (the sparse-Schur-storage analogue, ref
    # hdsdp_schur.c:60,227): "free" never materializes the m x m M; CG
    # solves apply M v = A(S^-1 (sum_j v_j A_j) S^-1) per bucket,
    # O(m + n^2) memory.  "auto" engages it from kkt_free_threshold rows
    # on; "dense" forces materialization.  kkt_free_maxiter is the step
    # budget of one CG run.
    kkt_mode: str = "auto"
    kkt_free_threshold: int = 20000
    kkt_free_maxiter: int = 600
    # stall escalation: when CG stalls through the whole ladder, M is
    # materialized once and factored directly, up to this row count; the
    # DIMACS check re-solves matrix-free above it in any mode
    op_materialize_cap: int = 32768
    # Cholesky preconditioner of the operator: M is materialized row chunk
    # by row chunk (op_precond_chunk rows) into an equilibrated f32
    # buffer, factored and inverted in f32, and kept (possibly stale) as
    # the CG preconditioner, up to op_precond_cap rows (0 disables it:
    # Jacobi only); refreshed when a converged solve needed more than
    # op_precond_refresh_iters steps (the ADPCG iteration-regret rule).
    # The three sizes are the JAX package's, chosen for a 16 GB device.
    op_precond_cap: int = 32768
    op_precond_chunk: int = 2048
    op_precond_refresh_iters: int = 80
    # double-single Cholesky (ops.ddchol, kernel K8 on the card) of M
    # (kkt_fp) and of single cone blocks with n >= 512 (cone_fp): "dd"
    # takes it; "auto", "xla" and "off" are the f64 factor on the port
    kkt_fp: str = "auto"
    cone_fp: str = "auto"
    # mixed-precision Schur solves of the fused bodies: "on" factors M in
    # f32 and refines in f64; "auto" and "off" are the f64 factor on the
    # port (unused by the host loop)
    kkt_mp: str = "auto"
    # Ozaki-sliced Schur ASSEMBLY (slot-major groups): FU = Fs@U and the
    # pair products Fs_j U Fs_k^T run through ops.hpmm (~2^-45 relative)
    # instead of f64 matmuls.  "on" forces it; "auto" and "off" keep f64
    # (the card has native f64, so no size gate engages it by itself).
    kkt_hp: str = "auto"

def adjust_params(params: Params, f: Features) -> Params:
    """Feature-driven auto-tuning (ref hdsdp.c:280-395, 136-278)."""

    # --- scaling decision (ref hdsdp.c:287-312); the scale factors are
    # recorded on the features and applied by the solver.
    obj_one = f.obj_one_norm
    rhs_inf = f.rhs_inf_norm
    obj_scal = 1.0
    if obj_one > 1e+10:
        obj_scal = 1e-08
    elif obj_one > 1e+08:
        obj_scal = 1e-06
    elif obj_one > 1e+05:
        obj_scal = 1e-05
    if rhs_inf > 1e+10:
        rhs_scal = 1e-08
    elif rhs_inf > 1e+08:
        rhs_scal = 1e-06
    else:
        rhs_scal = 1.0
    f.obj_scaling = obj_scal
    f.rhs_scaling = rhs_scal

    if params.pre_level < 1:
        return params

    # --- corrector counts (ref hdsdp.c:340-387)
    m = f.n_rows
    max_dim = max(f.n_max_cone_dim, 1)
    n_corr_a = (m - 2) // max_dim
    if f.n_sum_cone_dims < 100 and n_corr_a == 0:
        n_corr_a = 1
    if n_corr_a >= 1:
        n_corr_a += 1
    n_corr_a = n_corr_a * n_corr_a
    if m < 2000 and n_corr_a > 10:
        n_corr_a = 10
    n_corr_b = n_corr_a

    if f.n_max_cone_dim >= 5 * m:
        n_corr_b = 0
        n_corr_a = 2
    elif f.n_max_cone_dim >= m:
        n_corr_b = min(n_corr_b, 2)
        n_corr_a = 4
    else:
        n_corr_a = 6

    if m > 20 * f.n_max_cone_dim:
        n_corr_b = max(n_corr_b, 12)
        n_corr_a = 12
    elif m > 5 * f.n_max_cone_dim:
        n_corr_b = max(n_corr_b, 10)
        n_corr_a = 10
    elif m > 2 * f.n_max_cone_dim:
        n_corr_b = max(n_corr_b, 8)
        n_corr_a = 8

    params.corrector_b = min(n_corr_b, 12)
    params.corrector_a = max(n_corr_a, 2)

    if params.pre_level >= 2:
        _adjust_cone_params(params, f)

    return params


def _adjust_cone_params(params: Params, f: Features) -> None:
    """Structure-specific tuning (ref HDSDPIAdjustConeParams, hdsdp.c:136-278)."""

    notes = []
    n_sdp_cones = f.n_cones - (1 if f.n_lp_cols else 0)

    if f.many_cones:
        params.corrector_a = 6
        params.corrector_b = 0
        params.dual_slack_start = 1.0
        params.p_obj_start = 1e+10

    is_one_cone = n_sdp_cones <= 1

    if f.n_max_cone_dim < f.n_rows / 3 and is_one_cone:
        params.psdp = 1
    if f.n_lp_cols > 0:
        params.psdp = 0

    if f.very_dense:
        params.corrector_a = 4
        params.dual_slack_start = 1.0
        params.dual_box_up = 1e+04
        params.dual_box_low = -1e+04
        notes.append("dense")

    if f.implied_trace:
        params.dual_slack_start = 1e+03
        params.trx_estimate = f.implied_trace_x
        params.p_obj_start = 1e+08
        params.pot_rho = 5.0
        params.dual_box_up = 1e+06
        params.dual_box_low = -1e+06
        notes.append("trace-implied")

    if f.no_primal_interior:
        params.dual_box_up = 1e+04
        params.dual_box_low = -1e+04
        params.dual_slack_start = 1e+03
        params.prec_ord_acc = 1e-07
        notes.append("no-primal interior")

    if f.imp_y_bound:
        if f.imp_y_up:
            params.dual_box_up = min(params.dual_box_up, f.imp_y_up)
        if f.imp_y_low:
            params.dual_box_low = max(params.dual_box_low, f.imp_y_low)
        if f.imp_y_up and f.imp_y_low:
            params.dual_slack_start = 1e+02
            params.p_obj_start = 1e+05
        else:
            params.dual_slack_start = 1e+05
            params.p_obj_start = 1e+10
            params.corrector_a = 12
            params.corrector_b = 12
        params.abs_opt_tol = 1e-01
        params.rel_opt_tol = 1e-04
        params.prec_ord_acc = 1e-05
        notes.append("dual-bounded")

    if f.no_dual_interior:
        params.dual_box_up = 1.0
        params.dual_box_low = -1.0
        total_dims = f.n_sum_cone_dims + 2 * f.n_rows
        if total_dims > 100000:
            params.dual_slack_start = 1e+00
            params.abs_feas_tol = 1e-04
            params.rel_feas_tol = 1e-05
        else:
            params.dual_box_up = 1e+01
            params.dual_box_low = -1e+01
            params.abs_feas_tol = 1e-05
            params.rel_feas_tol = 1e-07
        params.prec_ord_acc = 1e-05
        notes.append("no-dual interior")

    if f.null_obj:
        params.dual_slack_start = 1.0
        params.dual_box_up = 1.0
        params.dual_box_low = -1.0
        notes.append("no objective")

    if notes:
        params.model_notes = "This is a " + " ".join(notes) + " SDP problem"
