"""Fused IPM phases: device-resident iteration bodies.

Port of the JAX package's solver/fused.py, where each phase (A, B and the
self-dual A') compiles to one XLA program: the IPM state lives on the
device, the data-dependent loops are ``lax.while_loop``s and the fallback
ladders ``lax.cond``s, and the host sees nothing but a status per phase
("phase") or per iteration ("iter").  Here the same state stays on the
device as tensors (``State``), ``jnp.where`` is ``torch.where`` and a row of
the per-iteration log is written in place into a device buffer.  The host
reads the device only where the JAX program makes a decision that changes
what runs next; ``Cones.n_reads`` counts those reads.

Decision points (JAX site in hdsdp_tpu/solver/fused.py: how it is read):

  each iteration       ``_drive`` reads (status, n_iter) once after every
                       body ("phase" tests before each trip as
                       the in-graph while_loop does, "iter" after each trip
                       plus the wall-clock limit, :1804-1823)
  :267                 the f64 Schur factor's ok; the 6-step ladder reads
                       each rung until one factors (the later rungs of the
                       JAX fori_loop cannot change the result)
  :303, :339           kkt_mp="on": the f32 factor's ok, once per factor;
                       ops.cg.refine_solve reads its norms once per sweep
  :437                 prox_measure's expert check, once
  :576                 phase A line search, once per trip
  :692, :743           the corrector's feasibility loop once per trip, its
                       residual loop once per trip after the first (known)
  :709, :771           the corrector's worse-barrier and too-small conds
  :776, :790           the corrector's round gate and its interior check
  :812, :821           phase A's reset and run conds, one read of both
  :919, :937           choose_barrier: found/not-found, and the not-found
                       trial-step loop once per trip
  :961                 the mu-shrink loop of feasible_build_step, per trip
                       after the first
  :993                 the dual-ray trigger of primal_infeas_check
  :1054-1061           reduce_potential: one read per trip of (tiny-step
                       check needed, step accepted); the interior/accept
                       conds whose branches are elementwise are torch.where
  :1157-1191           feasible_corrector: its n_eff_zero gate, the
                       barrier line search per trip after the first, and one
                       read per round of (tiny step, next round's mu gate)
  :1248                continue_iter, once
  :1490, :1497         HSD: the interior check; the reset/numerical branch
                       (both elementwise) is a torch.where

Syncs that are not decisions, not counted in ``n_reads``: on CUDA
``torch.linalg.eigh``/``eigvalsh`` wait for the device to check ``info``:
the 16-step Lanczos' k x k tridiagonal (one per group per ratio test from
n = 192) and the exact ratio test below n = 192 (control11).  Every
Cholesky here is ``cholesky_ex`` (no sync); nothing indexes by a mask.
While a ``utils.profile.recording()`` is open, the counter ``host_reads``
counts every read, these included, at the line that reads; ``ratio_tests``
counts ``cone_ratio`` calls; and the layers are spans (``iter`` per body
call, ``phase`` per phase launch, ``ratio_test``, ``build_kkt``,
``factor_m``, ``solve_m``, ``check_interior``, ``ipm_setup``).

Every phase launch starts from and ends in the ``DualIPM`` (prologues,
PSDP and the final DIMACS check are its host code), as in the JAX package.

The same bodies run a FLEET of same-shape solves (solver.batch, where the
JAX package vmaps its raw phase programs): every tensor then carries a
leading instance axis, each decision above reads one flag per instance in
the same single host read, and ``_cond``/``_while``/``_repeat`` do what
vmap does to lax.cond and lax.while_loop (a split runs both branches and
merges per instance; a loop freezes the instances that are done).  A
single solve's decisions are unanimous, so it runs the same operations as
it always has.

What the JAX module needs for XLA and the port does not: the program
builders ``make_phase_a``/``make_phase_b``/``make_hsd`` with their cache
and keys (here both modes drive the same body with ``_drive``), buffer
donation, ``raw`` for vmap.  The trace-time dicts ``_RATIO_CFG``,
``_KKT_CFG`` and ``_CONE_CFG`` are one ``Config`` on ``Cones``; with
``cone_dd`` (``_CONE_CFG["dd"]``, Params.cone_fp) the cone factor of
every interior check is the double-single Cholesky (ops.ddchol, kernel
K8).
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from hdsdp_tpu_torch.ops import cg as cg_ops
from hdsdp_tpu_torch.ops import chol as chol_ops
from hdsdp_tpu_torch.ops import ratio as ratio_ops
from hdsdp_tpu_torch.ops import schur as schur_ops
from hdsdp_tpu_torch.solver import cones as cone_ops
from hdsdp_tpu_torch.utils import profile

INF = 1e30

# integer status codes (the host maps them to the string statuses of algo)
RUNNING = 0
DUAL_FEASIBLE = 1
SUSPECT = 2
MAXITER = 3
NUMERICAL = 4
OPTIMAL = 5
INFEAS = 6
PSDP_HANDOFF = 7
DUAL_OPTIMAL = 8
TIMELIMIT = -2


class _Tree:
    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class Maker(_Tree):
    mu: torch.Tensor
    y: torch.Tensor
    dy: torch.Tensor


@dataclass
class Config:
    """What the JAX module fixes at trace time: the ratio test's mode and
    depths, the mixed-precision Schur backend, the Ozaki assemblies and
    the double-single cone factor."""

    ratio_mode: str = "auto"
    krylov: int = 30
    kwarm: int = 16
    mp: bool = False
    hp: bool = False
    dhp: bool = False
    cone_dd: bool = False


@dataclass
class Cones(_Tree):
    """Cone data of one solve, its Config, and the count of host reads.

    A FLEET (solver.batch) is N same-shape solves at once: every tensor of
    Cones, Pars and State then carries a leading axis of N instances (the
    groups' index fields and summation tables too, ops.schur), ``fleet``
    is N, and ``live`` is the host mask of the instances whose results the
    current region keeps (see ``_cond``)."""

    groups: tuple
    lp: Optional[object]
    b: torch.Tensor
    bound_lo: torch.Tensor
    bound_up: torch.Tensor
    cfg: Config
    n_reads: int = 0
    fleet: int = 0
    # kkt_mp: Schur factors, and those that took the f64 ladder (per
    # instance of a fleet: numpy int arrays)
    mp_factors: object = 0
    mp_f64: object = 0
    # KKT builds by kind (build_kkt calls): the fleet's accounting
    n_builds: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        lead = (self.fleet,) if self.fleet else ()
        self.yes = torch.ones(lead, dtype=torch.bool, device=self.b.device)
        self.no = torch.zeros(lead, dtype=torch.bool, device=self.b.device)
        self.live = np.ones(self.fleet, dtype=bool) if self.fleet else True


@dataclass
class Pars(_Tree):
    """Runtime scalars derived from Params + features (device-resident)."""

    feas_tol: torch.Tensor
    trx_estimate: torch.Tensor
    all_cone_dims: torch.Tensor
    pot_rho: torch.Tensor
    rel_opt_tol: torch.Tensor
    abs_opt_tol_scaled: torch.Tensor  # abs_opt_tol / (obj_scal*rhs_scal)
    pd_scal: torch.Tensor  # 1 / (rhs_scal * obj_scal)
    rhs_fro_norm: torch.Tensor
    rhs_one_norm: torch.Tensor


@dataclass
class State(_Tree):
    y: torch.Tensor
    Rd: torch.Tensor
    mu: torch.Tensor
    perturb: torch.Tensor
    tau: torch.Tensor  # HSD homogenizing variable (1.0 in phases A/B)
    obj_improve: torch.Tensor  # HSD dual-objective improvement tracker
    S: Tuple[torch.Tensor, ...]
    s_lp: Optional[torch.Tensor]
    L: Tuple[torch.Tensor, ...]
    sl: torch.Tensor
    su: torch.Tensor
    # checker buffers
    Schk: Tuple[torch.Tensor, ...]
    s_lp_chk: Optional[torch.Tensor]
    Lchk: Tuple[torch.Tensor, ...]
    sl_chk: torch.Tensor
    su_chk: torch.Tensor
    # scalars
    prox_norm: torch.Tensor
    p_obj_internal: torch.Tensor
    d_obj_internal: torch.Tensor
    p_infeas: torch.Tensor
    d_step: torch.Tensor
    n_small_step: torch.Tensor  # int32
    n_iter: torch.Tensor  # int32
    status: torch.Tensor  # int32
    p_obj_found: torch.Tensor  # int32
    maker_acc: Maker
    maker_inacc: Maker
    # per-iteration log rows [max_iter, 6]:
    # (pObj, dObj, inf, mu, step, extra) in internal units
    log: torch.Tensor
    # per-group Lanczos warm-start vectors (f32, shape = batch + (n,)),
    # threaded through every cone_ratio call like the reference's
    # persistent vVec (ref hdsdp_lanczos.c:166-178, 249)
    lz: Tuple[torch.Tensor, ...]


def _read(c: Cones, flag: torch.Tensor):
    """One host read of a device flag (a decision point): a bool, or for a
    fleet the flag of every instance (a numpy bool array), in one copy."""
    c.n_reads += 1
    profile.count("host_reads")
    if c.fleet:
        return flag.cpu().numpy().astype(bool)
    return bool(flag)


def _read_all(c: Cones, *xs):
    """Several device flags or scalars in one host read (for a fleet, one
    numpy row of N values each)."""
    c.n_reads += 1
    profile.count("host_reads")
    vals = torch.stack([x.to(torch.float64) for x in xs])
    return list(vals.cpu().numpy()) if c.fleet else vals.tolist()


def _h(v):
    """A value of ``_read_all`` as a decision: a bool (a bool array)."""
    return v != 0


def _i32(flag: torch.Tensor) -> torch.Tensor:
    return flag.to(torch.int32)


def _f64(flag: torch.Tensor) -> torch.Tensor:
    return flag.to(torch.float64)


# ----------------------------------------------------------------------
# masked control flow: what ``jax.vmap`` makes of the JAX program's
# lax.cond and lax.while_loop.  A decision reads one flag per instance
# (one host read for the whole fleet).  Where every live instance agrees,
# only their branch runs, as in a single solve; where they disagree, both
# branches run, each with the other instances masked out of its own
# decisions, and the results are merged per instance with torch.where.
# A loop steps while any live instance continues and freezes the others.
# With one solve (no fleet) every decision is unanimous: the same torch
# operations run as before, in the same order.
# ----------------------------------------------------------------------


def _any(c: Cones, h) -> bool:
    """Does some live instance take the decision h?"""
    return bool(np.any(np.logical_and(h, c.live)))


def _all(c: Cones, h) -> bool:
    """Does every live instance take the decision h?"""
    return bool(np.all(np.logical_or(h, np.logical_not(c.live))))


@contextmanager
def _narrow(c: Cones, h):
    """Within the block, only the live instances that take h are live."""
    saved = c.live
    c.live = np.logical_and(saved, h)
    try:
        yield
    finally:
        c.live = saved


def _where(flag, a, b):
    """torch.where with a per-instance flag ([N]) broadcast over the
    trailing axes of the operands; a single solve's 0-d flag as it is."""
    if isinstance(flag, torch.Tensor) and flag.ndim:
        nd = max(x.ndim if isinstance(x, torch.Tensor) else 0 for x in (a, b))
        flag = flag.reshape(flag.shape + (1,) * (nd - flag.ndim))
    return torch.where(flag, a, b)


def _tree_where(mask: torch.Tensor, new, old):
    if new is old:
        return new
    if isinstance(new, torch.Tensor) or isinstance(old, torch.Tensor):
        return _where(mask, new, old)
    if isinstance(new, tuple):
        return tuple(_tree_where(mask, a, b) for a, b in zip(new, old))
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: _tree_where(mask, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new)})
    if new == old:
        return new
    raise TypeError(f"cannot merge {new!r} and {old!r} per instance")


def _select(c: Cones, h, new, old):
    """Per instance, the tree ``new`` where h holds and ``old`` elsewhere
    (the select vmap makes of a batched cond or while_loop); no device
    work where every live instance agrees."""
    if _all(c, h):
        return new
    if not _any(c, h):
        return old
    return _tree_where(torch.as_tensor(h, device=c.b.device), new, old)


def _cond(c: Cones, h, true_fn, false_fn):
    """lax.cond on the decision h (already read)."""
    if _all(c, h):
        return true_fn()
    if not _any(c, h):
        return false_fn()
    with _narrow(c, h):
        a = true_fn()
    with _narrow(c, np.logical_not(h)):
        b = false_fn()
    return _select(c, h, a, b)


def _while(c: Cones, cond_fn, body_fn, carry):
    """lax.while_loop: one read of cond_fn(carry) before every trip."""
    while True:
        h = _read(c, cond_fn(carry))
        if not _any(c, h):
            return carry
        with _narrow(c, h):
            new = body_fn(carry)
        carry = _select(c, h, new, carry)


def _repeat(c: Cones, trip, carry, n_max: int):
    """A do-while of at most n_max trips: trip(carry) -> (carry, done flag).
    Every live instance takes the first trip, those not done the next;
    one read of the flag after every trip but the last."""
    carry, done = trip(carry)
    todo = True
    for _ in range(1, n_max):
        todo = np.logical_and(todo, np.logical_not(_read(c, done)))
        if not _any(c, todo):
            break
        with _narrow(c, todo):
            new, done = trip(carry)
        carry = _select(c, todo, new, carry)
    return carry


# per-instance reductions and broadcasts (one solve: the plain reduction)


def _lead(c: Cones) -> tuple:
    return (c.fleet,) if c.fleet else ()


def _v(x):
    """A per-instance scalar against vectors (ops.schur.bcast)."""
    return schur_ops.bcast(x, 1)


def _dot(c: Cones, a, b):
    """a . b.  A fleet takes each instance's dot alone: the BLAS dot of a
    single solve has no batched form that rounds as it does, and a fleet
    member must repeat its solo solve's bits (N launches, not one)."""
    if not c.fleet:
        return a @ b
    return torch.stack([x @ y for x, y in zip(*torch.broadcast_tensors(a, b))])


def _vmin(c: Cones, x):
    return x.reshape(_lead(c) + (-1,)).amin(-1)


def _vmax(c: Cones, x):
    return x.reshape(_lead(c) + (-1,)).amax(-1)


# ----------------------------------------------------------------------
# cone primitives (mirror ConeSystem methods)
# ----------------------------------------------------------------------


def assemble(c: Cones, dC, scal, y, dEye):
    return cone_ops.assemble(c.groups, c.lp, dC, scal, y, dEye, hp=c.cfg.dhp)


def factor(c: Cones, S, s_lp):
    return cone_ops.factor(S, s_lp, dd=c.cfg.cone_dd)


def logdet(c: Cones, L, s_lp):
    return cone_ops.logdet(L, s_lp)


def cone_ratio(c: Cones, L, s_lp, dS, ds_lp, lz):
    """Ratio test over all cone groups, threading per-group Lanczos
    warm-start vectors (State.lz) like the reference's persistent vVec
    (ref hdsdp_lanczos.c:166-178 dLanczosWarmStart): each Lanczos group
    starts from the previous call's top Ritz image (plus the anti-
    stagnation perturbation applied inside block_ratio) and runs a
    reduced fixed depth.  Returns (step, new_lz): one step per instance
    of a fleet, from one batched test over all of them."""
    profile.count("ratio_tests")
    with profile.span("ratio_test"):
        cfg = c.cfg
        step = c.b.new_full(_lead(c), INF)
        new_lz = []
        for gi, (Lg, dSg) in enumerate(zip(L, dS)):
            if cfg.kwarm > 0:
                steps, w = ratio_ops.block_ratio(
                    Lg, dSg, mode=cfg.ratio_mode, krylov=cfg.kwarm,
                    v0=lz[gi], return_warm=True, adaptive=False, nan_safe=True,
                )
                new_lz.append(lz[gi] if w is None else w.to(lz[gi].dtype))
            else:
                steps = ratio_ops.block_ratio(Lg, dSg, mode=cfg.ratio_mode,
                                              krylov=cfg.krylov, nan_safe=True)
                new_lz.append(lz[gi])
            step = torch.minimum(step, _vmin(c, steps))
        if c.lp is not None:
            step = torch.minimum(step, ratio_ops.vector_ratio_test(s_lp, ds_lp))
        return step, tuple(new_lz)


def build_kkt(c: Cones, L, s_lp, Rd, kind: str) -> cone_ops.KKTOut:
    """Mirror of cones._build_kkt (kind in {"inf", "hsd", "corr"})."""
    c.n_builds[kind] = c.n_builds.get(kind, 0) + 1
    with profile.span("build_kkt"):
        return cone_ops.build_kkt(c.groups, c.lp, L, s_lp, Rd, c.b.shape[-1], kind,
                                  hp=c.cfg.hp)


# ----------------------------------------------------------------------
# Schur-system backend: the f64 factor with its fused ladder (no LU
# fallback, unlike the host loop), or with kkt_mp="on" an f32
# equilibrated factor + f64 iterative refinement (ops.cg.refine_solve)
# with a probe-gated f64 ladder
# ----------------------------------------------------------------------


def _factor_m_f64(c: Cones, M):
    """Cholesky with the regularization ladder (algo.factor_kkt): up to
    six rungs base * 100^k, base = 1e-14 max(diag M) + 1e-300; the first
    rung that factors wins, else the failed (NaN) factor and ok False."""
    ok, L = chol_ops.psd_check(M, _lead(c))
    h = _read(c, ok)
    if _all(c, h):
        return L, ok
    base = _vmax(c, torch.diagonal(M, dim1=-2, dim2=-1)) * 1e-14 + 1e-300
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    out = (L, c.no)
    with _narrow(c, np.logical_not(h)):
        todo = True
        for k in range(6):
            okr, Lr = chol_ops.psd_check(
                M + schur_ops.bcast(base * (10.0 ** (2 * k)), 2) * eye, _lead(c))
            hr = _read(c, okr)
            with _narrow(c, todo):
                out = _select(c, hr, (Lr, okr), out)
            todo = np.logical_and(todo, np.logical_not(hr))
            if not _any(c, todo):
                break
    return _select(c, h, (L, ok), out)


def _factor_m_mp(c: Cones, M):
    """f32 equilibrated factor + probe; f64 ladder only when the probe
    shows refinement cannot reach f64 accuracy (kappa ~> 1/eps_f32).

    ``need64`` is decided per instance of a fleet, as ``jax.vmap`` decides
    the JAX package's traced flag: the f64 ladder runs for the instances
    that need it (``_narrow``), and their count is kept per instance in
    ``Cones.mp_f64`` (of ``Cones.mp_factors`` factors).

    Returns the factor tuple (M, L32, s, Lf64, need64) and ok; Lf64 is None
    when no instance needs it."""
    m = M.shape[-1]
    L32, s, ok32 = cg_ops._equilibrated_factor(M, f32=True)
    L32 = _where(ok32, L32, torch.eye(m, dtype=torch.float32, device=M.device))
    probe = torch.ones(M.shape[:-1] + (1,), dtype=M.dtype, device=M.device)
    _, p_status, _ = cg_ops.refine_solve(M, L32, s, probe, max_iter=20,
                                         live=c.live if c.fleet else None)
    need64 = np.logical_or(np.logical_not(_read(c, ok32)), p_status != cg_ops.STATUS_OK)
    if not c.fleet:
        need64 = bool(need64)
    c.mp_factors = c.mp_factors + np.asarray(c.live, dtype=int)
    c.mp_f64 = c.mp_f64 + np.asarray(np.logical_and(c.live, need64), dtype=int)
    if _any(c, need64):
        with _narrow(c, need64):
            Lf64, ok = _factor_m_f64(c, M)
        ok = _select(c, need64, ok, c.yes)
    else:
        Lf64, ok = None, c.yes
    return (M, L32, s, Lf64, need64), ok


def factor_m(c: Cones, M):
    with profile.span("factor_m"):
        if c.cfg.mp:
            return _factor_m_mp(c, M)
        return _factor_m_f64(c, M)


def solve_m(c: Cones, Lm, rhs):
    """Solve against factor_m's factor: rhs [m] or [m, k] (a fleet's with
    its leading axis).  Under kkt_mp, per instance: the f64 factor's solve
    where ``need64`` holds, the refinement elsewhere (``_cond``)."""
    with profile.span("solve_m"):
        if not c.cfg.mp:
            return chol_ops.chol_solve(Lm, rhs)
        M, L32, s, Lf64, need64 = Lm
        vec = rhs.ndim == M.ndim - 1
        rhs2 = rhs[..., None] if vec else rhs

        def direct():
            return chol_ops.chol_solve(Lf64, rhs2)

        def refine():
            X, _, _ = cg_ops.refine_solve(M, L32, s, rhs2, max_iter=30,
                                          live=c.live if c.fleet else None)
            return X

        X = _cond(c, need64, direct, refine)
        return X[..., 0] if vec else X


# ----------------------------------------------------------------------
# shared sub-steps
# ----------------------------------------------------------------------


def bound_slacks(c: Cones, tau, y):
    return y - _v(tau * c.bound_lo), _v(tau * c.bound_up) - y


def bound_ratio(sl, su, dsl, dsu):
    return ratio_ops.vector_ratio_test(torch.cat([sl, su], dim=-1),
                                       torch.cat([dsl, dsu], dim=-1))


def _where_opt(flag, a, b):
    return None if a is None else _where(flag, a, b)


def check_interior(c: Cones, st: State, tau, y, with_bound=True):
    """algo.check_is_interior: assemble at (tau, y), factor, update DUALVAR."""
    with profile.span("check_interior"):
        S, s_lp = assemble(c, tau, -1.0, y, -st.Rd + st.perturb)
        ok, L = factor(c, S, s_lp)
        st = st._replace(
            S=tuple(_where(ok, a, b) for a, b in zip(S, st.S)),
            L=tuple(_where(ok, a, b) for a, b in zip(L, st.L)),
            s_lp=_where_opt(ok, s_lp, st.s_lp),
        )
        interior = ok
        if with_bound:
            sl, su = bound_slacks(c, tau, y)
            bok = (sl > 0).all(-1) & (su > 0).all(-1)
            st = st._replace(sl=_where(bok, sl, st.sl), su=_where(bok, su, st.su))
            interior = interior & bok
        return interior, st


def set_step(c: Cones, st: State, dtau, dy, gamma):
    dS, ds_lp = assemble(c, dtau, -1.0, dy, gamma * st.Rd)
    dsu = _v(dtau * c.bound_up) - dy
    dsl = dy - _v(dtau * c.bound_lo)
    return dS, ds_lp, dsl, dsu


def add_step_to_checker(c: Cones, st: State, dS, ds_lp, dsl, dsu, alpha):
    """algo.add_step_to_checker (checker := dualvar + alpha*step, PSD check)."""
    S_new = tuple(Sg + schur_ops.bcast(alpha, 3) * dSg for Sg, dSg in zip(st.S, dS))
    s_new = st.s_lp + _v(alpha) * ds_lp if c.lp is not None else None
    ok, Lnew = factor(c, S_new, s_new)
    sl = st.sl + _v(alpha) * dsl
    su = st.su + _v(alpha) * dsu
    st = st._replace(Schk=S_new, s_lp_chk=s_new, Lchk=Lnew, sl_chk=sl, su_chk=su)
    return ok & (sl > 0).all(-1) & (su > 0).all(-1), st


def logdet_cur(c: Cones, st: State):
    """algo.logdet_cur (negated barrier at DUALVAR)."""
    val = logdet(c, st.L, st.s_lp)
    return -(val + torch.log(st.sl).sum(-1) + torch.log(st.su).sum(-1))


def _maker_where(flag, a: Maker, b: Maker) -> Maker:
    return Maker(mu=torch.where(flag, a.mu, b.mu), y=_where(flag, a.y, b.y),
                 dy=_where(flag, a.dy, b.dy))


def prox_measure(c: Cones, p: Pars, st: State, kkt, d1, d2, which_infeas: bool):
    """algo.prox_measure — returns (p_obj_type in {-1,0,1} as int32, st)."""
    asinv, asinvrdsinv, trace_sinv = kkt.asinv, kkt.asinvrdsinv, kkt.trace_sinv
    mu = st.mu
    dy1 = d1 / _v(mu) - d2
    v2 = c.b / _v(mu) - asinv
    prox2 = _dot(c, dy1, v2)
    pos = prox2 >= 0.0

    prox_norm = torch.where(pos, torch.sqrt(torch.clamp(prox2, min=0.0)), 1.0)
    vec = dy1 - st.y
    su_b = _v(c.bound_up) + vec
    sl_b = -_v(c.bound_lo) - vec
    bound_ok = (sl_b > 0).all(-1) & (su_b > 0).all(-1)

    # expert check (checker := -Rd*I + A'vec + C), run only when needed
    def expert():
        S, s_lp = assemble(c, 1.0, 1.0, vec, -st.Rd + st.perturb)
        okc, Lc = factor(c, S, s_lp)
        return okc, S, s_lp, Lc

    okc, Schk, s_lp_chk, Lchk = _cond(c, _read(c, pos & bound_ok), expert,
                                      lambda: (c.no, st.Schk, st.s_lp_chk, st.Lchk))
    feas = pos & bound_ok & okc

    if which_infeas:
        rel_gap = _dot(c, dy1, asinvrdsinv + asinv) + trace_sinv * st.Rd
    else:
        rel_gap = _dot(c, dy1, asinv)
    rel_gap = rel_gap + p.all_cone_dims
    p_obj_new = st.d_obj_internal + rel_gap * mu

    # primal infeasibility estimate via the bound cone
    d = -dy1
    slc = st.y - _v(c.bound_lo)
    suc = _v(c.bound_up) - st.y
    xl = _v(mu) * (1.0 / slc - d / (slc * slc))
    xu = _v(mu) * (1.0 / suc + d / (suc * suc))
    p_inf = _vmax(c, torch.abs(xu - xl))
    p_inf = torch.where(p_inf < 1e-16, 0.0, p_inf)

    inacc_tol = 1e-04
    acc = p.rel_opt_tol  # prec_ord_acc == rel_opt_tol per params
    thresh = torch.abs(st.d_obj_internal) + 1.0
    gap_mu = rel_gap * mu
    take_inacc = feas & (p_inf < 1.0) & (gap_mu > inacc_tol * thresh)
    take_acc = feas & (p_inf < 1.0) & (gap_mu <= inacc_tol * thresh) & (gap_mu > acc * thresh)
    new_maker = Maker(mu=mu, y=st.y, dy=dy1)

    # 1 where feasible with rel_gap >= 0, -1 where feasible below -1, else 0
    good = feas & (rel_gap >= 0)
    p_obj_type = _i32(good) - _i32(feas & (rel_gap < -1.0))
    st = st._replace(
        prox_norm=prox_norm,
        sl_chk=_where(pos, sl_b, st.sl_chk),
        su_chk=_where(pos, su_b, st.su_chk),
        Schk=Schk,
        s_lp_chk=s_lp_chk,
        Lchk=Lchk,
        p_obj_internal=torch.where(good, p_obj_new, st.p_obj_internal),
        p_infeas=torch.where(good, p_inf, st.p_infeas),
        maker_acc=_maker_where(take_acc, new_maker, st.maker_acc),
        maker_inacc=_maker_where(take_inacc, new_maker, st.maker_inacc),
    )
    return p_obj_type, st


def _log_row(st: State, row) -> State:
    if st.log.ndim == 3:
        # a fleet: written where each instance's n_iter points (the merge
        # in _drive keeps the rows of the instances that sat out)
        hit = torch.arange(st.log.shape[1], device=st.log.device) == st.n_iter[:, None]
        return st._replace(log=torch.where(hit[..., None], torch.stack(row, dim=-1)[:, None],
                                           st.log))
    st.log.index_copy_(0, st.n_iter.to(torch.int64).reshape(1), torch.stack(row)[None])
    return st


# ----------------------------------------------------------------------
# Phase A (fused mirror of algo.phase_a)
# ----------------------------------------------------------------------


def _phase_a_iteration(c: Cones, p: Pars, st: State, corrector_a: int):
    """One Phase-A iteration (ref HDSDP_PhaseA_BarInfeasSolve body)."""
    kkt = build_kkt(c, st.L, st.s_lp, st.Rd, "inf")
    li = 1.0 / st.sl
    ui = 1.0 / st.su
    asinv_b = kkt.asinv + ui - li
    M = kkt.M + torch.diag_embed(li * li + ui * ui)
    kkt = kkt._replace(M=M, asinv=asinv_b)

    Lm, ok_m = factor_m(c, M)
    # failed KKT factorization terminates the phase deterministically
    # (otherwise NaN directions spin the loop to MAXITER)
    st = st._replace(status=torch.where(ok_m, st.status, NUMERICAL))
    sols = solve_m(c, Lm, torch.stack([c.b, asinv_b, kkt.asinvrdsinv], dim=-1))
    d1, d2, d3 = sols[..., 0], sols[..., 1], sols[..., 2]

    p_obj_type, st = prox_measure(c, p, st, kkt, d1, d2, True)
    st = st._replace(
        status=torch.where(p_obj_type < 0, SUSPECT, st.status),
        p_obj_found=st.p_obj_found + torch.clamp(p_obj_type, min=0),
    )

    mu = st.mu
    mu = torch.where((p_obj_type == 1) & (st.prox_norm < 2.0), mu * 0.7, mu)
    target = (
        st.p_obj_internal - st.d_obj_internal - st.Rd * p.trx_estimate
    ) / (5.0 * p.all_cone_dims)
    mu = torch.where(
        st.prox_norm < 1.0,
        mu * 0.005,
        torch.where(
            st.prox_norm < 5.0,
            torch.maximum(mu * 0.01, target * 0.1),
            torch.where(
                st.prox_norm < 10.0,
                torch.maximum(mu * 0.1, target * 0.8),
                torch.maximum(mu * 0.95, target),
            ),
        ),
    )
    st = st._replace(mu=mu)

    # ---- adaptive residual-reduction rate (algo.adaptive_resi_rate)
    dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, -d2, 0.0)
    step, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
    st = st._replace(lz=lz)
    step = torch.minimum(step, bound_ratio(st.sl, st.su, dsl, dsu))
    alpha_c0 = torch.clamp(0.98 * step, max=1.0)
    max_step = alpha_c0

    # mirror the do-while: first trial at alpha_c0
    interior, st = add_step_to_checker(c, st, dS, ds_lp, dsl, dsu, alpha_c0)
    alpha_c = torch.where(interior, alpha_c0, alpha_c0 * 0.8)

    def shrink(carry):
        _, st, alpha_c = carry
        interior, st = add_step_to_checker(c, st, dS, ds_lp, dsl, dsu, alpha_c)
        return interior, st, torch.where(interior, alpha_c, alpha_c * 0.8)

    interior, st, alpha_c = _while(
        c, lambda cr: ~cr[0] & (cr[2] > 1e-02 * max_step), shrink, (interior, st, alpha_c))

    dS2, ds_lp2, _, _ = set_step(c, st, 0.0, d3, 1.0)
    alpha_inf, lz = cone_ratio(c, st.Lchk, st.s_lp_chk, dS2, ds_lp2, st.lz)
    st = st._replace(lz=lz)

    rate = torch.where(alpha_c > 0, alpha_inf / alpha_c, 0.0)
    rate = torch.clamp(0.98 * rate, max=1.0)
    rate = torch.where(
        st.prox_norm < 1.0,
        torch.clamp(rate, min=0.9),
        torch.where(
            st.prox_norm < 10.0,
            torch.clamp(rate, min=0.3),
            torch.where(st.prox_norm < 50.0, torch.clamp(rate, min=0.1), rate),
        ),
    )
    gamma = rate

    # ---- step: dy = d1/mu - d2 + gamma*d3
    dy = d1 / _v(st.mu) - d2 + _v(gamma) * d3
    dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy, gamma)
    step, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
    st = st._replace(lz=lz)
    step = torch.minimum(step, bound_ratio(st.sl, st.su, dsl, dsu))
    d_step = torch.clamp(0.95 * step, max=1.0)
    st = st._replace(
        d_step=d_step,
        n_small_step=st.n_small_step + _i32(d_step < 1e-03),
        y=st.y + _v(d_step) * dy,
        Rd=st.Rd * (1.0 - gamma * d_step),
    )

    # ---- infeasible corrector (algo.infeasible_corrector)
    st, corr_ok = _infeasible_corrector(c, p, st, Lm, corrector_a)
    # a corrector interior-check failure must not overwrite a SUSPECT (or
    # any other terminal) status: SUSPECT hands off to the HSD phase
    st = st._replace(
        status=torch.where(corr_ok | (st.status != RUNNING), st.status, NUMERICAL)
    )

    # ---- bookkeeping (print_log updates d_obj_internal)
    st = st._replace(d_obj_internal=_dot(c, c.b, st.y))
    st = _log_row(st, [st.p_obj_internal, st.d_obj_internal, torch.abs(st.Rd), st.mu,
                       st.d_step, st.prox_norm])

    # ---- convergence checks
    running = st.status == RUNNING
    status = torch.where(running & (torch.abs(st.Rd) < p.feas_tol), DUAL_FEASIBLE, st.status)
    status = torch.where((status == RUNNING) & (st.n_small_step > 3), SUSPECT, status)
    return st._replace(status=status, n_iter=st.n_iter + 1)


def _infeasible_corrector(c: Cones, p: Pars, st: State, Lm, n_max_corr: int):
    """algo.infeasible_corrector with the factorized M reused (Lm)."""
    interior, st = check_interior(c, st, 1.0, st.y)
    return _cond(c, _read(c, interior),
                 lambda: (_infeasible_rounds(c, p, st, Lm, n_max_corr), c.yes),
                 lambda: (st, c.no))


def _infeasible_rounds(c: Cones, p: Pars, st: State, Lm, n_max_corr: int):
    """The corrector's rounds: each while (Rd != 0) and the last round's
    rate did not fall to 0; an instance whose step got too small ends."""
    carry = (st, logdet_cur(c, st), st.mu.new_full(_lead(c), 0.8), True)
    stopped = False
    for _ in range(n_max_corr):
        if not _any(c, np.logical_not(stopped)):
            break
        st, _, _, active = carry
        go = np.logical_and(_read(c, (st.Rd != 0.0) & active), np.logical_not(stopped))
        if not _any(c, go):
            break
        with _narrow(c, go):
            new, small = _infeasible_round(c, st, Lm, *carry[1:])
        carry = _select(c, go, new, carry)
        stopped = np.logical_or(stopped, np.logical_or(np.logical_not(go), small))
    return carry[0]


def _infeasible_round(c: Cones, st: State, Lm, barrier, ratio_max, active):
    """One corrector round; returns ((st, barrier, ratio_max, active), the
    host decision "too small": those instances end the corrector)."""
    kkt = build_kkt(c, st.L, st.s_lp, st.Rd, "corr")
    li = 1.0 / st.sl
    ui = 1.0 / st.su
    asinv_b = kkt.asinv + ui - li
    sols = solve_m(c, Lm, torch.stack([asinv_b, kkt.asinvrdsinv], dim=-1))
    d2, d3 = sols[..., 0], sols[..., 1]

    dy = -d2
    dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy, 0.0)
    step, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
    st = st._replace(lz=lz)
    step = torch.minimum(step, bound_ratio(st.sl, st.su, dsl, dsu))
    step = torch.clamp(0.8 * step, max=1.0)

    # guarantee feasibility: halve until interior or tiny
    def halve(carry):
        _, st, step = carry
        interior, st = check_interior(c, st, 1.0, st.y + _v(step) * dy)
        return interior, st, torch.where(interior, step, step * 0.5)

    _, st, step = _while(c, lambda cr: ~cr[0] & (cr[2] >= 5e-03), halve, (c.no, st, step))

    small = _read(c, step < 5e-03)

    def too_small():
        _, st2 = check_interior(c, st, 1.0, st.y)
        return st2, barrier, ratio_max, active

    def rest():
        new_barrier = logdet_cur(c, st)

        def worse():
            step2 = step * 0.5
            _, st2 = check_interior(c, st, 1.0, st.y + _v(step2) * dy)
            return st2, step2, torch.full_like(barrier, -INF)

        st2, alpha_c, barrier2 = _cond(c, _read(c, new_barrier > barrier), worse,
                                       lambda: (st, step, new_barrier))

        dS3, ds_lp3, dsl3, dsu3 = set_step(c, st2, 0.0, d3, 1.0)
        step2, lz = cone_ratio(c, st2.L, st2.s_lp, dS3, ds_lp3, st2.lz)
        st2 = st2._replace(lz=lz)
        step2 = torch.minimum(step2, bound_ratio(st2.sl, st2.su, dsl3, dsu3))
        rate = torch.clamp(ratio_max * (step2 / alpha_c), max=1.0)

        resi = st2.Rd

        # NaN-safe cap: physically terminates because rate -> 0 recovers
        # the already-verified point y + alpha_c*dy
        def trip(carry):
            st, _, rate = carry
            st = st._replace(Rd=resi * (1 - alpha_c * rate))
            cand = st.y + _v(alpha_c) * (_v(rate) * d3 - d2)
            interior, st = check_interior(c, st, 1.0, cand)
            return (st, cand, torch.where(interior, rate, rate * 0.8)), interior

        st2, cand, rate = _repeat(c, trip, (st2, st2.y, rate), 300)

        ar = alpha_c * rate
        ratio_new = torch.where(
            ar < 5e-04, 0.0, torch.where(ar < 0.1, ratio_max * 0.9, ratio_max)
        )
        mu_new = torch.where(ar > 0.8, st2.mu * 0.8, st2.mu)
        ratio_new = torch.where(ar > 0.8, torch.clamp(ratio_new * 2.0, max=0.9), ratio_new)
        mid = (ar <= 0.8) & (ar > 0.3)
        mu_new = torch.where(mid, mu_new * 0.95, mu_new)
        ratio_new = torch.where(mid, torch.clamp(ratio_new * 2.0, max=0.8), ratio_new)
        return st2._replace(y=cand, mu=mu_new), barrier2, ratio_new, ratio_new != 0.0

    return _cond(c, small, too_small, rest), small


def _phase_a_body(c: Cones, p: Pars, reset_rd, st: State, corrector_a: int,
                  allow_reset: bool):
    """One Phase-A iteration incl. the n_iter==3 reset branch."""
    reset = allow_reset & (st.n_iter == 3) & (st.p_obj_found == 0)
    do_reset, running = (_h(v) for v in _read_all(c, reset, st.status == RUNNING))
    if _any(c, do_reset):
        def reset_start():
            # algo.reset_start + interior check
            st2 = st._replace(
                y=torch.zeros_like(st.y),
                p_obj_internal=torch.full_like(st.p_obj_internal, 1e+15),
                Rd=reset_rd,
            )
            interior, st2 = check_interior(c, st2, 1.0, st2.y)
            return st2._replace(status=torch.where(interior, st2.status, NUMERICAL))

        st = _cond(c, do_reset, reset_start, lambda: st)
        running = _read(c, st.status == RUNNING)
    return _cond(c, running, lambda: _phase_a_iteration(c, p, st, corrector_a), lambda: st)


def _drive(c: Cones, body, st, max_iter: int, is_phase_b: bool, test_first: bool,
           deadline: Optional[float] = None):
    """Run a phase body until its status leaves RUNNING: one host read of
    (status, n_iter) per iteration.  ``test_first`` mirrors the in-graph
    while_loop ("phase": test before every trip); without it the body runs
    first and the wall clock is checked after every trip ("iter").  A
    fleet runs "phase" (the JAX package's vmapped program): each trip
    steps the instances still running and freezes the others."""
    extras = phase_b_init_extras(c.b.device, _lead(c)) if is_phase_b else None

    def step(st, extras):
        with profile.span("iter"):
            if is_phase_b:
                out = body((st,) + extras)
                return out[0], out[1:]
            return body(st), None

    if c.fleet:
        if not test_first or deadline is not None:
            raise ValueError("a fleet runs whole phases (\"phase\") only, with no deadline")
        while True:
            code, n_iter = _read_all(c, st.status, st.n_iter)
            run = (code == RUNNING) & (n_iter < max_iter)
            if not run.any():
                return st._replace(status=torch.where(st.status == RUNNING, MAXITER, st.status))
            with _narrow(c, run):
                new = step(st, extras)
            st, extras = _select(c, run, new, (st, extras))

    if not test_first:
        st, extras = step(st, extras)
    while True:
        code, n_iter = (int(v) for v in _read_all(c, st.status, st.n_iter))
        if code != RUNNING:
            return st
        if n_iter >= max_iter:
            return st._replace(status=torch.full_like(st.status, MAXITER))
        if deadline is not None and time.time() >= deadline:
            return st._replace(status=torch.full_like(st.status, TIMELIMIT))
        st, extras = step(st, extras)


# ----------------------------------------------------------------------
# Phase B (fused mirror of algo.phase_b)
# ----------------------------------------------------------------------


def _choose_barrier(c: Cones, p: Pars, st: State, kkt, d1, d2, p_obj_type):
    """algo.choose_barrier — returns (ok, st)."""
    gap = st.p_obj_internal - st.d_obj_internal
    upper = gap / p.all_cone_dims
    lower = upper / p.pot_rho

    def found():
        dy1 = -d1 / _v(st.mu)
        dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy1, 0.0)
        step, lz = cone_ratio(c, st.Lchk, st.s_lp_chk, dS, ds_lp, st.lz)
        st2 = st._replace(lz=lz)
        step = torch.minimum(step, bound_ratio(st2.sl_chk, st2.su_chk, dsl, dsu))
        step = torch.clamp(step * 0.97, max=1e+05)
        return c.yes, st2._replace(mu=st2.mu / (1.0 + step))

    def not_found():
        dy2 = -d1 / _v(st.mu) + d2
        dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy2, 0.0)
        step_c, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
        st2 = st._replace(lz=lz)
        max_step0 = step_c
        step_b = bound_ratio(st2.sl, st2.su, dsl, dsu)
        p_step = torch.minimum(max_step0, step_b)
        p_step = torch.where(p_step < 1.0, 0.97 * p_step, p_step)

        n_try = [0]  # every instance still trying has made the same trials

        def trial(carry):
            _, st, p_step = carry
            interior, st = add_step_to_checker(c, st, dS, ds_lp, dsl, dsu, p_step)
            p_step = torch.where(interior, p_step, p_step * (0.97 if n_try[0] > 2 else 0.5))
            n_try[0] += 1
            return interior, st, p_step

        interior, st2, p_step = _while(c, lambda cr: ~cr[0] & (cr[2] >= 1e-05), trial,
                                       (c.no, st2, p_step))
        ok = interior

        dy1 = -_v(p_step) * d1 / _v(st2.mu)
        dS1, ds_lp1, dsl1, dsu1 = set_step(c, st2, 0.0, dy1, 0.0)
        step2, lz = cone_ratio(c, st2.Lchk, st2.s_lp_chk, dS1, ds_lp1, st2.lz)
        st2 = st2._replace(lz=lz)
        max_step = torch.minimum(max_step0, step2)
        max_step = torch.minimum(max_step, bound_ratio(st2.sl_chk, st2.su_chk, dsl1, dsu1))
        max_step = torch.clamp(max_step * 0.97, max=1e+05)
        mu_new = p_step * st2.mu / (1.0 + max_step) + (1.0 - p_step) * (
            st2.p_obj_internal - st2.d_obj_internal
        ) / p.all_cone_dims
        return ok, st2._replace(mu=mu_new)

    ok, st = _cond(c, _read(c, p_obj_type > 0), found, not_found)
    st = st._replace(mu=torch.clamp(st.mu, min=lower, max=upper))
    return ok, st


def _feasible_build_step(c: Cones, p: Pars, st: State, kkt, d1, d2):
    """algo.feasible_build_step (mu shrink loop; its first trip is known)."""

    def trip(carry):  # n caps NaN runaway
        mu, _ = carry
        dy = d1 / _v(mu) - d2
        v = c.b / _v(mu) - kkt.asinv
        prox2 = _dot(c, v, dy)
        neg = prox2 < 0.0
        prox = torch.where(neg, 1e+02, torch.sqrt(torch.clamp(prox2, min=0.0)))
        done = neg | (prox >= 0.1)
        return (torch.where(done, mu, 0.1 * mu), prox), done

    mu, prox = _repeat(c, trip, (st.mu, None), 300)
    st = st._replace(mu=mu, prox_norm=prox)
    return d1 / _v(mu) - d2, st


def _primal_infeas_check(c: Cones, p: Pars, st: State, force):
    """algo.primal_infeas_check — dual improving ray detection."""
    trigger = (
        (st.p_infeas >= p.rhs_fro_norm)
        | force
        | ((st.p_infeas > 0.01 * p.rhs_one_norm) & (st.mu < 1e-03))
    )
    d_obj_val = st.d_obj_internal * p.pd_scal
    norm = torch.linalg.vector_norm(st.y, dim=-1)
    trigger = trigger & (d_obj_val >= 0.0) & (norm > 0.0)

    def ray():
        yn = st.y / _v(norm)
        S, s_lp = assemble(c, 0.0, -1.0, yn, 1e-08 + st.perturb)
        ok, L = factor(c, S, s_lp)
        return ok, st._replace(Schk=S, s_lp_chk=s_lp, Lchk=L)

    return _cond(c, _read(c, trigger), ray, lambda: (c.no, st))


def _reduce_potential(c: Cones, p: Pars, st: State, dy):
    """algo.reduce_potential — returns (ok, st)."""
    rho = (st.p_obj_internal - st.d_obj_internal) * p.pd_scal / st.mu
    # NB: algo uses (p_obj_val - d_obj_val)/mu with vals = internal*pd_scal
    min_step_tol = 0.5 * _f64(st.n_small_step >= 2)
    required_dec = 0.05 * _f64(st.prox_norm < 0.5)

    dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy, 0.0)
    step, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
    st = st._replace(lz=lz)
    step = torch.minimum(step, bound_ratio(st.sl, st.su, dsl, dsu))
    s = torch.clamp(step * 0.95, max=1.0)

    pot_now = logdet_cur(c, st) + rho * torch.log(st.p_obj_internal - st.d_obj_internal)

    def trip(carry):
        st, s, fail = carry
        cand = st.y + _v(s) * dy
        interior, st = check_interior(c, st, 1.0, cand)
        # the interior/accept conds have elementwise branches (torch.where);
        # only the tiny-step branch refactors
        pot_new = logdet_cur(c, st) + rho * torch.log(st.p_obj_internal - _dot(c, c.b, cand))
        accept = (
            (pot_new <= pot_now - required_dec)
            | (s * st.prox_norm <= 0.001)
            | (s < min_step_tol)
        )
        acc = interior & accept
        tiny, done = (_h(v) for v in _read_all(c, interior & ~accept & (s < 1e-04), acc))

        def tiny_step():
            interior2, st2 = check_interior(c, st, 1.0, st.y)
            return st2, s, ~interior2

        def step_on():
            return (st._replace(y=_where(acc, cand, st.y)),
                    torch.where(interior, torch.where(accept, s, s * 0.3), s * 0.33), fail)

        return _cond(c, tiny, tiny_step, step_on), np.logical_or(tiny, done)

    carry, todo = (st, s, c.no), True
    for _ in range(300):
        with _narrow(c, todo):
            new, stop = trip(carry)
        carry = _select(c, todo, new, carry)
        todo = np.logical_and(todo, np.logical_not(stop))
        if not _any(c, todo):
            break
    st, s, fail = carry
    st = st._replace(d_step=s)
    return ~fail, st


def _feasible_corrector(c: Cones, p: Pars, st: State, Lm, d1, n_max_corr: int,
                        corr_disable):
    """algo.feasible_corrector.  Returns (st, disable_flag)."""
    disable = (
        ((st.d_step < 0.1) & (st.mu < 1e-05)) | (st.d_step < 1e-03) | (st.mu < 1e-06)
    )
    n_eff_zero = (st.prox_norm < 0.1) | (st.d_step < 1e-02) | disable | corr_disable
    if n_max_corr == 0:
        return st, disable
    st = _cond(c, _read(c, n_eff_zero), lambda: st,
               lambda: _feasible_rounds(c, p, st, Lm, d1, n_max_corr))
    return st, disable


def _feasible_rounds(c: Cones, p: Pars, st: State, Lm, d1, n_max_corr: int):
    """The feasible corrector's rounds, each while mu >= 1e-5 and the last
    round's step was not tiny."""
    acd = p.all_cone_dims
    shrink = acd / (acd + torch.sqrt(acd))
    b_dot_d1 = _dot(c, c.b, d1)

    def round_(carry):
        st, b_dot_corr = carry
        kkt = build_kkt(c, st.L, st.s_lp, st.Rd, "corr")
        li = 1.0 / st.sl
        ui = 1.0 / st.su
        d2 = solve_m(c, Lm, kkt.asinv + ui - li)
        b_dot_d2 = _dot(c, c.b, d2)
        mu_new = torch.where((b_dot_d2 > 0) & (b_dot_d1 > 0), b_dot_d1 / b_dot_d2,
                             st.mu) * shrink
        st = st._replace(mu=mu_new)

        dy = d1 / _v(st.mu) - d2
        b_dot_corr = b_dot_corr + _dot(c, c.b, dy)

        # barrier function -(b'y + mu*logdet)
        barrier_now = -(_dot(c, c.b, st.y) + st.mu * (-logdet_cur(c, st)))
        dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy, 0.0)
        step, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
        st = st._replace(lz=lz)
        step = torch.minimum(step, bound_ratio(st.sl, st.su, dsl, dsu))
        step = step * 0.95
        step = torch.minimum(step, p.pot_rho / torch.clamp(st.prox_norm, min=1e-300))

        def trip(carry):
            st, step = carry
            cand = st.y + _v(step) * dy
            interior, st = check_interior(c, st, 1.0, cand)
            barrier_new = -(_dot(c, c.b, cand) + st.mu * (-logdet_cur(c, st)))
            done = (step < 1e-04) | (
                barrier_new <= barrier_now - torch.abs(0.05 * b_dot_corr * step)
            )
            denom = 2.0 * (barrier_new - barrier_now + b_dot_corr * step) / (step * step)
            frac = b_dot_corr / torch.where(denom == 0, 1e-300, denom)
            use_quad = (denom != 0) & (frac > 0) & (frac < step)
            s_int = torch.where(done, step, torch.where(use_quad, frac, step * 0.5))
            return (st, torch.where(interior, s_int, step * 0.5)), interior & done

        st, step = _repeat(c, trip, (st, step), 300)

        tiny, go = (_h(v) for v in _read_all(c, step < 1e-04, st.mu >= 1e-05))

        def tiny_step():
            _, st2 = check_interior(c, st, 1.0, st.y)
            return st2

        st = _cond(c, tiny, tiny_step, lambda: st._replace(y=st.y + _v(step) * dy))
        return (st, b_dot_corr), np.logical_and(go, np.logical_not(tiny))

    carry = (st, torch.zeros_like(b_dot_d1))
    go = _read(c, st.mu >= 1e-05)
    for _ in range(n_max_corr):
        if not _any(c, go):
            break
        with _narrow(c, go):
            new, go_next = round_(carry)
        carry = _select(c, go, new, carry)
        go = np.logical_and(go, go_next)
    return carry[0]


def _phase_b_iteration(c: Cones, p: Pars, st_ex, corrector_b: int, psdp_eligible: bool):
    st, force_detect, n_internal, corr_disable, no_p_obj_found = st_ex
    n_internal = n_internal + 1
    force_detect = force_detect & (n_internal <= 10)

    kkt = build_kkt(c, st.L, st.s_lp, st.Rd, "inf")
    li = 1.0 / st.sl
    ui = 1.0 / st.su
    asinv_b = kkt.asinv + ui - li
    M = kkt.M + torch.diag_embed(li * li + ui * ui)
    # regularize if mu > 1 (algo.regularize_kkt(1e-6))
    reg = torch.clamp(1e-06 * _vmin(c, torch.diagonal(M, dim1=-2, dim2=-1)), max=1e-05)
    reg = torch.where((reg < 1e-14) | (st.mu <= 1.0), 0.0, reg)
    M = M + schur_ops.bcast(reg, 2) * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    kkt = kkt._replace(M=M, asinv=asinv_b)

    Lm, ok_m = factor_m(c, M)
    st = st._replace(status=torch.where(ok_m, st.status, NUMERICAL))
    sols = solve_m(c, Lm, torch.stack([c.b, asinv_b], dim=-1))
    d1, d2 = sols[..., 0], sols[..., 1]

    p_obj_type, st = prox_measure(c, p, st, kkt, d1, d2, False)
    st = st._replace(
        status=torch.where(p_obj_type < 0, SUSPECT, st.status),
        p_obj_found=st.p_obj_found + torch.clamp(p_obj_type, min=0),
    )
    no_p_obj_found = torch.where(p_obj_type != 0, 0, no_p_obj_found + 1)

    ok_bar, st = _choose_barrier(c, p, st, kkt, d1, d2, p_obj_type)
    st = st._replace(status=torch.where(ok_bar, st.status, NUMERICAL))

    dy, st = _feasible_build_step(c, p, st, kkt, d1, d2)

    ray, st = _primal_infeas_check(c, p, st, force_detect)
    st = st._replace(status=torch.where(ray, INFEAS, st.status))

    def continue_iter():
        ok_pot, st2 = _reduce_potential(c, p, st, dy)
        st2 = st2._replace(
            status=torch.where(ok_pot, st2.status, NUMERICAL),
            n_small_step=st2.n_small_step + _i32(st2.d_step < 1e-03),
        )
        st2, disable = _feasible_corrector(c, p, st2, Lm, d1, corrector_b, corr_disable)
        return st2, corr_disable | disable

    st, corr_disable = _cond(c, _read(c, st.status == RUNNING), continue_iter,
                             lambda: (st, corr_disable))

    # log-equivalent bookkeeping
    st = st._replace(d_obj_internal=_dot(c, c.b, st.y))
    st = _log_row(st, [st.p_obj_internal, st.d_obj_internal, st.p_infeas, st.mu,
                       st.d_step, st.prox_norm])
    p_obj_val = st.p_obj_internal * p.pd_scal
    d_obj_val = st.d_obj_internal * p.pd_scal
    comp = p_obj_val - d_obj_val
    scale = torch.abs(p_obj_val) + torch.abs(d_obj_val) + 1.0

    converged = (comp < scale * p.rel_opt_tol) & (comp < p.abs_opt_tol_scaled)
    status = torch.where((st.status == RUNNING) & converged, OPTIMAL, st.status)
    if psdp_eligible:
        want_psdp = (
            ((st.d_step == 1.0) | (st.mu < 1e-05))
            & (st.p_infeas < 1e-06)
            & (comp < scale * 0.1)
        )
        status = torch.where((status == RUNNING) & want_psdp, PSDP_HANDOFF, status)
    status = torch.where((status == RUNNING) & (st.n_small_step > 3), NUMERICAL, status)
    status = torch.where((status == RUNNING) & (no_p_obj_found >= 10), NUMERICAL, status)
    st = st._replace(status=status, n_iter=st.n_iter + 1)
    return st, force_detect, n_internal, corr_disable, no_p_obj_found


def phase_b_init_extras(device, lead: tuple = ()):
    """Initial auxiliary loop state for Phase B (see _phase_b_iteration):
    (force_detect, n_internal, corrector disabled, no_p_obj_found), with
    a fleet's leading axis ``lead``."""
    return (
        torch.ones(lead, dtype=torch.bool, device=device),
        torch.zeros(lead, dtype=torch.int32, device=device),
        torch.zeros(lead, dtype=torch.bool, device=device),
        torch.zeros(lead, dtype=torch.int32, device=device),
    )


# ----------------------------------------------------------------------
# Phase A' — homogeneous self-dual embedding (fused mirror of
# algo.hsd_solve, ref HDSDP_PhaseA_BarHsdSolve hdsdp_algo.c:355-546)
# ----------------------------------------------------------------------


@dataclass
class HsdPars(_Tree):
    feas_tol: torch.Tensor
    abs_opt: torch.Tensor
    rel_opt: torch.Tensor
    hsd_gamma: torch.Tensor
    reset_rd: torch.Tensor
    pd_base: torch.Tensor  # 1 / (rhs_scal * obj_scal)


def _hsd_build_step(c: Cones, st: State, kkt, d1, d2, d3, d4):
    """ref HDSDP_HSD_BuildStep (algo.hsd_build_step)."""
    mu, tau = st.mu, st.tau
    bty = c.b @ st.y
    obj_improve = bty - st.d_obj_internal

    dd1 = c.b - mu * kkt.asinvcsinv
    num = -bty + mu / tau + mu * (kkt.csinv - kkt.csinvrdsinv)
    den = mu * kkt.csinvcsinv + mu / (tau * tau)
    num = num - dd1 @ (d1 * (tau / mu) - d2 + d3)
    den = den + dd1 @ (d1 / mu + d4)

    dtau = torch.where(torch.abs(den) < 1e-12, 0.0, num / den)
    dy = d1 * (tau + dtau) / mu + d4 * dtau - d2 + d3
    return dtau, dy, bty, obj_improve


def _hsd_iteration(c: Cones, hp: HsdPars, st: State):
    kkt = build_kkt(c, st.L, st.s_lp, st.Rd, "hsd")
    Lm, ok_m = factor_m(c, kkt.M)
    st = st._replace(status=torch.where(ok_m, st.status, NUMERICAL))
    rhs4 = torch.stack([c.b, kkt.asinv, kkt.asinvrdsinv, kkt.asinvcsinv], dim=1)
    sols = solve_m(c, Lm, rhs4)
    d1, d2, d3, d4 = sols[:, 0], sols[:, 1], sols[:, 2], sols[:, 3]

    dtau, dy, bty, obj_improve = _hsd_build_step(c, st, kkt, d1, d2, d3, d4)
    st = st._replace(d_obj_internal=bty, obj_improve=obj_improve)

    # ratio test incl tau (ref HDSDP_HSD_RatioTest, :316-353)
    t = st.tau / dtau
    max_step = torch.where((dtau != 0.0) & (t < 0.0), -t, INF)
    dS, ds_lp = assemble(c, dtau, -1.0, dy, 1.0 * st.Rd)
    step_c, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
    st = st._replace(lz=lz)
    max_step = torch.minimum(max_step, step_c)
    st = st._replace(n_small_step=st.n_small_step + _i32(max_step < 1e-02))

    # step-size ladder (ref :463-471)
    step = torch.where(
        max_step > 1.0,
        0.7 * max_step,
        torch.where(
            max_step > 0.5,
            0.5 * max_step,
            torch.where(max_step > 0.2, 0.3 * max_step, 0.2 * max_step),
        ),
    )
    step = torch.clamp(step, max=1.0)

    # d_obj_val at the pre-step iterate / tau (print_log semantics)
    d_obj_val = bty * hp.pd_base / st.tau

    st = st._replace(
        d_step=step,
        tau=st.tau + step * dtau,
        y=st.y + step * dy,
        Rd=st.Rd * (1.0 - step),
    )

    # barrier reduction (ref :484-499)
    mu = st.mu
    t_new = torch.where(
        (step > 0.8) & (st.tau > 1.0),
        torch.maximum(0.1 * mu, -0.1 * st.Rd / st.tau),
        torch.maximum(hp.hsd_gamma * mu, -0.1 * st.Rd / st.tau),
    )
    mu = torch.where(mu > 1e-12, torch.minimum(mu, t_new), torch.minimum(mu, 0.8 * mu))
    st = st._replace(mu=mu)

    converged = (
        (torch.abs(st.Rd) < hp.feas_tol * st.tau)
        & (st.mu < hp.abs_opt)
        & (st.mu < hp.rel_opt * (1 + 2.0 * torch.abs(d_obj_val)))
        & (torch.abs(st.obj_improve) < 1e-05 * (torch.abs(st.d_obj_internal) + 1.0))
    )
    # DUAL_FEASIBLE: the host maps it to DUAL_OPTIMAL when d_only
    status = torch.where((st.status == RUNNING) & converged, DUAL_FEASIBLE, st.status)
    st = _log_row(st, [torch.full_like(st.mu, 1e+30), st.d_obj_internal, torch.abs(st.Rd),
                       st.mu, st.d_step, st.tau])
    status = torch.where((status == RUNNING) & (st.tau <= 1e-10), SUSPECT, status)
    return st._replace(status=status, n_iter=st.n_iter + 1)


def _hsd_body(c: Cones, hp: HsdPars, st: State):
    interior, st = check_interior(c, st, st.tau, st.y, with_bound=False)
    if _read(c, interior):
        return _hsd_iteration(c, hp, st)
    # ref :641-647: at n_iter == 0 inflate the residual, reset and retry
    # next iteration; later, NUMERICAL (both branches elementwise)
    first = st.n_iter == 0
    return st._replace(
        y=torch.where(first, torch.zeros_like(st.y), st.y),
        tau=torch.where(first, 1.0, st.tau),
        p_obj_internal=torch.where(first, 1e+15, st.p_obj_internal),
        Rd=torch.where(first, hp.reset_rd, st.Rd),
        n_iter=st.n_iter + _i32(first),
        status=torch.where(first, st.status, NUMERICAL),
    )


# ----------------------------------------------------------------------
# host integration
# ----------------------------------------------------------------------


def _scalars(dev, *vals, dtype=torch.float64):
    """Host scalars as 0-d device tensors, in one transfer."""
    return torch.tensor(vals, dtype=dtype).to(dev).unbind()


def _config_from_ipm(ipm) -> Config:
    p = ipm.params
    return Config(
        ratio_mode=p.ratio_test,
        krylov=p.lanczos_dim,
        kwarm=p.lanczos_warm_dim,
        # "auto" is the f64 factor on the port
        mp=p.kkt_mp == "on",
        hp=bool(ipm.cones.kkt_hp),
        dhp=bool(ipm.cones.dual_hp),
        cone_dd=bool(ipm.cones.cone_dd),
    )


def _cones_from_ipm(ipm) -> Cones:
    lo, up = _scalars(ipm.device, ipm.bound_lo, ipm.bound_up)
    return Cones(groups=ipm.cones.groups, lp=ipm.cones.lp, b=ipm.b, bound_lo=lo,
                 bound_up=up, cfg=_config_from_ipm(ipm))


def _pars_from_ipm(ipm, phase: str) -> Pars:
    p = ipm.params
    f = ipm.f
    n_sum = max(f.n_sum_cone_dims, 1)
    if phase == "a":
        feas_tol = max(p.abs_feas_tol, p.rel_feas_tol * (1 + f.obj_one_norm))
    else:
        feas_tol = min(p.abs_feas_tol, p.rel_feas_tol * (1 + f.obj_one_norm))
    feas_tol = feas_tol * ipm.obj_scal / np.sqrt(n_sum)
    pd_scal_mul = ipm.obj_scal * ipm.rhs_scal
    return Pars(*_scalars(
        ipm.device, feas_tol, p.trx_estimate, ipm.all_cone_dims, p.pot_rho, p.rel_opt_tol,
        p.abs_opt_tol / pd_scal_mul, 1.0 / pd_scal_mul, f.rhs_fro_norm, f.rhs_one_norm,
    ))


def _lz_start(S):
    """The cold Lanczos start vectors per group, built as the JAX package
    builds them (numpy f32)."""
    return tuple(
        np.broadcast_to(1.0 + 1e-03 * np.arange(Sg.shape[-1], dtype=np.float32),
                        Sg.shape[:-1]).copy()
        for Sg in S
    )


def _state_from_ipm(ipm) -> State:
    dev = ipm.device
    m = ipm.m

    def zero_m():
        return torch.zeros((m,), dtype=ipm.dtype, device=dev)

    def maker_of(mk):
        if mk.mu is None or mk.mu <= 0 or mk.y is None:
            return Maker(mu=torch.full((), -1.0, dtype=ipm.dtype, device=dev),
                         y=zero_m(), dy=zero_m())
        return Maker(mu=torch.full((), mk.mu, dtype=ipm.dtype, device=dev),
                     y=mk.y, dy=mk.dy)

    # Lanczos warm vectors persist across phase launches via the ipm
    # (ref: the per-cone lanczos struct outlives the phase loops)
    lz_shapes = tuple(tuple(Sg.shape[:-1]) for Sg in ipm.S)
    lz0 = ipm._lz_fused
    if lz0 is None or tuple(tuple(w.shape) for w in lz0) != lz_shapes:
        lz0 = tuple(torch.as_tensor(w, device=dev) for w in _lz_start(ipm.S))

    Rd, mu, perturb, tau, obj_improve, prox, p_obj, d_obj, p_inf, d_step = _scalars(
        dev, ipm.Rd, ipm.mu, ipm.perturb, ipm.tau, ipm.obj_improve, ipm.prox_norm,
        ipm.p_obj_internal, ipm.d_obj_internal, ipm.p_infeas, ipm.d_step)
    n_small, n_iter, status, found = _scalars(
        dev, ipm.n_small_step, ipm.n_iter, RUNNING, 0, dtype=torch.int32)
    return State(
        y=ipm.y, Rd=Rd, mu=mu, perturb=perturb, tau=tau, obj_improve=obj_improve,
        S=tuple(ipm.S), s_lp=ipm.s_lp, L=tuple(ipm.L), sl=ipm.sl, su=ipm.su,
        Schk=tuple(torch.zeros_like(Sg) for Sg in ipm.S),
        s_lp_chk=None if ipm.s_lp is None else torch.zeros_like(ipm.s_lp),
        Lchk=tuple(torch.zeros_like(Lg) for Lg in ipm.L),
        sl_chk=zero_m(), su_chk=zero_m(),
        prox_norm=prox, p_obj_internal=p_obj, d_obj_internal=d_obj, p_infeas=p_inf,
        d_step=d_step, n_small_step=n_small, n_iter=n_iter, status=status,
        p_obj_found=found,
        maker_acc=maker_of(ipm.maker_acc), maker_inacc=maker_of(ipm.maker_inacc),
        log=torch.full((ipm.params.max_iter, 6), torch.nan, dtype=ipm.dtype, device=dev),
        lz=lz0,
    )


def _stack(xs):
    """torch.stack that keeps each instance's memory layout: a Cholesky
    factor is column-major, and the triangular solves of a row-major copy
    round otherwise than the single solve's."""
    like = torch.empty_like(xs[0])
    out = torch.empty_strided((len(xs),) + tuple(like.shape), (like.numel(),) + like.stride(),
                              dtype=like.dtype, device=like.device)
    for o, x in zip(out, xs):
        o.copy_(x)
    return out


def stack_tree(trees):
    """N trees of one structure (State, Pars, Maker, tuples) as one tree
    whose tensors carry a leading axis of N instances."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return _stack(trees)
    if isinstance(t0, tuple):
        return tuple(stack_tree(list(xs)) for xs in zip(*trees))
    return type(t0)(**{f.name: stack_tree([getattr(t, f.name) for t in trees])
                       for f in dataclasses.fields(t0)})


def index_tree(tree, i: int):
    """Instance i of a stacked tree (views of its tensors)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, tuple):
        return tuple(index_tree(x, i) for x in tree)
    return type(tree)(**{f.name: index_tree(getattr(tree, f.name), i)
                         for f in dataclasses.fields(tree)})


def stack_cones(cs) -> Cones:
    """A fleet's Cones from its instances' (ops.schur.stack_groups pads
    the summation tables); the Config is the first instance's."""
    lp = None
    if cs[0].lp is not None:
        lp = schur_ops.LPArrays(A=torch.stack([c.lp.A for c in cs]),
                                c=torch.stack([c.lp.c for c in cs]))
    groups = tuple(schur_ops.stack_groups([c.groups[i] for c in cs])
                   for i in range(len(cs[0].groups)))
    return Cones(groups=groups, lp=lp, b=torch.stack([c.b for c in cs]),
                 bound_lo=torch.stack([c.bound_lo for c in cs]),
                 bound_up=torch.stack([c.bound_up for c in cs]), cfg=cs[0].cfg,
                 fleet=len(cs))


def state_from_numpy(tree, device) -> State:
    """A fused ``State`` of the JAX package with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, st)``) as the port's State on ``device``,
    dtypes kept, so that both packages can start from one iterate."""

    def conv(x):
        if x is None:
            return None
        if isinstance(x, (tuple, list)):
            return tuple(conv(v) for v in x)
        return torch.as_tensor(np.array(x), device=device)

    def maker(mk):
        return Maker(mu=conv(mk.mu), y=conv(mk.y), dy=conv(mk.dy))

    kw = {f.name: conv(getattr(tree, f.name)) for f in dataclasses.fields(State)
          if f.name not in ("maker_acc", "maker_inacc")}
    return State(maker_acc=maker(tree.maker_acc), maker_inacc=maker(tree.maker_inacc), **kw)


def _sync_to_ipm(st: State, ipm, c: Cones):
    from hdsdp_tpu_torch.solver import algo

    (ipm.Rd, ipm.mu, ipm.tau, ipm.obj_improve, ipm.prox_norm, ipm.p_obj_internal,
     ipm.d_obj_internal, ipm.p_infeas, ipm.d_step, n_small, n_iter, acc_mu,
     inacc_mu) = _read_all(
        c, st.Rd, st.mu, st.tau, st.obj_improve, st.prox_norm, st.p_obj_internal,
        st.d_obj_internal, st.p_infeas, st.d_step, st.n_small_step, st.n_iter,
        st.maker_acc.mu, st.maker_inacc.mu)
    ipm.n_small_step, ipm.n_iter = int(n_small), int(n_iter)
    ipm.y = st.y
    ipm.S, ipm.s_lp, ipm.L = st.S, st.s_lp, st.L
    ipm.sl, ipm.su = st.sl, st.su
    ipm.Schk, ipm.s_lp_chk, ipm.Lchk = st.Schk, st.s_lp_chk, st.Lchk
    ipm.sl_chk, ipm.su_chk = st.sl_chk, st.su_chk

    pd_scal = 1.0 / (ipm.rhs_scal * ipm.obj_scal)
    ipm.d_obj_val = ipm.d_obj_internal * pd_scal
    ipm.p_obj_val = ipm.p_obj_internal * pd_scal
    ipm.comp = ipm.p_obj_val - ipm.d_obj_val
    n_sum = max(ipm.f.n_sum_cone_dims, 1)
    ipm.d_infeas = np.sqrt(n_sum) * abs(ipm.Rd) / ipm.rhs_scal

    def maker_back(mk, mu):
        return algo.Maker() if mu <= 0 else algo.Maker(mu=mu, y=mk.y, dy=mk.dy)

    ipm.maker_acc = maker_back(st.maker_acc, acc_mu)
    ipm.maker_inacc = maker_back(st.maker_inacc, inacc_mu)
    ipm._lz_fused = st.lz


_STATUS_MAP = {
    TIMELIMIT: "TIMELIMIT",
    DUAL_FEASIBLE: "DUAL_FEASIBLE",
    SUSPECT: "SUSPECT_INFEAS_OR_UNBOUNDED",
    MAXITER: "MAXITER",
    NUMERICAL: "NUMERICAL",
    OPTIMAL: "PRIMAL_DUAL_OPTIMAL",
    INFEAS: "INFEAS_OR_UNBOUNDED",
    DUAL_OPTIMAL: "DUAL_OPTIMAL",
}


def _print_fused_log(ipm, st: State, method: str, start_iter: int):
    """Print the per-iteration rows captured on the device."""
    if not ipm.params.verbose:
        return
    profile.count("host_reads")
    rows = st.log.cpu().numpy()
    end = min(ipm.n_iter, rows.shape[0])
    pd = 1.0 / (ipm.rhs_scal * ipm.obj_scal)
    nsum = max(ipm.f.n_sum_cone_dims, 1)
    elapsed = time.time() - ipm.time_begin
    for i in range(start_iter, end):
        pobj, dobj, inf, mu, step, extra = rows[i]
        if not np.isfinite(dobj):
            continue
        if method == "hsd":
            tau = max(extra, 1e-300)
            inf_col = np.sqrt(nsum) * inf / (ipm.rhs_scal * tau)
            ipm.log.iter_row(method, i + 1, 1e+30, dobj * pd / tau, inf_col, mu, step,
                             extra, elapsed)
        elif method == "potential":
            ipm.log.iter_row(method, i + 1, pobj * pd, dobj * pd, inf, mu, step, extra,
                             elapsed)
        else:
            inf_col = np.sqrt(nsum) * inf / ipm.rhs_scal
            ipm.log.iter_row(method, i + 1, pobj * pd, dobj * pd, inf_col, mu, step,
                             extra, elapsed)


def phase_exit(name: str, code: int, n_iter: int) -> str:
    """How a phase ended, before the DIMACS check decides the final status
    (``Result.stats["fused_exit"]``; solver.batch's ``batch_exit``)."""
    what = "PSDP_HANDOFF" if code == PSDP_HANDOFF else _STATUS_MAP.get(code, "NUMERICAL")
    return f"phase {name}: {what} at iteration {n_iter}"


def _run_phase(ipm, c: Cones, name: str, body, whole: bool, is_phase_b: bool):
    """One phase launch from the ipm's iterate: "phase" (whole) drives the
    body as the JAX package's in-graph while_loop does, "iter" with the
    wall-clock check.  Syncs the end state back into the ipm, records how
    the phase ended and returns (status code, end state)."""
    p = ipm.params
    deadline = None if whole else ipm.time_begin + p.time_limit
    with profile.span("phase"):
        st = _drive(c, body, _state_from_ipm(ipm), p.max_iter, is_phase_b, whole, deadline)
        profile.count("host_reads")
        code = int(st.status)
        _sync_to_ipm(st, ipm, c)
    ipm._factor_stats["fused_exit"] = phase_exit(name, code, ipm.n_iter)
    return code, st


def _run_hsd_fused(ipm, c: Cones, d_only: bool, whole: bool = True):
    """Fused counterpart of algo.hsd_solve (ref hdsdp_algo.c:355-546)."""
    from hdsdp_tpu_torch.solver import algo

    p = ipm.params
    f = ipm.f
    ipm.which_method = "hsd"
    if ipm.status == algo.UNKNOWN:
        ipm.set_start("hsd", d_only)
    ipm.log.header("hsd")

    abs_opt = (p.abs_opt_tol if d_only else 1e+20) * 1e-04
    rel_opt = abs_opt * 1e-04  # (ref :401-402 quirk: derived from abs)
    feas_tol = min(p.abs_feas_tol, p.rel_feas_tol * (1.0 + f.obj_one_norm))
    feas_tol = feas_tol * ipm.obj_scal / np.sqrt(max(f.n_sum_cone_dims, 1))
    hp = HsdPars(*_scalars(
        ipm.device, feas_tol, abs_opt, rel_opt, p.hsd_gamma,
        max(-max(f.obj_fro_norm, 1e+02) * 1e+06, -1e+15),
        1.0 / (ipm.rhs_scal * ipm.obj_scal),
    ))
    start_iter = ipm.n_iter
    code, st = _run_phase(ipm, c, "A'", lambda s: _hsd_body(c, hp, s), whole, False)
    _print_fused_log(ipm, st, "hsd", start_iter)
    if code == DUAL_FEASIBLE:
        ipm.status = algo.DUAL_OPTIMAL if d_only else algo.DUAL_FEASIBLE
    else:
        ipm.status = _STATUS_MAP.get(code, algo.NUMERICAL)
    return ipm.status


def solve_fused(ipm, d_only: bool = False, mode: str = "phase"):
    """Fused counterpart of DualIPM.solve.

    mode="phase": each phase runs to its end in one call (the in-graph
    while-loop of the JAX package); mode="iter": the host drives the same
    iteration body with a wall-clock check after every iteration.  Both
    run the same bodies, so their iterates are bit-equal.
    """
    with profile.span("ipm_setup"):
        c = _cones_from_ipm(ipm)
    ipm.psdp = None
    try:
        return _solve_fused(ipm, c, d_only, mode == "phase")
    finally:
        ipm._count("fused_host_reads", c.n_reads)
        if c.cfg.mp:
            ipm._count("mp_factors", int(c.mp_factors))
            ipm._count("mp_f64_factors", int(c.mp_f64))


def _solve_fused(ipm, c: Cones, d_only: bool, whole: bool):
    from hdsdp_tpu_torch.solver import algo

    p = ipm.params
    f = ipm.f

    # ---- Phase A prologue (host, mirrors algo.phase_a before the loop)
    with profile.span("ipm_setup"):
        ipm.which_method = "infeas"
        allow_reset = not (f.many_cones or f.implied_trace or f.very_dense)
        ipm.set_start("infeas", False)
        if not ipm.check_is_interior(ipm.tau, ipm.y):
            ipm.log.info("Initial point is not in the cone. Adding slack value.")
            ipm.reset_start()
            if not ipm.check_is_interior(ipm.tau, ipm.y):
                ipm.status = algo.NUMERICAL
                return ipm.status
        ipm.log.header("infeas")

        (reset_rd,) = _scalars(ipm.device, max(-max(f.obj_fro_norm, 1e+02) * 1e+06, -1e+15))
        pars_a = _pars_from_ipm(ipm, "a")
    start_iter = ipm.n_iter
    code, st = _run_phase(
        ipm, c, "A", lambda s: _phase_a_body(c, pars_a, reset_rd, s, p.corrector_a, allow_reset),
        whole, False)
    ipm.status = _STATUS_MAP.get(code, algo.NUMERICAL)
    _print_fused_log(ipm, st, "infeas", start_iter)

    if code == SUSPECT:
        ipm.log.info("\nInfeasible method stops due to suspected infeasibility")
        return _run_hsd_fused(ipm, c, d_only, whole=whole)
    if code != DUAL_FEASIBLE:
        return ipm.status

    # ---- Phase B prologue (host, mirrors algo.phase_b before the loop)
    ipm.log.info("\nInfeasible method finds a dual feasible solution")
    ipm.which_method = "potential"
    feas_tol_b = min(p.abs_feas_tol, p.rel_feas_tol * (1.0 + f.obj_one_norm))
    feas_tol_b = feas_tol_b * ipm.obj_scal / np.sqrt(max(f.n_sum_cone_dims, 1))
    if abs(ipm.Rd) > feas_tol_b:
        ipm.log.info("Dual infeasibility from previous algorithm exceeds tolerance")
    ipm.perturb = -10.0 * ipm.Rd
    ipm.Rd = 0.0
    if ipm.perturb != 0.0:
        ipm.check_is_interior(1.0, ipm.y)
    ipm.log.header("potential")

    pars_b = _pars_from_ipm(ipm, "b")
    psdp_eligible = bool(p.psdp)

    while True:
        start_iter = ipm.n_iter
        code, st = _run_phase(
            ipm, c, "B", lambda s: _phase_b_iteration(c, pars_b, s, p.corrector_b, psdp_eligible),
            whole, True)
        _print_fused_log(ipm, st, "potential", start_iter)

        if code == PSDP_HANDOFF:
            from hdsdp_tpu_torch.solver.psdp import PSDPRefiner

            refiner = PSDPRefiner(ipm)
            refined = refiner.optimize()
            ipm._count("psdp_runs")
            ipm._count("psdp_iters", refiner.n_iter)
            if refined:
                # A clean PSDP return ends the solve even when not
                # converged (ref hdsdp_algo.c:1806-1814: retcode OK ->
                # break); the DIMACS gate decides the final status from
                # the refined (X, y).
                ipm.psdp = refiner
                ipm.status = (
                    algo.PRIMAL_DUAL_OPTIMAL
                    if refiner.converged
                    else algo.UNKNOWN  # DIMACS gate decides (hdsdp.c:905)
                )
                return ipm.status
            psdp_eligible = False
            continue

        ipm.status = _STATUS_MAP.get(code, algo.NUMERICAL)
        return ipm.status
