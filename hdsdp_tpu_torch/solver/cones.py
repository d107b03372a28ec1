"""Cone system: batched dual buffers, factors and KKT builds.

Port of the JAX package's solver/cones.py for the host loop, with a dense
M or matrix-free (ref interface/hdsdp_conic.c + def_hdsdp_conic.h:56-107):

  assemble  ~ HConeUpdate / coneInteriorCheckExpert buffer assembly
  factor    ~ HFpLinsysPsdCheck over every cone at once
  build_kkt ~ HKKTBuildUp (ref interface/hdsdp_schur.c:256-268)
  ratio_test~ HConeRatioTest (Lanczos / exact eigh)
  logdet    ~ HConeGetLogBarrier
  kkt_matvec, kkt_diag, kkt_rows, kkt_pcg(_chol): the Schur system as an
              operator, its exact diagonal, its rows in chunks, and CG on it

The presolve bucket choice is copied exactly from the JAX package, so
both packages pick the same layout for every family (diag, bounded
support, generic slot-major, or flat for multi-block groups).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hdsdp_tpu_torch.models.problem import SDPProblem
from hdsdp_tpu_torch.ops import chol as chol_ops
from hdsdp_tpu_torch.ops import ratio as ratio_ops
from hdsdp_tpu_torch.ops import schur as schur_ops
from hdsdp_tpu_torch.ops.schur import GroupArrays, LPArrays
from hdsdp_tpu_torch.utils import profile
from hdsdp_tpu_torch.utils.device import DTYPE, jcast, jdtype, jlift

INF = 1e30

# Max unrolled gathered-m^2 terms (r(r+1)/2 * c^2) the bounded-support
# Schur build may emit before the presolve falls back to slot-major
# matmuls (same budget as the JAX package, so both choose alike).
SUPPORT_TERM_BUDGET = 64

_INDEX_FIELDS = ("seg", "didx", "dblk", "pos", "dpos", "spos")


class KKTOut(NamedTuple):
    M: Optional[torch.Tensor]
    asinv: torch.Tensor
    asinvrdsinv: torch.Tensor
    asinvcsinv: Optional[torch.Tensor]
    csinv: torch.Tensor
    csinvcsinv: torch.Tensor
    csinvrdsinv: torch.Tensor
    trace_sinv: torch.Tensor


def _tensor(x, device, index: bool, dtype=DTYPE):
    if x is None:
        return None
    dt = torch.int64 if index else dtype
    return torch.tensor(np.asarray(x), dtype=dt, device=device)


def groups_from_numpy(groups, lp, device, m: Optional[int] = None):
    """Port arrays from host arrays of the same layout.

    ``groups``: a sequence of objects with ``_asdict()`` (e.g. the JAX
    package's GroupArrays) or dicts, whose fields convert with
    ``np.asarray`` (every bucket: the diag, support and slot-major fields,
    a length-0 ``dpos`` kept as the identity-map marker, and flat groups
    of any g); ``lp``: the same for LPArrays, or None; ``m``: the number
    of constraints, needed when a group is flat.  Returns (tuple of
    GroupArrays with their summation tables, LPArrays or None) on
    ``device``."""
    dev = torch.device(device)
    out = []
    for g in groups:
        d = g._asdict() if hasattr(g, "_asdict") else dict(g)
        ga = GroupArrays(**{
            k: _tensor(v, dev, k in _INDEX_FIELDS) for k, v in d.items()
        })
        if ga.lams is None and m is None:
            raise ValueError("a flat group needs m")
        out.append(schur_ops.with_tables(ga, ga.lams.shape[1] if m is None else m))
    lp_t = None
    if lp is not None:
        d = lp._asdict() if hasattr(lp, "_asdict") else dict(lp)
        lp_t = LPArrays(A=_tensor(d["A"], dev, False), c=_tensor(d["c"], dev, False))
    return tuple(out), lp_t


# ----------------------------------------------------------------------
# cone operations over (groups, lp)
# ----------------------------------------------------------------------


# Every function below also takes a FLEET (solver.batch): groups whose
# fields carry a leading axis of N same-shape instances (ops.schur), y
# [N, m], buffers [N, g, n, n], LP slacks [N, nlp] and per-instance
# scalars [N]; what it returns carries the same axis, and nothing is ever
# summed or reduced across instances.


def _lead(S, s_lp) -> tuple:
    """A fleet's leading axis (N,), or () for a single solve: buffers are
    [g, n, n] per instance, LP slacks [nlp]."""
    return tuple(S[0].shape[:-3]) if S else tuple(s_lp.shape[:-1])


def assemble(groups, lp, dC, scal, y, dEye, hp: bool = False):
    S = tuple(schur_ops.group_dual(ga, dC, scal, y, dEye, hp=hp) for ga in groups)
    s_lp = schur_ops.lp_dual(lp, dC, scal, y, dEye) if lp is not None else None
    return S, s_lp


def factor(S, s_lp, dd: bool = False):
    """(ok, L): ok is a 0-dim bool tensor (not yet read on the host), or
    one per instance of a fleet.  ``dd`` factors single large blocks with
    the double-single Cholesky (ops.chol.psd_factor, Params.cone_fp)."""
    lead = _lead(S, s_lp) if (S or s_lp is not None) else ()
    Ls = []
    ok = None
    for Sg in S:
        good, L = chol_ops.psd_factor(Sg, use_dd=dd, lead=lead)
        Ls.append(L)
        ok = good if ok is None else ok & good
    if s_lp is not None:
        good = torch.all(s_lp > 0, dim=-1)
        ok = good if ok is None else ok & good
    if ok is None:
        ok = torch.ones((), dtype=torch.bool)
    return ok, tuple(Ls)


def logdet(L, s_lp):
    lead = _lead(L, s_lp) if (L or s_lp is not None) else ()
    val = 0.0
    for Lg in L:
        val = val + chol_ops.chol_logdet(Lg, lead)
    if s_lp is not None:
        val = val + torch.sum(torch.log(s_lp), dim=-1)
    return val


def inverses(L, hp: bool = False):
    """U = S^-1 per group from the Cholesky factors."""
    return tuple(chol_ops.chol_inverse(Lg, use_dd=hp) for Lg in L)


def _kkt_terms(groups, lp, Us, s_lp, Rd, m: int, kind: str, with_m: bool,
               hp: bool, col_groups=None, col_lp=None, rows: Optional[int] = None) -> KKTOut:
    """The KKT sums over (group, U) pairs and the LP cone.  ``Us`` may be
    a generator, so that a dense build holds one inverse at a time.

    ``col_groups``/``col_lp``: the whole cones when ``groups``/``lp`` are
    row views of them (a block of ``rows`` constraint rows, see
    ops.schur.group_schur's ``col``): M is then those rows [rows, m] and
    the vectors their entries; the scalars are the whole cones' own."""
    dt, dev = (s_lp.dtype, s_lp.device) if not groups else (groups[0].C.dtype, groups[0].C.device)
    # a fleet's sums carry its leading axis
    lead = s_lp.shape[:-1] if not groups else groups[0].C.shape[:-3]
    r = m if rows is None else rows
    M = torch.zeros(lead + (r, m), dtype=dt, device=dev) if with_m else None
    asinv = torch.zeros(lead + (r,), dtype=dt, device=dev)
    trsas = torch.zeros(lead + (r,), dtype=dt, device=dev)
    tr_u = torch.zeros(lead, dtype=dt, device=dev)
    asinvcsinv = torch.zeros(lead + (r,), dtype=dt, device=dev) if kind == "hsd" else None
    csinv = torch.zeros(lead, dtype=dt, device=dev)
    csinvcsinv = torch.zeros(lead, dtype=dt, device=dev)
    csinvrdsinv = torch.zeros(lead, dtype=dt, device=dev)
    if col_groups is None:
        col_groups = (None,) * len(groups)

    for ga, U, cg in zip(groups, Us, col_groups):
        out = schur_ops.group_schur(ga, U, m, with_m=with_m, hp=hp, col=cg)
        if with_m:
            M = M + out.M
        asinv = asinv + out.asinv
        trsas = trsas + out.trSAS
        tr_u = tr_u + out.trU
        if kind == "hsd":
            h = schur_ops.group_hsd(ga, U, m)
            asinvcsinv = asinvcsinv + h.asinvcsinv
            csinv = csinv + h.csinv
            csinvcsinv = csinvcsinv + h.csinvcsinv
            csinvrdsinv = csinvrdsinv + Rd * h.trUCU

    if lp is not None:
        out = schur_ops.lp_schur(lp, s_lp, m, with_m=with_m, col=col_lp)
        if with_m:
            M = M + out.M
        asinv = asinv + out.asinv
        trsas = trsas + out.trSAS
        tr_u = tr_u + out.trU
        if kind == "hsd":
            h = schur_ops.lp_hsd(lp, s_lp, m)
            asinvcsinv = asinvcsinv + h.asinvcsinv
            csinv = csinv + h.csinv
            csinvcsinv = csinvcsinv + h.csinvcsinv
            # LP CSinvRdSinv intentionally omitted (ref quirk,
            # hdsdp_conic_lp.c:315-327)

    return KKTOut(
        M=M,
        asinv=asinv,
        asinvrdsinv=schur_ops.bcast(Rd, 1) * trsas,
        asinvcsinv=asinvcsinv,
        csinv=csinv,
        csinvcsinv=csinvcsinv,
        csinvrdsinv=csinvrdsinv,
        trace_sinv=tr_u,
    )


def build_kkt(groups, lp, L, s_lp, Rd, m: int, kind: str, hp: bool = False,
              col_groups=None, col_lp=None, rows: Optional[int] = None) -> KKTOut:
    """kind in {"inf", "hsd", "corr"} ~ KKT_TYPE_* (ref hdsdp_conic.h:16-19).

    ``col_groups``/``col_lp``/``rows``: the whole cones when ``groups`` and
    ``lp`` are row views of ``rows`` constraints (the row-sharded mesh
    assembly, parallel.schur.RowShardedConeSystem); see _kkt_terms."""
    Us = (chol_ops.chol_inverse(Lg, use_dd=hp) for Lg in L)
    return _kkt_terms(groups, lp, Us, s_lp, Rd, m, kind, kind != "corr", hp,
                      col_groups=col_groups, col_lp=col_lp, rows=rows)


def build_kkt_rhs(groups, lp, Us, s_lp, Rd, m: int, kind: str) -> KKTOut:
    """RHS-only KKT build from precomputed inverses: the matrix-free
    analogue of build_kkt (M stays None; the counterpart of the
    reference's sparse-Schur decision at hdsdp_schur.c:60,227)."""
    return _kkt_terms(groups, lp, Us, s_lp, Rd, m, kind, False, False)


# ----------------------------------------------------------------------
# matrix-free Schur operator: matvec, diagonal, row chunks, PCG
# ----------------------------------------------------------------------


def kkt_diag(groups, lp, Us, s_lp, m: int) -> torch.Tensor:
    """Exact diag(M) for the Jacobi preconditioner of the operator path."""
    d = None
    for ga, U in zip(groups, Us):
        t = schur_ops.group_schur_diag(ga, U, m)
        d = t if d is None else d + t
    if lp is not None:
        t = schur_ops.lp_schur_diag(lp, s_lp)
        d = t if d is None else d + t
    return d


def kkt_matvec(groups, lp, Us, s_lp, extra_diag, V, m: int) -> torch.Tensor:
    """M @ V for [m, k] V through the per-bucket operators, one column at
    a time (k is 1-4 at every caller), so a column's product does not
    depend on its neighbours.  extra_diag [m] carries the bound-cone
    diagonal and the regularization."""
    cols = []
    for v in V.unbind(1):
        out = extra_diag * v
        for ga, U in zip(groups, Us):
            out = out + schur_ops.group_schur_matvec(ga, U, v, m)
        if lp is not None:
            out = out + schur_ops.lp_schur_matvec(lp, s_lp, v)
        cols.append(out)
    return torch.stack(cols, dim=1)


# The PCG loop reads its exit flag on the host once every this many
# steps: converged columns are frozen by the ``live`` mask, so the steps
# taken past convergence change neither X nor R, and the step count is
# kept on the device.
PCG_CHECK_EVERY = 4


def pcg_body(mv, papply, B, abs_tol, rel_tol, max_iter: int,
             check_every: int = PCG_CHECK_EVERY):
    """Shared PCG recurrence of the matrix-free operator: k independent
    right-hand sides with per-column recurrences (ref conjGradSolve,
    hdsdp_linsolver.c:1446-1588).  ``papply`` is the preconditioner
    application R -> P^-1 R.  Returns (X, column norms of the residual,
    steps as a 0-dim int tensor); the steps count as in a loop that tests
    ``any(res > tol)`` before each one, whatever ``check_every`` is."""
    bnorm = torch.linalg.vector_norm(B, dim=0)
    tol = torch.clamp(rel_tol * bnorm, min=abs_tol)
    zero = torch.zeros((), dtype=B.dtype, device=B.device)
    one = torch.ones((), dtype=B.dtype, device=B.device)
    X = torch.zeros_like(B)
    R = B
    Z = papply(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    n_it = torch.zeros((), dtype=torch.int64, device=B.device)
    it = 0
    while it < max_iter:
        res = torch.linalg.vector_norm(R, dim=0)
        over = res > tol
        active = over.any()
        if it % check_every == 0:
            profile.count("host_reads")
            if not bool(active):
                break
        n_it = n_it + active
        live = over.to(B.dtype)
        Q = mv(P)
        pq = torch.sum(P * Q, dim=0)
        alpha = torch.where(pq > 0, rz / torch.where(pq == 0, one, pq), zero) * live
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * Q
        Z = papply(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = torch.where(rz > 0, rz_new / torch.where(rz == 0, one, rz), zero)
        P = Z + beta[None, :] * P
        rz = rz_new
        it += 1
    return X, torch.linalg.vector_norm(R, dim=0), n_it


def kkt_pcg(groups, lp, Us, s_lp, extra_diag, pinv, B, m: int, abs_tol: float,
            rel_tol: float, max_iter: int, check_every: int = PCG_CHECK_EVERY):
    """Jacobi-preconditioned CG on the matrix-free Schur operator (the
    Jacobi branch of conjGradSolve).  Returns (X, resnorm [k], steps)."""

    def mv(V):
        return kkt_matvec(groups, lp, Us, s_lp, extra_diag, V, m)

    return pcg_body(mv, lambda R: pinv[:, None] * R, B, abs_tol, rel_tol,
                    max_iter, check_every)


def kkt_pcg_chol(groups, lp, Us, s_lp, extra_diag, Linv, s, B, m: int,
                 abs_tol: float, rel_tol: float, max_iter: int,
                 check_every: int = PCG_CHECK_EVERY):
    """Cholesky-preconditioned CG on the matrix-free operator.  ``Linv``
    is the inverted equilibrated f32 factor of a (possibly STALE,
    ADPCG-style) chunk-materialized M; applying it is two f32 products.
    CG polishes the f32 and staleness error: for kappa(M) ~ 1e10 the
    preconditioned system has kappa ~ 1 + eps_f32 * kappa ~ 1e3, tens of
    steps where the Jacobi path stalls for thousands (ref conjGradSolve's
    Cholesky branch + the ADPCG refresh policy,
    hdsdp_linsolver.c:1446-1588)."""

    def mv(V):
        return kkt_matvec(groups, lp, Us, s_lp, extra_diag, V, m)

    def papply(R):
        Rf = (s[:, None] * R).to(Linv.dtype)
        T = Linv.T @ (Linv @ Rf)
        return s[:, None] * T.to(B.dtype)

    return pcg_body(mv, papply, B, abs_tol, rel_tol, max_iter, check_every)


def chunk_starts(m: int, chunk: int):
    """Row starts of the chunked KKT builds: multiples of ``chunk`` and,
    where they do not reach m, a last chunk at m - chunk that overlaps
    the one before (every chunk has the same height)."""
    i0s = list(range(0, m - chunk + 1, chunk))
    if not i0s or i0s[-1] + chunk < m:
        i0s.append(m - chunk)
    return i0s


def kkt_rows(groups, lp, Us, s_lp, bound_extra, i0: int, m: int, chunk: int) -> torch.Tensor:
    """Rows [i0, i0+chunk) of the full KKT matrix (SDP groups + LP +
    the diagonal bound/regularization terms), [chunk, m] f64."""
    out = None
    for ga, U in zip(groups, Us):
        r = schur_ops.group_schur_rows(ga, U, i0, chunk, m)
        if r is None:
            raise ValueError("kkt_rows on a flat group: check kkt_rows_supported first")
        out = r if out is None else out + r
    if lp is not None:
        r = schur_ops.lp_schur_rows(lp, s_lp, i0, chunk)
        out = r if out is None else out + r
    torch.diagonal(out, offset=i0).add_(bound_extra[i0:i0 + chunk])
    return out


def interior_check(groups, lp, dC, scal, y, dEye, tau, lo, up, hp: bool = False,
                   dd: bool = False):
    """Assemble + factor + bound slacks; flags = [cones ok, bound ok] as
    one bool tensor, so the caller reads both with one host sync."""
    S, s_lp = assemble(groups, lp, dC, scal, y, dEye, hp=hp)
    ok, L = factor(S, s_lp, dd=dd)
    sl = y - schur_ops.bcast(tau * lo, 1)
    su = schur_ops.bcast(tau * up, 1) - y
    bok = torch.all(sl > 0, dim=-1) & torch.all(su > 0, dim=-1)
    flags = torch.stack([ok.to(bok.device), bok])
    return S, s_lp, L, sl, su, flags


def atx(groups, lp, X_list, x_lp, m: int):
    out = None
    for ga, X in zip(groups, X_list):
        t = schur_ops.group_atx(ga, X, m)
        out = t if out is None else out + t
    if lp is not None:
        t = lp.A @ x_lp
        out = t if out is None else out + t
    return out


def ctx(groups, lp, X_list, x_lp):
    val = 0.0
    for ga, X in zip(groups, X_list):
        val = val + torch.sum(ga.C * X)
    if lp is not None:
        val = val + lp.c @ x_lp
    return val


# ----------------------------------------------------------------------
# cone system wrapper
# ----------------------------------------------------------------------


class ConeSystem:
    """Holds the device-side cone data and the cone operations."""

    def __init__(self, prob: SDPProblem, device, obj_scal: float = 1.0,
                 layout: str = "auto", dtype=DTYPE):
        """layout: "auto" stores single-block groups slot-major with the
        diag/support gather specializations and multi-block groups flat;
        "slot" keeps slot-major but disables the specializations, and
        "flat" forces the packed-slot layout on every group (both for
        holding one bucket against another).

        dtype: the dtype of the cone data (Params.dtype).  With float32
        data an operation whose other operands are float64 (or a numpy
        float64 scalar) computes in float64 with the data widened, as the
        JAX package's promotion does (``_data``)."""
        if layout not in ("auto", "slot", "flat"):
            raise ValueError(f"layout={layout!r}")
        self.m = prob.m
        specialize = layout == "auto"
        self.device = torch.device(device)
        self.dtype = dtype
        self._wide = {}  # float64 copies of float32 data, made on first use
        dev = self.device

        def _slot_major(g):
            """Slot-major low-rank layout for single-block groups:
            Fs[j, i] = j-th eigenvector of A_i (presolve copied from the
            JAX package, including the specialization choice)."""
            m = prob.m
            lam0 = np.asarray(g.lam[0])
            seg0 = np.asarray(g.seg[0])
            F0 = np.asarray(g.F[0])
            nz = np.nonzero(lam0 != 0.0)[0]
            counts = np.bincount(seg0[nz], minlength=m) if len(nz) else np.zeros(m, int)
            r = max(int(counts.max()) if len(counts) else 0, 1)
            Fs = np.zeros((r, m, g.dim))
            lams = np.zeros((r, m))
            fill = np.zeros(m, np.int64)
            for idx in nz:
                i = seg0[idx]
                j = fill[i]
                fill[i] = j + 1
                Fs[j, i] = F0[idx]
                lams[j, i] = lam0[idx]

            dpos = dw = None
            spos = sval = None
            nnz_rows = np.count_nonzero(Fs, axis=2)  # [r, m]
            if not specialize:
                pass
            elif r == 1 and np.all(nnz_rows[0] <= 1):
                # DIAGONAL specialization (maxG*/torus* structure)
                p = np.argmax(np.abs(Fs[0]), axis=1)
                v = Fs[0][np.arange(m), p]
                if m == g.dim and np.array_equal(p, np.arange(m)):
                    dpos = np.zeros((0,), np.int64)  # identity-map marker
                else:
                    dpos = p
                dw = lams[0] * v * v
            elif (
                nnz_rows.max(initial=0) <= 4
                and (r * (r + 1) // 2)
                * int(nnz_rows.max(initial=1)) ** 2
                <= SUPPORT_TERM_BUDGET
            ):
                # bounded-support layout (theta family)
                c = max(int(nnz_rows.max(initial=1)), 1)
                spos = np.zeros((r, m, c), np.int64)
                sval = np.zeros((r, m, c))
                for j in range(r):
                    for i in np.nonzero(nnz_rows[j])[0]:
                        idx = np.nonzero(Fs[j, i])[0]
                        spos[j, i, : len(idx)] = idx
                        sval[j, i, : len(idx)] = Fs[j, i, idx]
            elif nnz_rows.max(initial=0) <= 4:
                logging.getLogger("hdsdp_tpu_torch").info(
                    "support bucket skipped: r=%d c=%d exceeds the "
                    "unrolled-term budget (%d); using slot-major",
                    r, int(nnz_rows.max(initial=1)), SUPPORT_TERM_BUDGET,
                )
            if dpos is not None or spos is not None:
                # the gather buckets read only Fs's shape
                Fs = np.zeros((Fs.shape[0], 1, g.dim))
            return Fs, lams, dpos, dw, spos, sval

        def _make_group(g):
            kw = dict(
                C=_tensor(g.C * obj_scal, dev, False, dtype),
                Ad=_tensor(g.Ad, dev, False, dtype),
                didx=_tensor(g.didx, dev, True),
                dblk=_tensor(g.dblk, dev, True),
            )
            if g.nblk == 1 and layout != "flat":
                Fs, lams, dpos, dw, spos, sval = _slot_major(g)
                return GroupArrays(
                    F=torch.zeros((1, 1, g.dim), dtype=dtype, device=dev),
                    lam=torch.zeros((1, 1), dtype=dtype, device=dev),
                    seg=torch.zeros((1, 1), dtype=torch.int64, device=dev),
                    pos=None,
                    Fs=_tensor(Fs, dev, False, dtype),
                    lams=_tensor(lams, dev, False, dtype),
                    dpos=_tensor(dpos, dev, True),
                    dw=_tensor(dw, dev, False, dtype),
                    spos=_tensor(spos, dev, True),
                    sval=_tensor(sval, dev, False, dtype),
                    **kw,
                )
            return GroupArrays(
                F=_tensor(g.F, dev, False, dtype),
                lam=_tensor(g.lam, dev, False, dtype),
                seg=_tensor(g.seg, dev, True),
                pos=None,
                **kw,
            )

        self.groups: Tuple[GroupArrays, ...] = tuple(
            schur_ops.with_tables(_make_group(g), prob.m) for g in prob.groups
        )
        self.group_dims = [g.dim for g in prob.groups]
        self.group_nblk = [g.nblk for g in prob.groups]

        self.has_lp = prob.lp is not None
        self.lp = (
            LPArrays(A=_tensor(prob.lp.A, dev, False, dtype),
                     c=_tensor(prob.lp.c * obj_scal, dev, False, dtype))
            if self.has_lp else None
        )

        # sum of SDP cone dims + LP dims (bound cone counted by the solver)
        self.sum_cone_dims = prob.sum_cone_dims
        self.n_cones = len(prob.block_dims) + (1 if self.has_lp else 0)
        self._lz_warm = None

    # double-single cone factor and interior checks (Params.cone_fp)
    cone_dd: bool = False
    # Ozaki-sliced Schur assembly for slot-major groups (Params.kkt_hp)
    kkt_hp: bool = False
    # Ozaki-sliced dual-slack assembly, engaged when r*m*n^2 is large
    dual_hp: bool = False
    ratio_mode: str = "auto"
    lanczos_dim: int = 30

    def _dt(self, *xs) -> torch.dtype:
        """The dtype of an operation of the cone data with ``xs``."""
        return jdtype(torch.empty(0, dtype=self.dtype), *xs)

    def _cast(self, key: str, value, dt):
        """``value`` (cone data: a NamedTuple of tensors, a tuple of them,
        or None) in dtype ``dt``: as stored, or its float64 copy, kept
        under ``key`` (float32 values widened exactly: what the JAX
        package's promotion computes with)."""
        if dt == self.dtype or value is None:
            return value
        if key not in self._wide:
            def wide(v):
                if isinstance(v, tuple) and not hasattr(v, "_fields"):
                    return tuple(wide(x) for x in v)
                return v._replace(**{k: x.to(dt) for k, x in v._asdict().items()
                                     if isinstance(x, torch.Tensor) and x.is_floating_point()})
            self._wide[key] = wide(value)
        return self._wide[key]

    def _data(self, dt):
        """(groups, lp) in dtype ``dt`` (``_cast``)."""
        return self._cast("groups", self.groups, dt), self._cast("lp", self.lp, dt)

    def data_for(self, *xs):
        """(groups, lp) in the dtype of an operation of the cone data with
        ``xs`` (the module-level functions take them as they are)."""
        return self._data(self._dt(*xs))

    def assemble(self, dC, scal, y, dEye):
        """B = dEye*I + scal*A'y + dC*C per cone."""
        dt = self._dt(y, dC, scal, dEye)
        groups, lp = self._data(dt)
        return assemble(groups, lp, dC, scal, y.to(dt), dEye, hp=self.dual_hp)

    def factor(self, S, s_lp):
        return factor(S, s_lp, dd=self.cone_dd)

    def logdet(self, L, s_lp):
        return logdet(L, s_lp)

    def build_kkt(self, L, s_lp, Rd, kind: str) -> KKTOut:
        dt = self._dt(*L, s_lp, Rd)
        groups, lp = self._data(dt)
        return build_kkt(groups, lp, jcast(dt, *L), jcast(dt, s_lp)[0], Rd, self.m, kind,
                         hp=self.kkt_hp)

    def inverses(self, L):
        """U = S^-1 per group."""
        return inverses(L, hp=self.kkt_hp)

    # -- matrix-free Schur operator (sparse-Schur analogue) ---------------
    def _op_args(self, Us, s_lp, *more):
        """(groups, lp, Us, s_lp, *more) in the dtype of the operation."""
        dt = self._dt(*Us, s_lp, *more)
        return (*self._data(dt), jcast(dt, *Us), *jcast(dt, s_lp, *more))

    def build_kkt_rhs(self, Us, s_lp, Rd, kind: str) -> KKTOut:
        """KKT RHS vectors only, M never materialized (operator mode)."""
        groups, lp, Us, s_lp = self._op_args(Us, s_lp, Rd)[:4]
        return build_kkt_rhs(groups, lp, Us, s_lp, Rd, self.m, kind)

    def kkt_diag(self, Us, s_lp):
        """Exact diag(M): the Jacobi preconditioner of operator mode."""
        groups, lp, Us, s_lp = self._op_args(Us, s_lp)
        return kkt_diag(groups, lp, Us, s_lp, self.m)

    def kkt_matvec(self, Us, s_lp, extra_diag, V):
        """M @ V ([m, k]) through the per-bucket operators."""
        groups, lp, Us, s_lp, extra_diag, V = self._op_args(Us, s_lp, extra_diag, V)
        return kkt_matvec(groups, lp, Us, s_lp, extra_diag, V, self.m)

    def kkt_pcg(self, Us, s_lp, extra_diag, pinv, B, abs_tol=1e-10,
                rel_tol=1e-10, max_iter=600):
        """Jacobi-PCG solve of M X = B on the operator."""
        groups, lp, Us, s_lp, extra_diag, pinv, B = self._op_args(Us, s_lp, extra_diag,
                                                                   pinv, B)
        return kkt_pcg(groups, lp, Us, s_lp, extra_diag, pinv, B,
                       self.m, abs_tol, rel_tol, max_iter)

    def kkt_pcg_chol(self, Us, s_lp, extra_diag, Linv, s, B, abs_tol=1e-10,
                     rel_tol=1e-10, max_iter=600):
        """Cholesky-preconditioned CG on the operator (stale f32 factor
        of a chunk-materialized M; see kkt_pcg_chol)."""
        groups, lp, Us, s_lp, extra_diag, s, B = self._op_args(Us, s_lp, extra_diag, s, B)
        return kkt_pcg_chol(groups, lp, Us, s_lp, extra_diag, Linv,
                            s, B, self.m, abs_tol, rel_tol, max_iter)

    def kkt_rows_supported(self) -> bool:
        """True when every group is row-chunkable (slot-major layout,
        dense slots allowed), so that the f32 preconditioner can be
        materialized in chunks."""
        return all(ga.Fs is not None for ga in self.groups)

    def kkt_rows(self, Us, s_lp, bound_extra, i0: int, chunk: int):
        """Rows [i0, i0+chunk) of the full KKT matrix, [chunk, m]."""
        groups, lp, Us, s_lp, bound_extra = self._op_args(Us, s_lp, bound_extra)
        return kkt_rows(groups, lp, Us, s_lp, bound_extra, i0,
                        self.m, chunk)

    def kkt_full_from_rows(self, Us, s_lp, bound_extra, chunk: int = 2048):
        """The full [m, m] KKT matrix assembled from row chunks, for
        factor-once consumers (PSDP) at sizes where the temporaries of
        the one-piece build would crowd the device.  It is stored in the
        cone data's dtype, as the JAX package stores it."""
        m = self.m
        chunk = min(chunk, m)
        M = torch.empty((m, m), dtype=self.dtype, device=self.device)
        for i0 in chunk_starts(m, chunk):
            M[i0:i0 + chunk] = self.kkt_rows(Us, s_lp, bound_extra, i0, chunk)
        return M

    def interior_check(self, dC, scal, y, dEye, tau, lo, up):
        dt = self._dt(y, dC, scal, dEye)
        groups, lp = self._data(dt)
        return interior_check(groups, lp, dC, scal, y.to(dt), dEye, tau,
                              lo, up, hp=self.dual_hp, dd=self.cone_dd)

    def ratio_test(self, L, s_lp, dS, ds_lp):
        """Max alpha with S + alpha*dS >= 0 over all cones (ref
        HConeRatioTest; LP part per hdsdp_conic_lp.c:228-243).

        Lanczos warm starts are carried across calls (ref
        HLanczos->dLanczosWarmStart)."""
        warms = self._lz_warm
        if warms is None or len(warms) != len(L):
            warms = (None,) * len(L)
        step = None
        new_warms = []
        for Lg, dSg, w in zip(L, dS, warms):
            steps, warm = ratio_ops.block_ratio(
                Lg, dSg, mode=self.ratio_mode, krylov=self.lanczos_dim,
                v0=w, return_warm=True,
            )
            new_warms.append(warm)
            sg = torch.min(steps)
            step = sg if step is None else torch.minimum(step, sg)
        if s_lp is not None:
            sl = ratio_ops.vector_ratio_test(s_lp, ds_lp)
            step = sl if step is None else torch.minimum(step, sl)
        self._lz_warm = tuple(new_warms)
        return torch.clamp(step, max=INF) if step is not None else INF

    def add_step_check(self, S, s_lp, dS, ds_lp, alpha):
        S_new = tuple(a + alpha * b for a, b in
                      (jlift(Sg, dSg, by=(alpha,)) for Sg, dSg in zip(S, dS)))
        s_new = None
        if s_lp is not None:
            s_lp, ds_lp = jlift(s_lp, ds_lp, by=(alpha,))
            s_new = s_lp + alpha * ds_lp
        ok, Lnew = factor(S_new, s_new, dd=self.cone_dd)
        return ok, S_new, s_new, Lnew

    def atx(self, X_list, x_lp):
        """A(X) over all cones."""
        groups, lp = self.data_for(*X_list, x_lp)
        return atx(groups, lp, tuple(X_list), x_lp, self.m)

    def ctx(self, X_list, x_lp):
        """<C, X> over all cones."""
        groups, lp = self.data_for(*X_list, x_lp)
        return ctx(groups, lp, tuple(X_list), x_lp)
