"""Row-sharded Schur-complement assembly over a mesh (port of the JAX
package's parallel/schur.py).

Two cone systems, chosen by ``DualIPM`` as the JAX package chooses them:

* ``RowShardedConeSystem`` (every group a single block, slot-major): each
  rank cuts the constraint-indexed arrays to its block of rows (``row_view``)
  and builds exactly those rows of M against the whole groups (the
  ``col=`` views of ops.schur), with no communication for M itself.  The
  JAX package gets the same partition from GSPMD
  (``with_sharding_constraint``); here it is explicit.
* ``ShardedConeSystem`` (multi-block groups, flat layout, LP on rank 0):
  each rank takes its share of the packed slots, builds partial sums of
  S (combined by all_reduce) and of M (combined by reduce_scatter into
  row blocks, the identity tail added once, by rank 0).

Either way M leaves the build as a ``RowShard``: this rank's rows of the
identity-tailed [m_pad, m_pad] matrix, m_pad the next multiple of the
mesh size, and no rank ever holds every row.  The vectors (ASinv, ...)
and scalars come out whole on every rank.  Factors, ratio tests and
barrier values run on every rank alike, on replicated inputs.

The matrix-free Schur operator composes with the mesh through
``_ShardedOperatorMixin``: rank d forms its rows of U W U (W = sum_j v_j
A_j, replicated), takes the partial inner products <A_i, .> over those
rows, and one all_reduce sums them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hdsdp_tpu_torch.ops import chol as chol_ops
from hdsdp_tpu_torch.ops import schur as schur_ops
from hdsdp_tpu_torch.ops.schur import GroupArrays, LPArrays, gather_table
from hdsdp_tpu_torch.solver import cones as cone_ops
from hdsdp_tpu_torch.solver.cones import ConeSystem, KKTOut
from hdsdp_tpu_torch.utils.device import DTYPE, jcast, jdtype


# ----------------------------------------------------------------------
# the row-sharded matrix
# ----------------------------------------------------------------------


class RowShard:
    """This rank's rows [row0, row0 + n / size) of a row-sharded [n, n]
    matrix whose first m rows and columns are the system and whose tail
    is the identity.  Nothing here reads another rank's rows except
    through a collective of the mesh."""

    def __init__(self, local: torch.Tensor, row0: int, n: int, m: int, mesh):
        self.local = local
        self.row0 = row0
        self.n = n
        self.m = m
        self.mesh = mesh

    @property
    def mloc(self) -> int:
        return self.local.shape[0]

    def _true_rows(self) -> int:
        return max(0, min(self.mloc, self.m - self.row0))

    def local_diag(self) -> torch.Tensor:
        return torch.diagonal(self.local, offset=self.row0)

    def plus_diag(self, d, true_rows: bool = False) -> "RowShard":
        """A new shard of M + diag(d): d a number or an [n] (or [m]) vector;
        ``true_rows`` leaves the identity tail alone.  A float64 d widens
        a float32 shard, as the JAX package's sum does."""
        out = self.local.to(jdtype(self.local, d), copy=True)
        diag = torch.diagonal(out, offset=self.row0)
        k = self._true_rows() if true_rows else self.mloc
        if isinstance(d, torch.Tensor):
            seg = d[self.row0:self.row0 + k]
            diag[:seg.shape[0]] += seg
        else:
            diag[:k] += d
        return RowShard(out, self.row0, self.n, self.m, self.mesh)

    def max_diag(self, true_rows: bool = False) -> float:
        d = self.local_diag()
        if true_rows:
            d = d[:self._true_rows()]
        loc = torch.max(d) if d.numel() else torch.tensor(-np.inf, dtype=d.dtype, device=d.device)
        return float(self.mesh.all_reduce(loc.reshape(1), op="max")[0])

    def min_diag(self) -> float:
        """min over the system's rows (the tail excluded)."""
        d = self.local_diag()[:self._true_rows()]
        loc = torch.min(d) if d.numel() else torch.tensor(np.inf, dtype=d.dtype, device=d.device)
        return float(self.mesh.all_reduce(loc.reshape(1), op="min")[0])

    def diag(self) -> torch.Tensor:
        """The whole diagonal [n] on every rank (one all_gather)."""
        return self.mesh.all_gather(self.local_diag().contiguous())

    def gather(self) -> torch.Tensor:
        """The whole [n, n] (for checks; the solver never calls it)."""
        return self.mesh.all_gather(self.local)

    @classmethod
    def from_full(cls, mesh, M: torch.Tensor) -> "RowShard":
        """This rank's rows of a replicated [m, m] matrix, padded to the next
        multiple of the mesh size with an identity tail."""
        m = M.shape[0]
        n = -(-m // mesh.size) * mesh.size
        mloc = n // mesh.size
        row0 = mesh.rank * mloc
        return cls(_tailed_rows(M[row0:min(row0 + mloc, m)], row0, mloc, m, n),
                   row0, n, m, mesh)


def _tailed_rows(rows_m: torch.Tensor, row0: int, mloc: int, m: int, n: int) -> torch.Tensor:
    """[mloc, n] rows row0.. of the identity-tailed [n, n] matrix whose
    first m rows are given (rows_m [k, m], k <= mloc, the rows below m)."""
    out = torch.zeros((mloc, n), dtype=rows_m.dtype, device=rows_m.device)
    out[:rows_m.shape[0], :m] = rows_m
    tail = torch.arange(max(row0, m), max(row0 + mloc, m), device=rows_m.device)
    out[tail - row0, tail] = 1.0
    return out


# ----------------------------------------------------------------------
# the matrix-free operator on a mesh
# ----------------------------------------------------------------------


def _row_block(n: int, rank: int, size: int):
    """[n0, n1): rank's contiguous block of n rows (possibly empty)."""
    nloc = -(-n // size)
    n0 = min(rank * nloc, n)
    return n0, min(n0 + nloc, n)


class _ShardedOperatorMixin:
    """The matrix-free Schur operator over the mesh: each rank forms its
    rows of U W U per group (W = sum_j v_j A_j, the same on every rank)
    and the partial inner products <A_i, .> over those rows
    (ops.schur.group_schur_matvec_rows), and one all_reduce sums the
    partials.  M never materializes anywhere; the memory contract of
    operator mode survives the mesh.  The PCG runs on replicated vectors
    on every rank alike."""

    def kkt_matvec(self, Us, s_lp, extra_diag, V):
        m = self.m
        groups, lp, Us, s_lp, extra_diag, V = self._op_args(Us, s_lp, extra_diag, V)
        parts = []
        for v in V.unbind(1):
            out = torch.zeros(m, dtype=V.dtype, device=V.device)
            for ga, U in zip(groups, Us):
                n0, n1 = _row_block(U.shape[-1], self.mesh.rank, self.mesh.size)
                out = out + schur_ops.group_schur_matvec_rows(ga, U, v, m, n0, n1)
            parts.append(out)
        out = extra_diag[:, None] * V + self.mesh.all_reduce(torch.stack(parts, dim=1))
        if lp is not None:
            out = out + torch.stack(
                [schur_ops.lp_schur_matvec(lp, s_lp, v) for v in V.unbind(1)], dim=1)
        return out

    def kkt_pcg(self, Us, s_lp, extra_diag, pinv, B, abs_tol=1e-10, rel_tol=1e-10,
                max_iter=600):
        _, _, Us, s_lp, extra_diag, pinv, B = self._op_args(Us, s_lp, extra_diag, pinv, B)
        return cone_ops.pcg_body(
            lambda V: self.kkt_matvec(Us, s_lp, extra_diag, V),
            lambda R: pinv[:, None] * R, B, abs_tol, rel_tol, max_iter)

    def kkt_pcg_chol(self, Us, s_lp, extra_diag, Linv, s, B, abs_tol=1e-10,
                     rel_tol=1e-10, max_iter=600):
        _, _, Us, s_lp, extra_diag, s, B = self._op_args(Us, s_lp, extra_diag, s, B)

        def papply(R):
            Rf = (s[:, None] * R).to(Linv.dtype)
            return s[:, None] * (Linv.T @ (Linv @ Rf)).to(B.dtype)

        return cone_ops.pcg_body(
            lambda V: self.kkt_matvec(Us, s_lp, extra_diag, V), papply, B,
            abs_tol, rel_tol, max_iter)


# ----------------------------------------------------------------------
# row-sharded cone system (slot-major, single-block groups)
# ----------------------------------------------------------------------


def row_view(ga: GroupArrays, r0: int, r1: int) -> GroupArrays:
    """The rows [r0, r1) of a slot-major group: every constraint-indexed
    array cut to them (the diag bucket's identity map made explicit), the
    dense coefficients of those rows kept with their didx shifted by r0.
    Built for ``group_schur(view, U, m, col=ga)`` and ``group_hsd``; the
    summation tables, which only the dual assembly reads, are dropped."""
    rep = dict(lams=ga.lams[:, r0:r1], dtab=None, scell=None, stab=None)
    kind = schur_ops.bucket(ga)
    dev = ga.C.device
    if kind == "slot":
        rep["Fs"] = ga.Fs[:, r0:r1]
    elif kind == "diag":
        rep["dw"] = ga.dw[r0:r1]
        rep["dpos"] = (torch.arange(r0, r1, device=dev) if ga.dpos.shape[0] == 0
                       else ga.dpos[r0:r1])
    elif kind == "support":
        rep["spos"] = ga.spos[:, r0:r1]
        rep["sval"] = ga.sval[:, r0:r1]
    else:
        raise ValueError("row views are for slot-major groups")
    mine = (ga.didx >= r0) & (ga.didx < r1)
    rep.update(Ad=ga.Ad[mine], didx=ga.didx[mine] - r0, dblk=ga.dblk[mine])
    return ga._replace(**rep)


class RowShardedConeSystem(_ShardedOperatorMixin, ConeSystem):
    """Constraint-row-sharded assembly for single-block groups.

    The slot-major layout indexes the low-rank factors by constraint, so
    each rank computes exactly its own rows of the Schur matrix

        M[rows_d, :] = sum_{j,k} (lams_j[rows_d] x lams_k) (Fs_j[rows_d] U Fs_k^T)^2

    (and the diag / bounded-support / dense equivalents) against the
    whole groups, with no communication for M; one all_gather per build
    makes the vectors whole.  Under ``kkt_hp`` each rank's Ozaki products
    take its row block; their operand exponents are per row, so the
    rows equal the single-device rows bit for bit."""

    is_row_sharded = True

    def __init__(self, prob, mesh, obj_scal: float = 1.0, dtype=DTYPE):
        super().__init__(prob, mesh.device, obj_scal=obj_scal, layout="auto", dtype=dtype)
        if any(ga.Fs is None for ga in self.groups):
            raise ValueError("RowShardedConeSystem requires single-block groups "
                             "(slot-major layout); use ShardedConeSystem instead")
        self.mesh = mesh
        self.ndev = mesh.size
        m = self.m
        self.m_pad = -(-m // self.ndev) * self.ndev
        self.mloc = self.m_pad // self.ndev
        self.row0 = mesh.rank * self.mloc
        r0, r1 = min(self.row0, m), min(self.row0 + self.mloc, m)
        self.rows = r1 - r0
        if self.rows == 0:
            # no system row here (m < m_pad - mloc): build a one-row view
            # to keep the scalars, and drop its rows
            r0, r1 = m - 1, m
        self.row_groups = tuple(row_view(ga, r0, r1) for ga in self.groups)
        self.row_lp = (LPArrays(A=self.lp.A[r0:r1], c=self.lp.c)
                       if self.lp is not None else None)

    def build_kkt(self, L, s_lp, Rd, kind: str) -> KKTOut:
        k = max(self.rows, 1)
        dt = self._dt(*L, s_lp, Rd)
        groups, lp = self._data(dt)
        out = cone_ops.build_kkt(self._cast("row_groups", self.row_groups, dt),
                                 self._cast("row_lp", self.row_lp, dt), jcast(dt, *L),
                                 jcast(dt, s_lp)[0], Rd, self.m, kind, hp=self.kkt_hp,
                                 col_groups=groups, col_lp=lp, rows=k)
        keep = self.rows
        vecs = [out.asinv, out.asinvrdsinv] + ([out.asinvcsinv] if kind == "hsd" else [])
        V = torch.stack(vecs, dim=1)[:keep]
        V = self.mesh.all_gather(torch.nn.functional.pad(V, (0, 0, 0, self.mloc - keep)))[:self.m]
        M = None
        if out.M is not None:
            M = RowShard(_tailed_rows(out.M[:keep], self.row0, self.mloc, self.m, self.m_pad),
                         self.row0, self.m_pad, self.m, self.mesh)
        return out._replace(M=M, asinv=V[:, 0], asinvrdsinv=V[:, 1],
                            asinvcsinv=V[:, 2] if kind == "hsd" else None)

    def primal_kkt(self, X_list) -> RowShard:
        """This rank's rows of M_ij = sum tr(A_i X A_j X) (PSDP's
        X-weighted system; X in place of S^-1), identity-tailed."""
        k = max(self.rows, 1)
        dt = self._dt(*X_list)
        M = torch.zeros((k, self.m), dtype=dt, device=self.device)
        for ga, cg, X in zip(self._cast("row_groups", self.row_groups, dt),
                             self._data(dt)[0], X_list):
            M = M + schur_ops.group_schur(ga, X, self.m, with_m=True, hp=self.kkt_hp, col=cg).M
        return RowShard(_tailed_rows(M[:self.rows], self.row0, self.mloc, self.m, self.m_pad),
                        self.row0, self.m_pad, self.m, self.mesh)


# ----------------------------------------------------------------------
# slot-partitioned cone system (multi-block groups, flat layout)
# ----------------------------------------------------------------------


def _pad0(t: torch.Tensor, dim: int, target: int) -> torch.Tensor:
    pad = target - t.shape[dim]
    if pad <= 0:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)], dim=dim)


def pad_group(ga: GroupArrays, ndev: int) -> GroupArrays:
    """Pad the slot axis R and the dense axis md to multiples of ndev
    (zero weight: the padding adds nothing); tables are rebuilt by the
    caller (``with_tables``)."""
    R = ga.F.shape[1]
    Rp = max(-(-R // ndev) * ndev, ndev)
    md = ga.Ad.shape[0]
    mdp = -(-md // ndev) * ndev if md else 0
    return GroupArrays(
        C=ga.C, F=_pad0(ga.F, 1, Rp), lam=_pad0(ga.lam, 1, Rp), seg=_pad0(ga.seg, 1, Rp),
        Ad=_pad0(ga.Ad, 0, mdp), didx=_pad0(ga.didx, 0, mdp), dblk=_pad0(ga.dblk, 0, mdp),
    )


class SlotShare(NamedTuple):
    """One rank's share of a padded flat group: its slots and dense
    coefficients, with the row tables of the share."""

    F: torch.Tensor  # [g, Rl, n]
    lam: torch.Tensor  # [g, Rl]
    seg: torch.Tensor  # [g, Rl]
    fall: torch.Tensor  # [m, k] over the share's g*Rl slots
    Ad: torch.Tensor  # [mdl, n, n]
    didx: torch.Tensor  # [mdl]
    dblk: torch.Tensor  # [mdl]
    xtab: Optional[torch.Tensor]  # [m, k] over the share's dense coefficients
    dsel: Optional[torch.Tensor]  # [g, mdl] 0/1


def slot_share(ga: GroupArrays, rank: int, ndev: int, m: int) -> SlotShare:
    Rl = ga.F.shape[1] // ndev
    sl = slice(rank * Rl, (rank + 1) * Rl)
    seg, lam = ga.seg[:, sl], ga.lam[:, sl]
    fall = torch.as_tensor(gather_table(seg.cpu().numpy(), m, lam.cpu().numpy() != 0.0),
                           device=ga.C.device)
    mdl = ga.Ad.shape[0] // ndev
    dsl = slice(rank * mdl, (rank + 1) * mdl)
    didx, dblk = ga.didx[dsl], ga.dblk[dsl]
    xtab = dsel = None
    if mdl:
        xtab = torch.as_tensor(gather_table(didx.cpu().numpy(), m), device=ga.C.device)
        g = ga.C.shape[0]
        dsel = (torch.arange(g, device=ga.C.device)[:, None] == dblk[None, :]).to(ga.C.dtype)
    return SlotShare(F=ga.F[:, sl], lam=lam, seg=seg, fall=fall, Ad=ga.Ad[dsl], didx=didx,
                     dblk=dblk, xtab=xtab, dsel=dsel)


def _group_dual_part(sh: SlotShare, g: int, n: int, scal, y) -> torch.Tensor:
    """This rank's partial of scal * A'y for one group, [g, n, n]."""
    w = sh.lam * y[sh.seg]
    W = (w[..., None] * sh.F).mT @ sh.F
    mdl = sh.Ad.shape[0]
    if mdl:
        W = W + ((sh.dsel * y[sh.didx][None, :]) @ sh.Ad.reshape(mdl, n * n)).reshape(g, n, n)
    return scal * W


def _group_schur_part(ga: GroupArrays, sh: SlotShare, U: torch.Tensor, m: int, with_m: bool):
    """This rank's partials (M [m, m] or None, asinv, trSAS) of one group."""
    FU = sh.F @ U  # [g, Rl, n]
    asinv = schur_ops._table_sum((sh.lam * torch.sum(FU * sh.F, dim=-1)).reshape(-1), sh.fall)
    trsas = schur_ops._table_sum((sh.lam * torch.sum(FU * FU, dim=-1)).reshape(-1), sh.fall)
    M = None
    if with_m:
        # the share's rows x all columns of the low-rank Gram: every
        # ordered pair once over the ranks
        W = FU @ ga.F.mT  # [g, Rl, R]
        Q = (sh.lam[:, :, None] * ga.lam[:, None, :]) * (W * W)
        M = schur_ops.accumulate_m(ga, Q, m, fall=sh.fall)
    mdl = sh.Ad.shape[0]
    if mdl:
        Ub = U[sh.dblk]
        B = Ub @ sh.Ad @ Ub
        asinv = asinv + schur_ops._table_sum(torch.sum(sh.Ad * Ub, dim=(-1, -2)), sh.xtab)
        trsas = trsas + schur_ops._table_sum(
            torch.diagonal(B, dim1=-2, dim2=-1).sum(-1), sh.xtab)
        if with_m:
            md = ga.Ad.shape[0]
            same = (sh.dblk[:, None] == ga.dblk[None, :]).to(U.dtype)
            Mdd = (B.reshape(mdl, -1) @ ga.Ad.reshape(md, -1).mT) * same  # [mdl, md]
            M = M + schur_ops._table_sum(schur_ops._table_sum(Mdd, ga.xtab).mT, sh.xtab).mT
            # dense x low-rank cross terms, both orientations, from the
            # rank that owns the dense coefficient
            cross = ga.lam[sh.dblk] * schur_ops._quadforms(ga.F[sh.dblk], B)  # [mdl, R]
            k = ga.ftab.shape[-1]
            cols = torch.gather(torch.nn.functional.pad(cross, (0, 1)), -1,
                                ga.ftab[sh.dblk].reshape(mdl, m * k)).reshape(mdl, m, k).sum(-1)
            Mx = schur_ops._table_sum(cols.mT, sh.xtab).mT
            M = M + Mx + Mx.mT
    return M, asinv, trsas


def _group_hsd_part(sh: SlotShare, T: torch.Tensor) -> torch.Tensor:
    """This rank's partial of ASinvCSinv given T = U C U."""
    out = schur_ops._table_sum((sh.lam * schur_ops._quadforms(sh.F, T)).reshape(-1), sh.fall)
    if sh.Ad.shape[0]:
        out = out + schur_ops._table_sum(torch.sum(sh.Ad * T[sh.dblk], dim=(-1, -2)), sh.xtab)
    return out


class ShardedConeSystem(_ShardedOperatorMixin, ConeSystem):
    """ConeSystem whose dual assembly and KKT build are partitioned over
    the mesh by slot (multi-block groups, flat layout): the packed slot
    axis R and the dense axis md are padded to multiples of the mesh size
    and each rank contracts its share against the whole (replicated)
    groups.  S is combined by all_reduce; M by reduce_scatter into row
    blocks of the identity-tailed [m_pad, m_pad], the tail added once, by
    rank 0, as are the LP cone and the scalars.  Everything else of the
    ConeSystem (interior checks, factors, ratio tests) runs on every rank
    alike on the padded groups."""

    is_row_sharded = True

    def __init__(self, prob, mesh, obj_scal: float = 1.0, dtype=DTYPE):
        super().__init__(prob, mesh.device, obj_scal=obj_scal, layout="flat", dtype=dtype)
        self.mesh = mesh
        self.ndev = mesh.size
        m = self.m
        self.groups = tuple(schur_ops.with_tables(pad_group(ga, self.ndev), m)
                            for ga in self.groups)
        self.shares = tuple(slot_share(ga, mesh.rank, self.ndev, m) for ga in self.groups)
        self.m_pad = -(-m // self.ndev) * self.ndev
        self.mloc = self.m_pad // self.ndev
        self.row0 = mesh.rank * self.mloc

    def assemble(self, dC, scal, y, dEye):
        dt = self._dt(y, dC, scal, dEye)
        groups, lp = self._data(dt)
        y = y.to(dt)
        parts = [_group_dual_part(sh, ga.C.shape[0], ga.C.shape[-1], scal, y)
                 for ga, sh in zip(groups, self._cast("shares", self.shares, dt))]
        if parts:
            flat = self.mesh.all_reduce(torch.cat([p.reshape(-1) for p in parts]))
            parts = torch.split(flat, [p.numel() for p in parts])
        S = []
        for Wp, ga in zip(parts, groups):
            n = ga.C.shape[-1]
            eye = torch.eye(n, dtype=ga.C.dtype, device=ga.C.device)
            S.append(Wp.reshape(ga.C.shape) + dC * ga.C + dEye * eye)
        s_lp = schur_ops.lp_dual(lp, dC, scal, y, dEye) if lp is not None else None
        return tuple(S), s_lp

    def build_kkt(self, L, s_lp, Rd, kind: str) -> KKTOut:
        m, dev = self.m, self.device
        dt = self._dt(*L, s_lp, Rd)
        groups, lp = self._data(dt)
        shares = self._cast("shares", self.shares, dt)
        L, s_lp = jcast(dt, *L), jcast(dt, s_lp)[0]
        is0 = self.mesh.rank == 0
        with_m = kind != "corr"
        M = torch.zeros((m, m), dtype=dt, device=dev) if with_m else None
        asinv = torch.zeros(m, dtype=dt, device=dev)
        trsas = torch.zeros(m, dtype=dt, device=dev)
        asinvcsinv = torch.zeros(m, dtype=dt, device=dev)
        zero = torch.zeros((), dtype=dt, device=dev)
        tr_u = csinv = csinvcsinv = csinvrdsinv = zero
        for ga, sh, Lg in zip(groups, shares, L):
            U = chol_ops.chol_inverse(Lg)
            Mp, ap, tp = _group_schur_part(ga, sh, U, m, with_m)
            if with_m:
                M = M + Mp
            asinv = asinv + ap
            trsas = trsas + tp
            if is0:
                tr_u = tr_u + torch.diagonal(U, dim1=-2, dim2=-1).sum()
            if kind == "hsd":
                T = U @ ga.C @ U
                asinvcsinv = asinvcsinv + _group_hsd_part(sh, T)
                if is0:
                    csinv = csinv + torch.sum(ga.C * U)
                    csinvcsinv = csinvcsinv + torch.sum(ga.C * T)
                    csinvrdsinv = csinvrdsinv + Rd * torch.diagonal(T, dim1=-2, dim2=-1).sum()
        if lp is not None and is0:
            # the LP cone on rank 0 (small next to the SDP work)
            out = schur_ops.lp_schur(lp, s_lp, m, with_m=with_m)
            asinv = asinv + out.asinv
            trsas = trsas + out.trSAS
            tr_u = tr_u + out.trU
            if with_m:
                M = M + out.M
            if kind == "hsd":
                h = schur_ops.lp_hsd(lp, s_lp, m)
                asinvcsinv = asinvcsinv + h.asinvcsinv
                csinv = csinv + h.csinv
                csinvcsinv = csinvcsinv + h.csinvcsinv
                # LP CSinvRdSinv omitted (ref hdsdp_conic_lp.c:315-327)
        packed = torch.cat([asinv, trsas, asinvcsinv,
                            torch.stack([csinv, csinvcsinv, csinvrdsinv, tr_u]).reshape(4)])
        packed = self.mesh.all_reduce(packed)
        asinv, trsas, asinvcsinv = packed[:m], packed[m:2 * m], packed[2 * m:3 * m]
        csinv, csinvcsinv, csinvrdsinv, tr_u = packed[3 * m:].unbind()
        if with_m:
            # combine the [m, m] partials by reduce_scatter: each rank keeps
            # its row block (identity tail from rank 0: one copy in the sum)
            pad = self.m_pad - m
            Mp = torch.nn.functional.pad(M, (0, pad, 0, pad))
            if pad and is0:
                tail = torch.arange(m, self.m_pad, device=dev)
                Mp[tail, tail] = 1.0
            M = RowShard(self.mesh.reduce_scatter(Mp), self.row0, self.m_pad, m, self.mesh)
        return KKTOut(
            M=M, asinv=asinv, asinvrdsinv=Rd * trsas,
            asinvcsinv=asinvcsinv if kind == "hsd" else None,
            csinv=csinv, csinvcsinv=csinvcsinv, csinvrdsinv=csinvrdsinv, trace_sinv=tr_u,
        )

    def primal_kkt(self, X_list) -> RowShard:
        """This rank's rows of PSDP's X-weighted system (X in place of
        S^-1), identity-tailed."""
        m = self.m
        dt = self._dt(*X_list)
        M = torch.zeros((m, m), dtype=dt, device=self.device)
        for ga, sh, X in zip(self._data(dt)[0], self._cast("shares", self.shares, dt), X_list):
            M = M + _group_schur_part(ga, sh, X, m, True)[0]
        pad = self.m_pad - m
        Mp = torch.nn.functional.pad(M, (0, pad, 0, pad))
        if pad and self.mesh.rank == 0:
            tail = torch.arange(m, self.m_pad, device=self.device)
            Mp[tail, tail] = 1.0
        return RowShard(self.mesh.reduce_scatter(Mp), self.row0, self.m_pad, m, self.mesh)
