"""Schur-complement assembly: M_ij = sum_cones tr(A_i S^-1 A_j S^-1).

Port of the JAX package's ops/schur.py for the layouts the slice runs.
Constraints are bucketed at presolve (solver/cones.py) into

  low-rank:  A_i = sum_k lam_k u_k u_k^T
  dense:     A_i stored as full [n, n]   (Ad, didx, dblk)

and the low-rank part of a single-block group is stored SLOT-MAJOR:
Fs[j, i] is the j-th eigenvector of A_i, so the Schur matrix becomes
r(r+1)/2 plain [m,n] x [n,m] products indexed by constraint

    M += sym( (lams_j (x) lams_k) * (Fs_j U Fs_k^T)^2 )

(the replacement of the reference's per-row M1/M2 rank-one kernels,
ref hdsdp_conic_sdp.c:687-778; dense coefficients follow M3,
:780-851).  The RHS vectors ASinv_i = tr(A_i S^-1), tr(S^-1 A_i S^-1)
and, for the homogeneous method, tr(C S^-1 A_i S^-1) come out of the same
pass.

Slot-major groups come in three buckets, chosen at presolve: the generic
one above; DIAGONAL rank-1 (A_i = w_i e_p e_p^T, the maxcut/torus
structure), where M_ij = w_i w_j U[p_i, p_j]^2 is a gather and a square;
and BOUNDED-SUPPORT (every eigenvector has <= c nonzeros, the theta
structure), where each pair product is c^2 gathered m x m Hadamard terms.
Multi-block groups are stored FLAT: F[g, R, n] with a constraint index per
slot, and the pairwise terms Q[g, R, R] are summed into M by constraint.

Every sum over duplicate indices has a FIXED ORDER, so that a solve
repeats its trajectory bit for bit on the card (``index_add_`` on CUDA adds
duplicates with atomics, in no fixed order): the positions that fall on
one output are listed in a table at presolve (``with_tables``) and summed
by a gather and a reduction along the table's width (``_table_sum``), or
the sum is a matrix product with a constant 0/1 operator (``dsel``).
``index_add`` is used only where the indices are unique (the dense bucket
of a single-block group: one coefficient per constraint).

The same buckets also serve the matrix-free Schur operator of large m
(``group_schur_matvec``, ``group_schur_diag``, ``group_schur_rows`` and
their LP counterparts): M applied to a vector, its exact diagonal, and its
rows in chunks, without ever storing M.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hdsdp_tpu_torch.ops import hpmm
from hdsdp_tpu_torch.utils import profile


class GroupArrays(NamedTuple):
    """Device-side arrays of one same-dimension SDP block group (field
    names and layouts as in the JAX package's GroupArrays)."""

    C: torch.Tensor  # [g, n, n]
    F: torch.Tensor  # [g, R, n] flat low-rank factors
    lam: torch.Tensor  # [g, R]
    seg: torch.Tensor  # [g, R] int constraint index
    Ad: torch.Tensor  # [md, n, n]
    didx: torch.Tensor  # [md] int
    dblk: torch.Tensor  # [md] int
    pos: Optional[torch.Tensor] = None  # [m]
    # slot-major layout (g == 1): F/lam/seg hold 1-slot placeholders
    Fs: Optional[torch.Tensor] = None  # [r, m, n]
    lams: Optional[torch.Tensor] = None  # [r, m]
    # diagonal rank-1 specialization (length-0 dpos = identity map)
    dpos: Optional[torch.Tensor] = None  # [m]
    dw: Optional[torch.Tensor] = None  # [m]
    # bounded-support specialization
    spos: Optional[torch.Tensor] = None  # [r, m, c]
    sval: Optional[torch.Tensor] = None  # [r, m, c]
    # fixed-order summation tables (with_tables; see _table_sum)
    dtab: Optional[torch.Tensor] = None  # [n, k] diag: constraints at each position
    scell: Optional[torch.Tensor] = None  # [K] support: flat n*n cells that get a term
    stab: Optional[torch.Tensor] = None  # [K, k] support: the terms of each cell
    ftab: Optional[torch.Tensor] = None  # [g, m, k] flat: slots of a constraint in a block
    fall: Optional[torch.Tensor] = None  # [m, k] flat: slots of a constraint over g*R
    xtab: Optional[torch.Tensor] = None  # [m, k] flat: dense entries of a constraint
    dsel: Optional[torch.Tensor] = None  # [g, md] 0/1: dense entry d lies in block g


def bucket(ga: GroupArrays) -> str:
    """The low-rank layout of a group: "diag", "support", "slot" or
    "flat" (same dispatch order as the JAX package)."""
    if ga.dpos is not None:
        return "diag"
    if ga.spos is not None:
        return "support"
    if ga.Fs is not None:
        return "slot"
    return "flat"


class SchurOut(NamedTuple):
    M: Optional[torch.Tensor]  # [m, m] contribution (None for rhs-only)
    asinv: torch.Tensor  # [m]   tr(A_i S^-1)
    trSAS: torch.Tensor  # [m]   tr(S^-1 A_i S^-1)  (caller multiplies by Rd)
    trU: torch.Tensor  # []    tr(S^-1)


class HSDOut(NamedTuple):
    asinvcsinv: torch.Tensor  # [m] tr(C S^-1 A_i S^-1)
    csinv: torch.Tensor  # []
    csinvcsinv: torch.Tensor  # []
    trUCU: torch.Tensor  # []  tr(S^-1 C S^-1) (caller multiplies by Rd)


# ----------------------------------------------------------------------
# fixed-order sums over duplicate indices
# ----------------------------------------------------------------------


def gather_table(idx: np.ndarray, n_out: int, keep=None) -> np.ndarray:
    """[n_out, k] table for ``_table_sum``: row o lists, in ascending
    order, the positions t with idx[t] == o (only those with keep[t]
    when ``keep`` is given), padded with len(idx), the position of the
    zero that ``_table_sum`` appends.  k is the largest count (>= 1)."""
    idx = np.asarray(idx).reshape(-1)
    n_in = idx.shape[0]
    where = np.arange(n_in) if keep is None else np.nonzero(np.asarray(keep).reshape(-1))[0]
    tgt = idx[where]
    order = np.argsort(tgt, kind="stable")
    tgt, where = tgt[order], where[order]
    counts = np.bincount(tgt, minlength=n_out)
    tab = np.full((n_out, max(int(counts.max(initial=0)), 1)), n_in, np.int64)
    tab[tgt, np.arange(len(tgt)) - (np.cumsum(counts) - counts)[tgt]] = where
    return tab


def _table_sum(vals: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """out[..., o] = sum_k vals[..., tab[o, k]]: a segment sum whose terms
    are added in the table's order, whatever the device.  A fleet's table
    is [N, O, k], one per instance, and vals [N, ..., L]."""
    padded = torch.nn.functional.pad(vals, (0, 1))
    if tab.ndim == 2:
        return padded[..., tab].sum(-1)
    n_f, n_out, k = tab.shape
    mid = padded.shape[1:-1]
    idx = tab.reshape((n_f,) + (1,) * len(mid) + (n_out * k,))
    idx = idx.expand(padded.shape[:-1] + (n_out * k,))
    return torch.gather(padded, -1, idx).reshape(padded.shape[:-1] + (n_out, k)).sum(-1)


# ----------------------------------------------------------------------
# the fleet: N same-shape instances on a leading axis (solver.batch)
#
# A fleet's GroupArrays carries one more leading axis on every field, the
# index fields and tables included (each instance has its own pattern);
# every function below takes it.  The helpers index per instance; with no
# fleet they are the plain indexing the single solve has always used.
# ----------------------------------------------------------------------


def is_fleet(ga: GroupArrays) -> bool:
    """True when ga holds a fleet (C is [N, g, n, n])."""
    return ga.C.ndim == 4


def _fleet_ar(idx: torch.Tensor) -> torch.Tensor:
    """arange over a fleet's instances, shaped to broadcast against idx."""
    return torch.arange(idx.shape[0], device=idx.device).reshape(
        (-1,) + (1,) * (idx.ndim - 1))


def _gather_vec(y: torch.Tensor, idx: torch.Tensor, fleet: bool) -> torch.Tensor:
    """y[idx] for y [L] and an index array, or per instance: y [N, L], idx [N, ...]."""
    if not fleet:
        return y[idx]
    return torch.gather(y, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def _take_last(x: torch.Tensor, idx: torch.Tensor, fleet: bool) -> torch.Tensor:
    """x[..., idx] for an index vector, or per instance: x [N, ..., L], idx [N, I]."""
    if not fleet:
        return x[..., idx]
    shape = x.shape[:-1] + idx.shape[-1:]
    ix = idx.reshape((idx.shape[0],) + (1,) * (x.ndim - 2) + idx.shape[-1:])
    return torch.gather(x, -1, ix.expand(shape))


def _rows(x: torch.Tensor, idx: torch.Tensor, fleet: bool) -> torch.Tensor:
    """x[idx] along the first axis, or per instance: x [N, L, ...], idx [N, I]."""
    if not fleet:
        return x[idx]
    return x[_fleet_ar(idx), idx]


def bcast(x, k: int):
    """A per-instance scalar of a fleet ([N]) shaped to broadcast against
    k more axes; a single solve's scalar (0-d or a number) as it is."""
    if isinstance(x, torch.Tensor) and x.ndim:
        return x.reshape(x.shape + (1,) * k)
    return x


def _fs_times(ga: GroupArrays, T: torch.Tensor) -> torch.Tensor:
    """Fs_j T for every slot j: [r, m, n] (a fleet's as one [N, r m, n]
    product per instance)."""
    if not is_fleet(ga):
        return ga.Fs @ T
    return (ga.Fs.reshape(ga.Fs.shape[0], -1, ga.Fs.shape[-1]) @ T).reshape(ga.Fs.shape)


def _trace_sum(U: torch.Tensor) -> torch.Tensor:
    """Sum of the traces of a stack of matrices [g, n, n] (per instance
    of a fleet's [N, g, n, n])."""
    return torch.diagonal(U, dim1=-2, dim2=-1).sum((-2, -1))


def _trace(U0: torch.Tensor, fleet: bool) -> torch.Tensor:
    """tr(U0) of one matrix (one per instance with a fleet).  A fleet
    takes each instance's trace alone: ``torch.trace`` of a single solve
    rounds otherwise than a batched diagonal sum, and a fleet member must
    repeat its solo solve's bits (N launches, not one)."""
    return torch.stack([torch.trace(u) for u in U0]) if fleet else torch.trace(U0)


def with_tables(ga: GroupArrays, m: int) -> GroupArrays:
    """The group with the summation tables its bucket needs (built once,
    on the host, from the index fields; stored on the group's device).
    ``m`` is the number of constraints of the problem."""
    dev = ga.C.device
    n = ga.C.shape[-1]

    def put(a):
        return torch.as_tensor(a, device=dev)

    def host(t):
        profile.count("host_reads")
        return t.cpu().numpy()

    kind = bucket(ga)
    if kind == "diag":
        if ga.dpos.shape[0] == 0:
            return ga  # identity map: nothing is summed
        return ga._replace(dtab=put(gather_table(host(ga.dpos), n, host(ga.dw) != 0.0)))
    if kind == "support":
        P, V, w = host(ga.spos), host(ga.sval), host(ga.lams)
        flat = (P[:, :, :, None] * n + P[:, :, None, :]).reshape(-1)
        live = ((w[:, :, None, None] * V[:, :, :, None] * V[:, :, None, :]) != 0.0).reshape(-1)
        cells = np.unique(flat[live])
        tab = gather_table(np.searchsorted(cells, flat), len(cells), live)
        return ga._replace(scell=put(cells), stab=put(tab))
    if kind == "slot":
        return ga
    g = ga.F.shape[0]
    seg, live = host(ga.seg), host(ga.lam) != 0.0
    R = seg.shape[1]
    per_block = [gather_table(seg[b], m, live[b]) for b in range(g)]
    k = max(t.shape[1] for t in per_block)
    tabs = dict(
        ftab=put(np.stack([np.pad(t, ((0, 0), (0, k - t.shape[1])), constant_values=R)
                           for t in per_block])),
        fall=put(gather_table(seg, m, live)),
    )
    if ga.Ad.shape[0]:
        tabs["xtab"] = put(gather_table(host(ga.didx), m))
        sel = np.arange(g)[:, None] == host(ga.dblk)[None, :]
        tabs["dsel"] = put(sel).to(ga.C.dtype)
    return ga._replace(**tabs)


def _table_pad(name: str, ga: GroupArrays) -> int:
    """The entry with which ``with_tables`` pads a table of ``ga`` (the
    position of the zero that _table_sum appends; for scell, one cell past
    the n*n)."""
    n = ga.C.shape[-1]
    return {
        "dtab": lambda: ga.dpos.shape[-1],
        "stab": lambda: ga.spos.numel() * ga.spos.shape[-1],
        "scell": lambda: n * n,
        "ftab": lambda: ga.F.shape[-2],
        "fall": lambda: ga.seg.numel(),
        "xtab": lambda: ga.Ad.shape[-3],
    }[name]()


_TABLES = ("dtab", "scell", "stab", "ftab", "fall", "xtab")


def stack_groups(gas) -> GroupArrays:
    """One fleet group from N instances' groups of one bucket and shape:
    every field stacked on a new leading axis.

    The summation tables come from each instance's own index pattern, so
    their widths (the largest duplicate count) and the support bucket's
    number of live cells differ between instances that agree in every
    other shape: each is padded to the fleet's largest with the entry that
    ``with_tables`` pads with, which adds nothing (and, in scell, a cell
    one past the n*n that group_dual drops).  Any other difference of
    layout or shape raises ValueError."""
    if len({bucket(ga) for ga in gas}) != 1:
        raise ValueError("a fleet's groups must share their Schur bucket")
    fields = {}
    for name in GroupArrays._fields:
        vals = [getattr(ga, name) for ga in gas]
        if all(v is None for v in vals):
            fields[name] = None
            continue
        if any(v is None for v in vals):
            raise ValueError(f"a fleet's groups disagree in their {name!r} field")
        if name in _TABLES:
            pad = _table_pad(name, gas[0])
            size = [max(v.shape[d] for v in vals) for d in range(vals[0].ndim)]
            vals = [torch.nn.functional.pad(
                v, [x for d in reversed(range(v.ndim)) for x in (0, size[d] - v.shape[d])],
                value=pad) for v in vals]
        elif any(v.shape != vals[0].shape for v in vals):
            raise ValueError(f"a fleet's groups disagree in the shape of {name!r}: "
                             f"{sorted({tuple(v.shape) for v in vals})}")
        fields[name] = torch.stack(vals)
    return GroupArrays(**fields)


def _slot_quad(ga: GroupArrays, FX: torch.Tensor) -> torch.Tensor:
    """sum_j lams_j * <Fs_j[i], FX_j[i]> per constraint i: [m]."""
    return torch.sum(ga.lams * torch.sum(FX * ga.Fs, dim=-1), dim=-2)


def _support_quad(ga: GroupArrays, T: torch.Tensor) -> torch.Tensor:
    """sum_j lams_j v_ji' T v_ji per constraint i, from T's entries at
    each eigenvector's support: [m]."""
    P, V = ga.spos, ga.sval
    if is_fleet(ga):
        Tsup = T[_fleet_ar(P)[..., None], P[..., :, None], P[..., None, :]]  # [N, r, m, c, c]
        q = torch.einsum("...jiab,...jia,...jib->...ji", Tsup, V, V)
    else:
        Tsup = T[P[:, :, :, None], P[:, :, None, :]]  # [r, m, c, c]
        q = torch.einsum("jiab,jia,jib->ji", Tsup, V, V)
    return torch.sum(ga.lams * q, dim=-2)


def _quadforms(F: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """q_r = u_r' T u_r for the rows u_r of F: [..., R]."""
    return torch.sum((F @ T) * F, dim=-1)


def _diag_take(ga: GroupArrays, d: torch.Tensor) -> torch.Tensor:
    """d[..., p_i] per constraint (d itself under the identity map)."""
    return d if ga.dpos.shape[-1] == 0 else _take_last(d, ga.dpos, is_fleet(ga))


def _lowrank_quad(ga: GroupArrays, T: torch.Tensor, m: int) -> torch.Tensor:
    """<A_i, T_blk> over the low-rank bucket, per constraint: [m]
    (T is [g, n, n] and symmetric)."""
    kind = bucket(ga)
    T0 = T[..., 0, :, :]
    if kind == "diag":
        return ga.dw * _diag_take(ga, torch.diagonal(T0, dim1=-2, dim2=-1))
    if kind == "support":
        return _support_quad(ga, T0)
    if kind == "slot":
        return _slot_quad(ga, _fs_times(ga, T0))
    lead = ga.C.shape[:-3]
    return _table_sum((ga.lam * _quadforms(ga.F, T)).reshape(lead + (-1,)), ga.fall)


def _add_dense(ga: GroupArrays, out: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[didx[d]] += vals[d]; didx is unique in a single-block group."""
    if ga.xtab is not None:
        return out + _table_sum(vals, ga.xtab)
    if is_fleet(ga):
        return out.scatter_add(-1, ga.didx, vals)
    return out.index_add(0, ga.didx, vals)


def group_dual(ga: GroupArrays, dC, scal, y, dEye, hp: bool = False) -> torch.Tensor:
    """Buffer assembly B = dEye*I + scal*(A'y) + dC*C, batched [g,n,n]
    (ref sdpDenseConeIUpdateBuffer, hdsdp_conic_sdp.c:343-402).  A fleet
    takes y [N, m] and per-instance scalars [N] and gives [N, g, n, n].

    ``hp`` (generic slot-major groups only) computes W = sum_ja w_ja u_ja
    u_ja^T as one [n, rm] x [rm, n] Ozaki product (ops.hpmm, ~2^-45
    relative), symmetrized."""
    kind = bucket(ga)
    fleet = is_fleet(ga)
    lead = ga.C.shape[:-3]
    g, n = ga.C.shape[-3], ga.C.shape[-1]
    if kind == "diag":
        wy = ga.dw * y
        dvec = wy if ga.dpos.shape[-1] == 0 else _table_sum(wy, ga.dtab)
        W = torch.diag_embed(dvec)[..., None, :, :]
    elif kind == "support":
        V = ga.sval
        wy = ga.lams * y[..., None, :]  # [r, m]
        vals = (wy[..., None, None] * V[..., :, None] * V[..., None, :]).reshape(lead + (-1,))
        if fleet:
            # padded cells of an instance point one past the n*n cells
            W = torch.zeros(lead + (n * n + 1,), dtype=vals.dtype, device=vals.device)
            W.scatter_(-1, ga.scell, _table_sum(vals, ga.stab))
            W = W[..., :n * n].reshape(lead + (1, n, n))
        else:
            W = torch.zeros(n * n, dtype=vals.dtype, device=vals.device)
            W[ga.scell] = _table_sum(vals, ga.stab)  # scell is unique
            W = W.reshape(1, n, n)
    elif kind == "slot":
        r, m_ = ga.Fs.shape[-3], ga.Fs.shape[-2]
        w = ga.lams * y[..., None, :]  # [r, m]
        Ff = ga.Fs.reshape(lead + (r * m_, n))
        wF = (w[..., None] * ga.Fs).reshape(lead + (r * m_, n))
        if hp:
            Wm = hpmm.hpmm(wF.mT, Ff)
            W = (0.5 * (Wm + Wm.mT)).unsqueeze(-3)
        else:
            W = (wF.mT @ Ff).unsqueeze(-3)
    else:
        w = ga.lam * _gather_vec(y, ga.seg, fleet)  # [g, R]
        W = (w[..., None] * ga.F).mT @ ga.F
    md = ga.Ad.shape[-3]
    if md:
        # sum_d y_d A_d per block as one product (fixed order)
        yd = _gather_vec(y, ga.didx, fleet)
        sel = yd.unsqueeze(-2) if ga.dsel is None else ga.dsel * yd.unsqueeze(-2)
        W = W + (sel @ ga.Ad.reshape(lead + (md, n * n))).reshape(lead + (g, n, n))
    eye = torch.eye(n, dtype=W.dtype, device=W.device)
    return bcast(scal, 3) * W + bcast(dC, 3) * ga.C + bcast(dEye, 3) * eye


def _dense_congruence(ga: GroupArrays, U: torch.Tensor):
    """B_i = U A_i U for the dense bucket (ref M3, hdsdp_conic_sdp.c:780-851)."""
    Ub = _rows(U, ga.dblk, is_fleet(ga))  # [md, n, n]
    return Ub @ ga.Ad @ Ub, Ub


def _scatter_rows(didx: torch.Tensor, X: torch.Tensor, m: int) -> torch.Tensor:
    """[m, k] matrix whose row didx[d] is X[d] (didx unique); per
    instance for a fleet (didx [N, md], X [N, md, k])."""
    if didx.ndim == 2:
        out = torch.zeros(X.shape[:1] + (m,) + X.shape[2:], dtype=X.dtype, device=X.device)
        return out.scatter_add_(1, didx[:, :, None].expand(X.shape), X)
    out = torch.zeros((m,) + X.shape[1:], dtype=X.dtype, device=X.device)
    return out.index_add_(0, didx, X)


def _dense_rhs(ga: GroupArrays, U, asinv, trsas):
    """Adds the dense bucket's tr(A_d U) and tr(U A_d U); returns them
    and B = U A_d U (None without a dense bucket)."""
    if not ga.Ad.shape[-3]:
        return asinv, trsas, None
    B, Ub = _dense_congruence(ga, U)
    asinv = _add_dense(ga, asinv, torch.sum(ga.Ad * Ub, dim=(-1, -2)))
    trsas = _add_dense(ga, trsas, torch.diagonal(B, dim1=-2, dim2=-1).sum(-1))
    return asinv, trsas, B


def _dense_cross(ga: GroupArrays, B: torch.Tensor) -> torch.Tensor:
    """Xc[d, i]: the dense coefficient d's congruence B_d = U A_d U against
    the low-rank part of constraint i, [md, rows of ga]."""
    kind = bucket(ga)
    if kind == "diag":
        # w_i B_d[p_i, p_i]
        return ga.dw.unsqueeze(-2) * _diag_take(ga, torch.diagonal(B, dim1=-2, dim2=-1))
    if kind == "support":
        # w_ji v' B_d v at each support
        return torch.stack([_support_quad(ga, B[..., d, :, :])
                            for d in range(B.shape[-3])], dim=-2)
    # lams_j[a] Fs_j[a]^T B_d Fs_j[a]
    return torch.stack([_slot_quad(ga, _fs_times(ga, B[..., d, :, :]))
                        for d in range(B.shape[-3])], dim=-2)


def _dense_m(ga: GroupArrays, B: Optional[torch.Tensor], col: Optional[GroupArrays],
             Bc: torch.Tensor, m: int) -> torch.Tensor:
    """M terms of a single-block group's dense bucket: dense x dense (all
    pairs interact) and the cross terms Xc[d, i] of dense coefficient d
    against the low-rank part of constraint i, both symmetric.

    ``col`` None: the whole [m, m] of the group ``ga`` (Bc is B).  Else the
    rows of a row view ``ga`` against the whole group ``col``, entry for
    entry those rows of the whole: ``ga`` carries the view's own dense
    coefficients (didx in view coordinates, B their congruences, None if
    it has none) and Bc the congruences of all of ``col``'s.  The
    transposed cross term is read from the view's own rows, so no other
    rows are needed."""
    c = ga if col is None else col
    rows = m if col is None else ga.lams.shape[-1]
    lead = Bc.shape[:-3]
    fleet = is_fleet(ga)

    def add_cols(out, X):  # out[..., :, c.didx[e]] += X[..., :, e]
        if fleet:
            return out.scatter_add_(-1, c.didx[:, None, :].expand(X.shape), X)
        return out.index_add_(1, c.didx, X)

    Xr = _dense_cross(ga, Bc)  # [md, rows]: every dense coefficient x the rows
    MxT = add_cols(torch.zeros(lead + (rows, m), dtype=Bc.dtype, device=Bc.device), Xr.mT)
    if B is None:
        return MxT
    md_v, md = B.shape[-3], Bc.shape[-3]
    Mdd = B.reshape(lead + (md_v, -1)) @ c.Ad.reshape(lead + (md, -1)).mT  # [md_v, md]
    cols = add_cols(torch.zeros(lead + (md_v, m), dtype=B.dtype, device=B.device), Mdd)
    Mx = _scatter_rows(ga.didx, Xr if col is None else _dense_cross(col, B), rows)
    return _scatter_rows(ga.didx, cols, rows) + Mx + MxT


def _dense_m_view(ga: GroupArrays, U: torch.Tensor, B, col: Optional[GroupArrays], m: int):
    """The dense bucket's M terms: the whole [m, m] of a group (col None)
    or the rows of a row view against the whole group ``col``; None where
    there is no dense coefficient."""
    if col is None:
        return None if B is None else _dense_m(ga, B, None, B, m)
    if not col.Ad.shape[-3]:
        return None
    Bc, _ = _dense_congruence(col, U)
    return _dense_m(ga, B, col, Bc, m)


def _slot_schur(ga: GroupArrays, U: torch.Tensor, m: int, with_m: bool,
                hp: bool = False, col: Optional[GroupArrays] = None) -> SchurOut:
    """Slot-major Schur contribution (g == 1).

    ``hp`` routes the two large product families (FU = Fs @ U and the pair
    products Fs_j U Fs_k^T) through the Ozaki matmul ops.hpmm (kernel K1
    on the card, a fleet's products as one launch each); the Hadamard
    squares, scalings and the dense bucket stay f64.

    ``col``: the whole group, when ``ga`` is a row view of it (the
    constraint-indexed arrays cut to a block of rows, see
    parallel.schur.row_view); M is then the view's rows [rows, m], every
    column-side operand read from ``col``.  The (k, j) partner of a slot
    pair is recomputed row-major instead of transposed, so the rows never
    need another block's: under ``hp`` its products round on their own,
    and the rows agree with the whole M to ~2^-45 relative."""
    r, m_, n = ga.Fs.shape[-3:]
    lead = ga.Fs.shape[:-3]
    U0 = U[..., 0, :, :]

    if hp:
        FU = hpmm.hpmm(ga.Fs.reshape(lead + (r * m_, n)), U0).reshape(ga.Fs.shape)
    else:
        FU = _fs_times(ga, U0)  # [r, m, n]
    asinv = _slot_quad(ga, FU)
    trsas = torch.sum(ga.lams * torch.sum(FU * FU, dim=-1), dim=-2)
    asinv, trsas, B = _dense_rhs(ga, U, asinv, trsas)

    M = None
    if with_m:
        c = ga if col is None else col
        M = torch.zeros(lead + (m_, m), dtype=U.dtype, device=U.device)

        def pair(j, k):
            FUj, Fk = FU[..., j, :, :], c.Fs[..., k, :, :]
            T = hpmm.hpmm(FUj, Fk.mT) if hp else FUj @ Fk.mT
            return (ga.lams[..., j, :, None] * c.lams[..., k, None, :]) * (T * T)

        for j in range(r):
            for k in range(j, r):
                T = pair(j, k)
                if k == j:
                    M = M + T
                elif col is None:
                    M = M + T + T.mT
                else:
                    M = M + T + pair(k, j)
        D = _dense_m_view(ga, U, B, col, m)
        if D is not None:
            M = M + D

    return SchurOut(M=M, asinv=asinv, trSAS=trsas, trU=_trace(U0, is_fleet(ga)))


def _diag_schur(ga: GroupArrays, U: torch.Tensor, m: int, with_m: bool,
                col: Optional[GroupArrays] = None) -> SchurOut:
    """Diagonal rank-1 bucket: A_i = w_i e_{p_i} e_{p_i}^T, so

        M_ij    = w_i w_j (U_{p_i p_j})^2          (gather + square)
        asinv_i = w_i U_{p_i p_i}
        trsas_i = w_i (U U)_{p_i p_i} = w_i ||U[:, p_i]||^2

    O(m^2 + n^2) per build against the generic slot path's O(n m^2) (ref
    M2 rank-one quadforms on 1-nnz eigenvectors, hdsdp_conic_sdp.c:687-778).
    Under the identity map (length-0 dpos) no gather runs.  U need only
    be symmetric (PSDP passes X).  ``col``: the whole group when ``ga`` is
    a row view of it (see _slot_schur); its rows equal the whole M's bit
    for bit."""
    fleet = is_fleet(ga)
    U0 = U[..., 0, :, :]
    w = ga.dw
    ident = ga.dpos.shape[-1] == 0

    asinv = w * _diag_take(ga, torch.diagonal(U0, dim1=-2, dim2=-1))
    trsas = w * _diag_take(ga, torch.sum(U0 * U0, dim=-2))  # diag(U @ U)
    asinv, trsas, B = _dense_rhs(ga, U, asinv, trsas)

    M = None
    if with_m:
        if col is not None:
            # a row view holds its rows' positions (never the identity map)
            Usub = U0[ga.dpos]
            if col.dpos.shape[-1]:
                Usub = Usub[:, col.dpos]
            M = (w[:, None] * col.dw[None, :]) * (Usub * Usub)
        else:
            if ident:
                Usub = U0
            elif fleet:
                Usub = U0[_fleet_ar(ga.dpos)[..., None], ga.dpos[:, :, None], ga.dpos[:, None, :]]
            else:
                Usub = U0[ga.dpos][:, ga.dpos]
            M = (w[..., :, None] * w[..., None, :]) * (Usub * Usub)
        D = _dense_m_view(ga, U, B, col, m)
        if D is not None:
            M = M + D

    return SchurOut(M=M, asinv=asinv, trSAS=trsas, trU=_trace(U0, fleet))


def _support_pair(U0, Pr, Vr, Pc, Vc, fleet: bool) -> torch.Tensor:
    """(Fs_j U Fs_k^T) over two supports, [rows, cols]: the row side
    (Pr, Vr [.., rows, c]) gathers rows of U, the column side (Pc, Vc)
    columns of the row-gathered [rows, n] block, c^2 Hadamard terms."""
    c = Pr.shape[-1]
    T = torch.zeros(Pr.shape[:-1] + Pc.shape[-2:-1], dtype=U0.dtype, device=U0.device)
    for a in range(c):
        G = _rows(U0, Pr[..., :, a], fleet)  # [rows, n]
        for b in range(c):
            T = T + (Vr[..., :, a, None] * Vc[..., None, :, b]) * _take_last(G, Pc[..., :, b], fleet)
    return T


def _support_pair_t(U0, Pr, Vr, Pc, Vc) -> torch.Tensor:
    """The transpose of ``_support_pair(U0, Pc, Vc, Pr, Vr)``, entry for
    entry, computed on the rows (Pr, Vr) alone: the same terms, multiplied
    and added in the same order, the entries of U read where that call
    reads them."""
    c = Pr.shape[-1]
    Ut = U0.mT
    Gs = [Ut[Pr[:, b]] for b in range(c)]  # Gs[b][i, q] = U[q, Pr[i, b]]
    T = torch.zeros((Pr.shape[0], Pc.shape[0]), dtype=U0.dtype, device=U0.device)
    for a in range(c):
        for b in range(c):
            T = T + (Vr[:, b, None] * Vc[None, :, a]) * Gs[b][:, Pc[:, a]]
    return T


def _support_schur(ga: GroupArrays, U: torch.Tensor, m: int, with_m: bool,
                   col: Optional[GroupArrays] = None) -> SchurOut:
    """Bounded-support slot bucket: every eigenvector has <= c nonzeros,
    so every pair product (Fs_j U Fs_k^T)_{i1 i2} = sum_{a,b} v_{j,i1,a}
    v_{k,i2,b} U[p_{j,i1,a}, p_{k,i2,b}] is c^2 gathered m x m Hadamard
    terms, no [m,n] x [n,m] product (ref sparse pairwise M5 kernels,
    hdsdp_sdpdata.c:1711-1963).  One n^3 product (U @ U) gives the trSAS
    row whatever m is.  ``col``: the whole group when ``ga`` is a row view
    of it (see _slot_schur); the (k, j) partner of a slot pair is then
    built on the view's rows as the transpose of the (j, k) pair, so its
    rows equal the whole M's bit for bit."""
    fleet = is_fleet(ga)
    lead = ga.C.shape[:-3]
    U0 = U[..., 0, :, :]
    P, V, w = ga.spos, ga.sval, ga.lams  # [r, m, c], [r, m]
    r, m_, c = P.shape[-3:]

    asinv = _support_quad(ga, U0)
    trsas = _support_quad(ga, U0 @ U0)
    asinv, trsas, B = _dense_rhs(ga, U, asinv, trsas)

    M = None
    if with_m:
        cg = ga if col is None else col
        Pc, Vc, wc = cg.spos, cg.sval, cg.lams
        M = torch.zeros(lead + (m_, m), dtype=U.dtype, device=U.device)
        for j in range(r):
            for k in range(j, r):
                T = _support_pair(U0, P[..., j, :, :], V[..., j, :, :],
                                  Pc[..., k, :, :], Vc[..., k, :, :], fleet)
                T = (w[..., j, :, None] * wc[..., k, None, :]) * (T * T)
                if k == j:
                    M = M + T
                elif col is None:
                    M = M + T + T.mT
                else:
                    Tt = _support_pair_t(U0, P[k], V[k], Pc[j], Vc[j])
                    M = M + T + (w[k][:, None] * wc[j][None, :]) * (Tt * Tt)
        D = _dense_m_view(ga, U, B, col, m)
        if D is not None:
            M = M + D

    return SchurOut(M=M, asinv=asinv, trSAS=trsas, trU=_trace(U0, fleet))


def accumulate_m(ga: GroupArrays, Q: torch.Tensor, m: int,
                 fall: Optional[torch.Tensor] = None) -> torch.Tensor:
    """M[i, j] = sum over blocks b and slots r of i, s of j in b of
    Q[b, r, s], for the flat layout's pairwise terms Q [g, R, R]: first
    the columns of every block by constraint, then the rows of all blocks
    together, each a fixed-order table sum (the JAX package contracts
    with [g, R, m] one-hot operators instead, O(R^2 m)).  ``fall``: the
    row table of a share of the slots when Q is [g, R_share, R] (the
    slot-partitioned mesh assembly, parallel.schur)."""
    g, R = Q.shape[-3], Q.shape[-2]
    lead = Q.shape[:-3]
    k = ga.ftab.shape[-1]
    idx = ga.ftab.reshape(lead + (g, 1, m * k)).expand(lead + (g, R, m * k))
    Qp = torch.nn.functional.pad(Q, (0, 1))
    T = torch.gather(Qp, -1, idx).reshape(lead + (g, R, m, k)).sum(-1)  # [g, R, m]
    return _table_sum(T.reshape(lead + (g * R, m)).mT, ga.fall if fall is None else fall).mT


def _flat_schur(ga: GroupArrays, U: torch.Tensor, m: int, with_m: bool) -> SchurOut:
    """Flat (multi-block) Schur contribution: W = F U F^T per block,
    Q = (lam lam^T) .* W^2 summed into M by constraint; dense coefficients
    interact only within their own block."""
    fleet = is_fleet(ga)
    lead = ga.C.shape[:-3]
    md = ga.Ad.shape[-3]

    FU = ga.F @ U  # [g, R, n]
    t_asinv = ga.lam * torch.sum(FU * ga.F, dim=-1)  # lam * u'Uu
    t_trsas = ga.lam * torch.sum(FU * FU, dim=-1)  # lam * ||Uu||^2
    asinv = _table_sum(t_asinv.reshape(lead + (-1,)), ga.fall)
    trsas = _table_sum(t_trsas.reshape(lead + (-1,)), ga.fall)
    asinv, trsas, B = _dense_rhs(ga, U, asinv, trsas)
    trU = _trace_sum(U)

    M = None
    if with_m:
        W = FU @ ga.F.mT  # F U F^T, [g, R, R]
        Q = (ga.lam[..., :, None] * ga.lam[..., None, :]) * (W * W)
        M = accumulate_m(ga, Q, m)
        if md:
            # dense x dense within the same block
            same = (ga.dblk[..., :, None] == ga.dblk[..., None, :]).to(U.dtype)
            Mdd = (B.reshape(lead + (md, -1)) @ ga.Ad.reshape(lead + (md, -1)).mT) * same
            M = M + _table_sum(_table_sum(Mdd, ga.xtab).mT, ga.xtab).mT
            # dense x low-rank cross: lam_r * u_r^T B_d u_r, same block
            cross = _rows(ga.lam, ga.dblk, fleet) * _quadforms(
                _rows(ga.F, ga.dblk, fleet), B)  # [md, R]
            k = ga.ftab.shape[-1]
            cols = torch.gather(
                torch.nn.functional.pad(cross, (0, 1)), -1,
                _rows(ga.ftab, ga.dblk, fleet).reshape(lead + (md, m * k)),
            ).reshape(lead + (md, m, k)).sum(-1)  # [md, m]
            Mx = _table_sum(cols.mT, ga.xtab).mT
            M = M + Mx + Mx.mT

    return SchurOut(M=M, asinv=asinv, trSAS=trsas, trU=trU)


def group_schur(ga: GroupArrays, U: torch.Tensor, m: int, with_m: bool = True,
                hp: bool = False, col: Optional[GroupArrays] = None) -> SchurOut:
    """Schur contribution of one group given U = S^-1 [g,n,n] (or, for
    PSDP, any symmetric U); a fleet's U is [N, g, n, n] and its outputs
    carry the leading axis.  ``hp`` reaches the generic slot-major bucket
    only; the gather buckets and the flat layout ignore it.

    ``col``: the whole group when ``ga`` is a row view of a slot-major
    group (parallel.schur.row_view: a block of constraint rows, as one
    rank of a row-sharded mesh holds them); M is then those rows,
    [rows, m], and the vectors are the rows' entries."""
    kind = bucket(ga)
    if col is not None and (kind == "flat" or is_fleet(ga)):
        raise ValueError("column views are for single slot-major groups")
    if kind == "diag":
        return _diag_schur(ga, U, m, with_m, col=col)
    if kind == "support":
        return _support_schur(ga, U, m, with_m, col=col)
    if kind == "slot":
        return _slot_schur(ga, U, m, with_m, hp=hp, col=col)
    return _flat_schur(ga, U, m, with_m)


def group_hsd(ga: GroupArrays, U: torch.Tensor, m: int) -> HSDOut:
    """Self-dual embedding components (ref sdpDenseConeIGetHSDComponents,
    hdsdp_conic_sdp.c:987-1033), via the dense-C M3 path."""
    T = U @ ga.C @ U  # U C U
    csinv = torch.sum(ga.C * U, dim=(-3, -2, -1))
    csinvcsinv = torch.sum(ga.C * T, dim=(-3, -2, -1))
    trUCU = _trace_sum(T)
    return HSDOut(
        asinvcsinv=group_atx(ga, T, m), csinv=csinv, csinvcsinv=csinvcsinv,
        trUCU=trUCU,
    )


def group_atx(ga: GroupArrays, X: torch.Tensor, m: int) -> torch.Tensor:
    """A(X): per-constraint traces <A_i, X_blk> given symmetric X [g,n,n]."""
    out = _lowrank_quad(ga, X, m)
    if ga.Ad.shape[-3]:
        out = _add_dense(ga, out, torch.sum(ga.Ad * _rows(X, ga.dblk, is_fleet(ga)),
                                            dim=(-1, -2)))
    return out


# ----------------------------------------------------------------------
# Matrix-free Schur operator (the analogue of the reference's sparse
# m x m Schur storage, ref interface/hdsdp_schur.c:46-139 and the
# dense-vs-sparse decision at hdsdp_schur.c:60,227).
#
# Above the size where a dense M fits comfortably, M is never stored: CG
# solves use
#
#     M v = A( S^-1 (sum_j v_j A_j) S^-1 )
#
# applied per bucket, O(m + n^2) memory instead of O(m^2), with the exact
# diagonal of M as the Jacobi preconditioner and row chunks of M as the
# source of an f32 Cholesky preconditioner.  The diagonal rank-1 bucket
# collapses the matvec further to O(m n) gathers (no n^3 congruence).
# ----------------------------------------------------------------------


def group_schur_matvec(ga: GroupArrays, U: torch.Tensor, v: torch.Tensor,
                       m: int) -> torch.Tensor:
    """(M_group @ v) for one vector v [m] without M_group.

    (M v)_i = tr(A_i S^-1 W S^-1) with W = sum_j v_j A_j: one weighted-sum
    assembly (group_dual with dC = dEye = 0), one congruence and one A(X)
    per matvec."""
    if ga.dpos is not None and ga.Ad.shape[0] == 0:
        # diagonal rank-1 bucket: M_ij = w_i w_j (U_{p_i p_j})^2, so
        # M v = w * (Usq[p] @ segsum(w v)): O(m n), no congruence
        U0 = U[0]
        wv = ga.dw * v
        Usq = U0 * U0
        if ga.dpos.shape[0] == 0:  # identity map
            return ga.dw * (Usq @ wv)
        return ga.dw * (Usq[ga.dpos] @ _table_sum(wv, ga.dtab))
    W = group_dual(ga, 0.0, 1.0, v, 0.0)
    return group_atx(ga, U @ W @ U, m)


def group_atx_rows(ga: GroupArrays, Xr: torch.Tensor, n0: int, m: int) -> torch.Tensor:
    """The share of A(X) = <A_i, X> that rows [n0, n0 + k) of X hold,
    given those rows Xr [g, k, n]: summed over a partition of the rows it
    is ``group_atx(ga, X, m)`` (each entry of X enters <A_i, X> once)."""
    k, n = Xr.shape[-2], Xr.shape[-1]
    n1 = n0 + k
    kind = bucket(ga)
    if kind == "diag":
        d = torch.zeros(n, dtype=Xr.dtype, device=Xr.device)
        d[n0:n1] = torch.diagonal(Xr[0][:, n0:n1])
        out = ga.dw * _diag_take(ga, d)
    elif kind == "support":
        T = torch.zeros((n, n), dtype=Xr.dtype, device=Xr.device)
        T[n0:n1] = Xr[0]
        out = _support_quad(ga, T)
    elif kind == "slot":
        FX = ga.Fs @ Xr[0].mT  # [r, m, k]: (X_rows u)
        out = torch.sum(ga.lams * torch.sum(FX * ga.Fs[..., n0:n1], dim=-1), dim=-2)
    else:
        FX = ga.F @ Xr.mT  # [g, R, k]
        q = ga.lam * torch.sum(FX * ga.F[..., n0:n1], dim=-1)
        out = _table_sum(q.reshape(-1), ga.fall)
    if ga.Ad.shape[0]:
        out = _add_dense(ga, out, torch.sum(ga.Ad[:, n0:n1, :] * Xr[ga.dblk], dim=(-1, -2)))
    return out


def group_schur_matvec_rows(ga: GroupArrays, U: torch.Tensor, v: torch.Tensor, m: int,
                            n0: int, n1: int) -> torch.Tensor:
    """The share of (M_group @ v) that rows [n0, n1) of U W U give (W =
    sum_j v_j A_j): the partial of the row-sharded operator matvec, one
    all-reduce away from ``group_schur_matvec``.  The diagonal rank-1
    bucket's shortcut takes rows [n0, n1) of U*U the same way."""
    if n1 <= n0:
        return torch.zeros(m, dtype=v.dtype, device=v.device)
    if ga.dpos is not None and ga.Ad.shape[0] == 0:
        U0 = U[0]
        n = U0.shape[-1]
        wv = ga.dw * v
        Usq = U0[n0:n1] * U0[n0:n1]
        pos = torch.zeros(n, dtype=v.dtype, device=v.device)
        if ga.dpos.shape[0] == 0:  # identity map
            pos[n0:n1] = Usq @ wv
            return ga.dw * pos
        pos[n0:n1] = Usq @ _table_sum(wv, ga.dtab)
        return ga.dw * pos[ga.dpos]
    W = group_dual(ga, 0.0, 1.0, v, 0.0)
    return group_atx_rows(ga, U[..., n0:n1, :] @ W @ U, n0, m)


def _flat_diag(ga: GroupArrays, Q: torch.Tensor) -> torch.Tensor:
    """d[i] = sum over blocks b and slots r, s of constraint i in b of
    Q[b, r, s] (the diagonal of ``accumulate_m``), in the order of the
    slot table."""
    g = Q.shape[0]
    Qp = torch.nn.functional.pad(Q, (0, 1, 0, 1))
    b = torch.arange(g, device=Q.device)[:, None, None, None]
    sub = Qp[b, ga.ftab[:, :, :, None], ga.ftab[:, :, None, :]]  # [g, m, k, k]
    return sub.sum(dim=(-1, -2)).sum(0)


def group_schur_diag(ga: GroupArrays, U: torch.Tensor, m: int) -> torch.Tensor:
    """diag(M_group) exactly, without M: the Jacobi preconditioner of the
    matrix-free path.  Buckets are exclusive per (constraint, block)
    (models/problem.py packs each coefficient as low-rank OR dense), so
    there are no low-rank x dense diagonal cross terms."""
    kind = bucket(ga)
    if kind == "diag":
        dU = _diag_take(ga, torch.diagonal(U[0]))
        d = ga.dw * ga.dw * (dU * dU)
    elif kind == "support":
        P, V = ga.spos, ga.sval
        # G[j, k, i] = v_{j,i}' U v_{k,i} over each slot pair's support
        Ucr = U[0][P[:, None, :, :, None], P[None, :, :, None, :]]  # [r, r, m, c, c]
        G = torch.einsum("jkiab,jia,kib->jki", Ucr, V, V)
        d = torch.einsum("ji,ki,jki->i", ga.lams, ga.lams, G * G)
    elif kind == "slot":
        FU = ga.Fs @ U[0]  # [r, m, n]
        G = torch.einsum("jin,kin->jki", FU, ga.Fs)
        d = torch.einsum("ji,ki,jki->i", ga.lams, ga.lams, G * G)
    else:
        W = (ga.F @ U) @ ga.F.mT  # F U F^T, [g, R, R]
        d = _flat_diag(ga, (ga.lam[:, :, None] * ga.lam[:, None, :]) * (W * W))
    if ga.Ad.shape[0]:
        B, _ = _dense_congruence(ga, U)
        d = _add_dense(ga, d, torch.sum(B * ga.Ad, dim=(-1, -2)))
    return d


def group_schur_rows(ga: GroupArrays, U: torch.Tensor, i0: int, chunk: int,
                     m: int) -> Optional[torch.Tensor]:
    """Rows [i0, i0+chunk) of this group's Schur contribution, [chunk, m].

    The row-chunked build behind the operator-mode Cholesky
    preconditioner: the full M exists only as an f32 copy assembled chunk
    by chunk, and no f64 temporary is larger than a few [chunk, m] blocks.
    The caller keeps i0 + chunk <= m (its last chunk overlaps the one
    before instead of running short).

    Supported: the three slot-major buckets (diag / bounded-support /
    generic slot) with their dense slots, the shapes that reach operator
    scale (the theta family's identity row is a dense slot).  Returns
    None for the flat multi-block layout; the caller falls back to
    Jacobi."""
    if ga.Fs is None:
        return None
    U0 = U[0]
    md = ga.Ad.shape[0]
    sl = slice(i0, i0 + chunk)
    kind = bucket(ga)

    if kind == "diag":
        w = ga.dw
        if ga.dpos.shape[0] == 0:
            Usub = U0[sl]
        else:
            Usub = U0[ga.dpos[sl]][:, ga.dpos]
        M = (w[sl, None] * w[None, :]) * (Usub * Usub)
    elif kind == "support":
        P, V, w = ga.spos, ga.sval, ga.lams  # [r, m, c], [r, m]
        r, _, c = P.shape
        M = torch.zeros((chunk, m), dtype=U.dtype, device=U.device)
        for j in range(r):
            Pr, Vr, wr = P[j, sl], V[j, sl], w[j, sl]
            for k in range(r):
                T = torch.zeros((chunk, m), dtype=U.dtype, device=U.device)
                for a in range(c):
                    G = U0[Pr[:, a]]  # [chunk, n]
                    for b in range(c):
                        T = T + (Vr[:, a, None] * V[k][None, :, b]) * G[:, P[k][:, b]]
                M = M + (wr[:, None] * w[k][None, :]) * (T * T)
    else:
        # generic slot-major: r^2 [chunk, n] x [n, m] products
        r = ga.Fs.shape[0]
        M = torch.zeros((chunk, m), dtype=U.dtype, device=U.device)
        for j in range(r):
            FUr = ga.Fs[j, sl] @ U0  # [chunk, n]
            wr = ga.lams[j, sl]
            for k in range(r):
                T = FUr @ ga.Fs[k].T  # [chunk, m]
                M = M + (wr[:, None] * ga.lams[k][None, :]) * (T * T)

    if md:
        # dense slots (md is small, e.g. the theta identity row).
        # cross[d, i] = dense slot d against constraint i's low-rank
        # part; dense constraints hold no low-rank slot, so no entry is
        # counted twice.
        B, _ = _dense_congruence(ga, U)  # [md, n, n]
        if kind == "diag":
            cross = ga.dw[None, :] * _diag_take(ga, torch.diagonal(B, dim1=-2, dim2=-1))
        elif kind == "support":
            cross = torch.stack([_support_quad(ga, Bi) for Bi in B])
        else:
            cross = torch.stack([_slot_quad(ga, ga.Fs @ Bi) for Bi in B])  # [md, m]
        Mdd = B.reshape(md, -1) @ ga.Ad.reshape(md, -1).T  # [md, md]
        # 0/1 selectors by comparison (didx is unique in a single-block
        # group, so every product below has one term per entry)
        cols = torch.arange(m, device=U.device)
        Ed = (ga.didx[:, None] == cols[None, :]).to(U.dtype)  # [md, m]
        # low-rank rows of the chunk x dense columns
        M = M + cross[:, sl].T @ Ed
        # dense rows that fall inside the chunk (the full row, dense x
        # dense block included); slots outside the chunk select no row
        Erel = (ga.didx[:, None] - i0 == cols[None, :chunk]).to(U.dtype)  # [md, chunk]
        M = M + Erel.T @ (cross + Mdd @ Ed)
    return M


# ----------------------------------------------------------------------
# LP cone contributions (ref interface/hdsdp_conic_lp.c:254-330)
# ----------------------------------------------------------------------


class LPArrays(NamedTuple):
    A: torch.Tensor  # [m, nlp]
    c: torch.Tensor  # [nlp]


def _lp_mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A @ v, per instance for a fleet (A [N, m, nlp], v [N, nlp])."""
    return A @ v if A.ndim == 2 else (A @ v[..., None])[..., 0]


def _lp_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x) if x.ndim == 1 else torch.sum(x, dim=-1)


def lp_dual(lp: LPArrays, dC, scal, y, dEye) -> torch.Tensor:
    """s = dEye*1 + scal*(A'y) + dC*c (a fleet: y [N, m], scalars [N])."""
    if lp.A.ndim == 2:
        return dEye + scal * (y @ lp.A) + dC * lp.c
    aty = (y[..., None, :] @ lp.A)[..., 0, :]
    return bcast(dEye, 1) + bcast(scal, 1) * aty + bcast(dC, 1) * lp.c


def lp_schur(lp: LPArrays, s: torch.Tensor, m: int, with_m: bool = True,
             col: Optional[LPArrays] = None) -> SchurOut:
    """``col``: the whole LP cone when ``lp`` holds a block of A's rows;
    M is then those rows of A diag(s^-2) A', [rows, m]."""
    si = 1.0 / s
    asinv = _lp_mv(lp.A, si)
    trsas = _lp_mv(lp.A, si * si)
    Ac = lp.A if col is None else col.A
    M = (lp.A * (si * si)[..., None, :]) @ Ac.mT if with_m else None
    return SchurOut(M=M, asinv=asinv, trSAS=trsas, trU=_lp_sum(si))


def lp_hsd(lp: LPArrays, s: torch.Tensor, m: int) -> HSDOut:
    si = 1.0 / s
    csi = lp.c * si
    # NOTE: the reference omits the LP CSinvRdSinv term
    # (ref hdsdp_conic_lp.c:315-327); reproduced here.
    return HSDOut(
        asinvcsinv=_lp_mv(lp.A, lp.c * si * si),
        csinv=_lp_sum(csi),
        csinvcsinv=_lp_sum(csi * csi),
        trUCU=torch.zeros(s.shape[:-1], dtype=s.dtype, device=s.device),
    )


def lp_schur_rows(lp: LPArrays, s: torch.Tensor, i0: int, chunk: int) -> torch.Tensor:
    """Rows [i0, i0+chunk) of the LP cone's A diag(s^-2) A^T."""
    si2 = 1.0 / (s * s)
    return (lp.A[i0:i0 + chunk] * si2[None, :]) @ lp.A.T


def lp_schur_matvec(lp: LPArrays, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(A diag(s^-2) A') v for the LP cone (ref hdsdp_conic_lp.c:294-313)."""
    si2 = 1.0 / (s * s)
    return lp.A @ (si2 * (v @ lp.A))


def lp_schur_diag(lp: LPArrays, s: torch.Tensor) -> torch.Tensor:
    si2 = 1.0 / (s * s)
    return (lp.A * lp.A) @ si2
