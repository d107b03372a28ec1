"""Per-constraint coefficient analysis (presolve).

Parity with the reference coefficient machinery, redesigned for batched
accelerator linear algebra:

  * The reference classifies each A_i into ZERO / SPARSE / DENSE / SPR1 / DSR1
    (ref linalg/hdsdp_sdpdata.c:2321-2345, threshold: dense if
    nnz > 0.3 * packed) and detects rank-one structure a*a' at presolve
    (ref sdpDataMatBuildUpEigs, hdsdp_sdpdata.c:2373-2458).
  * Here we generalize: every A_i gets an eigendecomposition *restricted to
    its sparsity support* (the SPEIGS trick, ref derivative/SPEIGS: the range
    of a symmetric matrix is spanned by its nonzero rows), and is bucketed as

       - low-rank: factors (lambda_k, u_k), rank <= rank_cap
       - dense:    full n x n matrix

    On the device the low-rank bucket turns the Schur complement into batched
    matmuls; the dense bucket uses batched congruence transforms.  The
    CPU-oriented per-row M1-M5 strategy dispatch
    (ref sdpDenseConeIChooseKKTStrategy, hdsdp_conic_sdp.c:539-600) is
    replaced by this single bucketing decision.

``analyze_coeff`` analyzes one matrix and is the plain version.
``analyze_block`` gives the same analyses for a whole block with array
operations: one stacked ``eigh`` per support size, and none for a matrix
that a principal-submatrix certificate proves dense (see
``analyze_block``).  Its factors and dense matrices are those of
``analyze_coeff`` bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from hdsdp_tpu_torch.utils import profile
from hdsdp_tpu_torch.utils.blas_threads import single_threaded

# dense classification threshold (ref hdsdp_sdpdata.c:2332)
DENSE_NNZ_RATIO = 0.3
# rank-1 factor density threshold spr1 vs dsr1 (ref hdsdp_sdpdata.c:2397-2399)
R1_DENSE_RATIO = 0.5
EIG_RANK_TOL = 1e-10
# the rank certificate's eigenvalues must clear EIG_RANK_TOL * max(abs_norm, 1)
# by this factor: far more than the rounding of either eigendecomposition
CERT_MARGIN = 10.0
# bytes of one stacked eigendecomposition's input; a larger group is split
STACK_BYTES = 1 << 26

# Reference-style coefficient types, kept for feature statistics
# (ref def_hdsdp_sdpdata.h:25-33)
COEFF_ZERO = 0
COEFF_SPARSE = 1
COEFF_DENSE = 2
COEFF_SPR1 = 3
COEFF_DSR1 = 4


@dataclass
class CoeffInfo:
    """Analysis result for one coefficient matrix inside one block."""

    n: int
    nnz: int
    ref_type: int  # reference-style type for statistics
    # restricted-eig rank (0 for zero matrix): exact up to rank_cap; above it
    # an upper bound, the support size, where no eigendecomposition was made
    rank: int
    # low-rank factorization A = sum_k lam[k] * vecs[k] vecs[k]^T
    lam: Optional[np.ndarray] = None  # [rank]
    vecs: Optional[np.ndarray] = None  # [rank, n]
    dense: Optional[np.ndarray] = None  # [n, n] if bucketed dense
    abs_norm: float = 0.0
    fro_norm: float = 0.0
    # structure detectors used for auto-tuning
    is_eye_multiple: Optional[float] = None  # A = alpha * I -> alpha
    unit_col: Optional[int] = None  # A = +/- e_k e_k^T -> k


def dense_from_coo(n: int, row: np.ndarray, col: np.ndarray, val: np.ndarray) -> np.ndarray:
    """Full symmetric matrix from lower-triangular COO (duplicates summed)."""
    A = np.zeros((n, n))
    np.add.at(A, (row, col), val)
    lower = np.tril(A, -1)
    return A + lower.T


def analyze_coeff(
    n: int,
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    rank_cap: int,
    max_eig_support: int = 2048,
) -> CoeffInfo:
    """Analyze one coefficient matrix given lower-tri COO entries."""

    nnz = len(val)
    if nnz == 0:
        return CoeffInfo(n=n, nnz=0, ref_type=COEFF_ZERO, rank=0)

    packed = n * (n + 1) // 2
    ref_type = COEFF_DENSE if nnz > DENSE_NNZ_RATIO * packed else COEFF_SPARSE

    offdiag = row != col
    abs_norm = float(np.sum(np.abs(val) * np.where(offdiag, 2.0, 1.0)))
    fro_norm = float(np.sqrt(np.sum(val * val * np.where(offdiag, 2.0, 1.0))))

    # Support-restricted eigendecomposition (SPEIGS-style two-phase)
    support = np.unique(np.concatenate([row, col]))
    k = len(support)

    info = CoeffInfo(
        n=n, nnz=nnz, ref_type=ref_type, rank=n, abs_norm=abs_norm, fro_norm=fro_norm
    )

    # Structure detectors (ref dataMatIsEye / dataMatIsUnitCol analogues)
    if nnz == 1 and row[0] == col[0]:
        info.unit_col = int(row[0])
    diag_only = not offdiag.any()
    if diag_only and k == n:
        dvals = np.zeros(n)
        np.add.at(dvals, row, val)
        if np.allclose(dvals, dvals[0], rtol=1e-12, atol=0.0) and dvals[0] != 0.0:
            info.is_eye_multiple = float(dvals[0])

    if k > max_eig_support:
        # too expensive to eigendecompose: keep dense
        info.dense = dense_from_coo(n, row, col, val)
        info.rank = min(k, n)
        return info

    pos = np.zeros(n, dtype=np.int64)
    pos[support] = np.arange(k)
    Asub = np.zeros((k, k))
    np.add.at(Asub, (pos[row], pos[col]), val)
    low = np.tril(Asub, -1)
    Asub = Asub + low.T

    w, V = np.linalg.eigh(Asub)
    wmax = np.max(np.abs(w)) if k else 0.0
    keep = np.abs(w) > EIG_RANK_TOL * max(wmax, 1.0)
    rank = int(keep.sum())
    info.rank = rank

    if rank == 1:
        # reference rank-one classification (spr1 / dsr1 by factor density)
        v = V[:, keep][:, 0]
        r1nnz = int(np.sum(np.abs(v) > 1e-10))
        info.ref_type = COEFF_DSR1 if r1nnz > R1_DENSE_RATIO * n else COEFF_SPR1

    if rank <= rank_cap:
        lam = w[keep]
        vecs = np.zeros((rank, n))
        vecs[:, support] = V[:, keep].T
        info.lam = lam
        info.vecs = vecs
    else:
        info.dense = dense_from_coo(n, row, col, val)

    return info


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenation of arange(s, s + l) over the pairs of starts and lens."""
    first = np.cumsum(lens) - lens
    return np.repeat(starts - first, lens) + np.arange(int(lens.sum()))


def _segment_sums(x: np.ndarray, bounds: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """``np.sum(x[bounds[i]:bounds[i] + lens[i]])`` for every i, bit for bit:
    one row-wise sum per segment length (``np.add.reduceat`` adds in
    another order)."""
    out = np.zeros(len(lens))
    for ln in np.unique(lens[lens > 0]).tolist():
        sel = np.flatnonzero(lens == ln)
        out[sel] = x[bounds[sel][:, None] + np.arange(ln)].sum(axis=1)
    return out


@dataclass
class _Entries:
    """A block's COO entries sorted by matrix (stable), each matrix's
    extent, and its support: ``slots`` holds the distinct keys
    matrix * n + index in order, matrix i's are ``first[i]:first[i] + k[i]``;
    an entry's row and column are the slots ``rslot``, ``cslot``."""

    n: int
    con: np.ndarray
    row: np.ndarray
    col: np.ndarray
    val: np.ndarray
    bounds: np.ndarray  # matrix i's entries: bounds[i]:bounds[i + 1]
    nnz: np.ndarray
    slots: np.ndarray
    first: np.ndarray
    k: np.ndarray  # support sizes
    rslot: np.ndarray
    cslot: np.ndarray

    @staticmethod
    def of(n, m, con, row, col, val) -> "_Entries":
        order = np.argsort(con, kind="stable")
        con = con[order].astype(np.int64)
        row, col, val = row[order], col[order], val[order]
        bounds = np.searchsorted(con, np.arange(m + 2))
        rkey, ckey = con * n + row, con * n + col
        slots = np.unique(np.concatenate([rkey, ckey]))
        k = np.bincount(slots // n, minlength=m + 1)
        return _Entries(n, con, row, col, val, bounds, np.diff(bounds), slots,
                        np.cumsum(k) - k, k, np.searchsorted(slots, rkey),
                        np.searchsorted(slots, ckey))

    def entries(self, mats: np.ndarray) -> np.ndarray:
        """Indices of the entries of the matrices ``mats``, matrix by matrix."""
        return _ranges(self.bounds[mats], self.nnz[mats])

    def dense(self, i: int) -> np.ndarray:
        lo, hi = self.bounds[i], self.bounds[i + 1]
        return dense_from_coo(self.n, self.row[lo:hi], self.col[lo:hi], self.val[lo:hi])


def analyze_block(
    n: int,
    m: int,
    con: np.ndarray,
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    rank_cap: int,
    max_eig_support: int = 2048,
) -> List[CoeffInfo]:
    """Analyze all m+1 coefficient matrices (index 0 = objective C) of a block.

    The same analyses as ``analyze_coeff`` matrix by matrix, with array
    operations over the block:

      * nnz, norms, supports and the structure detectors of every matrix
        at once;
      * the restricted matrices of one support size k stacked into one
        [N, k, k] ``eigh`` (split above ``STACK_BYTES``), whose rows are the
        per-matrix calls' bits;
      * no ``eigh`` for a matrix with k > max(rank_cap, 1) whose rank a
        certificate proves above rank_cap: B, the principal submatrix on
        max(rank_cap, 1) + 1 support indices of largest |diagonal|, has
        every eigenvalue above CERT_MARGIN * EIG_RANK_TOL * max(abs_norm, 1)
        in magnitude.  By Cauchy interlacing A then has as many eigenvalues
        of that size, and abs_norm >= max|lambda(A)| (duplicate entries
        included), so ``analyze_coeff`` would keep that many and bucket A
        dense.  It is bucketed dense here with rank = k.  Where the
        certificate fails, the eigendecomposition is made as for the rest.

    Counters (``utils.profile``): ``analyze_eigh_calls`` stacked ``eigh``
    calls, ``analyze_eigh_skipped`` matrices the certificate proved dense,
    ``analyze_eigh_fallback`` certificates that failed.
    """

    e = _Entries.of(n, m, con, row, col, val)
    nnz, k = e.nnz, e.k
    offdiag = e.row != e.col
    weight = np.where(offdiag, 2.0, 1.0)
    abs_norm = _segment_sums(np.abs(e.val) * weight, e.bounds, nnz)
    fro_norm = np.sqrt(_segment_sums(e.val * e.val * weight, e.bounds, nnz))

    packed = n * (n + 1) // 2
    infos = []
    for i, (z, kk, a, f) in enumerate(zip(nnz.tolist(), k.tolist(), abs_norm.tolist(),
                                          fro_norm.tolist())):
        if z == 0:
            infos.append(CoeffInfo(n=n, nnz=0, ref_type=COEFF_ZERO, rank=0))
            continue
        ref_type = COEFF_DENSE if z > DENSE_NNZ_RATIO * packed else COEFF_SPARSE
        infos.append(CoeffInfo(n=n, nnz=z, ref_type=ref_type, rank=min(kk, n),
                               abs_norm=a, fro_norm=f))
    # A = +/- e_k e_k^T: one diagonal entry
    lo, hi = e.bounds[:-1], e.bounds[1:]
    one = np.flatnonzero(nnz == 1)
    for i in one[e.row[lo[one]] == e.col[lo[one]]].tolist():
        infos[i].unit_col = int(e.row[lo[i]])
    # A = alpha * I: diagonal entries only, over the whole block
    n_off = np.bincount(e.con[offdiag], minlength=m + 1)
    for i in np.flatnonzero((nnz > 0) & (n_off == 0) & (k == n)).tolist():
        dvals = np.zeros(n)
        np.add.at(dvals, e.row[lo[i]:hi[i]], e.val[lo[i]:hi[i]])
        if np.allclose(dvals, dvals[0], rtol=1e-12, atol=0.0) and dvals[0] != 0.0:
            infos[i].is_eye_multiple = float(dvals[0])

    small = (nnz > 0) & (k <= max_eig_support)
    cands = np.flatnonzero(small & (k > max(rank_cap, 1)))
    need = small.copy()
    with single_threaded():  # the same bits at any thread count of the host
        if len(cands):
            proven = _certify_dense(e, cands, rank_cap, abs_norm[cands])
            need[cands[proven]] = False
            profile.count("analyze_eigh_skipped", int(proven.sum()))
            profile.count("analyze_eigh_fallback", int((~proven).sum()))
        for kk in np.unique(k[need]).tolist():
            mats = np.flatnonzero(need & (k == kk))
            step = max(1, STACK_BYTES // (8 * kk * kk))
            for s in range(0, len(mats), step):
                _decompose(e, infos, mats[s:s + step], kk, rank_cap)

    for i in np.flatnonzero((nnz > 0) & ~need).tolist():  # proven, or k too large
        infos[i].dense = e.dense(i)
    return infos


def _certify_dense(e: _Entries, cands: np.ndarray, rank_cap: int,
                   abs_norm: np.ndarray) -> np.ndarray:
    """Whether the certificate of ``analyze_block`` proves each matrix of
    ``cands`` (support sizes > max(rank_cap, 1)) of rank > rank_cap."""
    p = max(rank_cap, 1) + 1
    nc = len(cands)
    diag = np.zeros(len(e.slots))
    d = e.row == e.col
    np.add.at(diag, e.rslot[d], e.val[d])
    # each candidate's slots by descending |diagonal|; the first p of each,
    # back in support order, are B's indices 0..p-1
    sizes = e.k[cands]
    mine = _ranges(e.first[cands], sizes)
    owner = np.repeat(np.arange(nc), sizes)
    ranked = mine[np.lexsort((-np.abs(diag[mine]), owner))]
    chosen = np.sort(ranked[_ranges(np.cumsum(sizes) - sizes, np.full(nc, p))])
    sel = np.full(len(e.slots), -1)
    sel[chosen] = np.tile(np.arange(p), nc)
    ent = e.entries(cands)
    r, c = sel[e.rslot[ent]], sel[e.cslot[ent]]
    on = (r >= 0) & (c >= 0)
    B = np.zeros((nc, p, p))
    np.add.at(B, (np.repeat(np.arange(nc), e.nnz[cands])[on], r[on], c[on]), e.val[ent[on]])
    B = B + np.swapaxes(np.tril(B, -1), -1, -2)
    beta = np.linalg.eigvalsh(B)
    return np.min(np.abs(beta), axis=1) > CERT_MARGIN * EIG_RANK_TOL * np.maximum(abs_norm, 1.0)


def _decompose(e: _Entries, infos: List[CoeffInfo], mats: np.ndarray, kk: int,
               rank_cap: int) -> None:
    """Rank, type and factors (or dense matrix) of ``infos[mats]``, of support
    size ``kk``, from one stacked restricted eigendecomposition."""
    n, N = e.n, len(mats)
    ent = e.entries(mats)
    owner = np.repeat(np.arange(N), e.nnz[mats])
    base = e.first[mats][owner]
    S = np.zeros((N, kk, kk))
    np.add.at(S, (owner, e.rslot[ent] - base, e.cslot[ent] - base), e.val[ent])
    S = S + np.swapaxes(np.tril(S, -1), -1, -2)
    w, V = np.linalg.eigh(S)
    profile.count("analyze_eigh_calls")
    wmax = np.max(np.abs(w), axis=1)
    keep = np.abs(w) > EIG_RANK_TOL * np.maximum(wmax, 1.0)[:, None]
    ranks = keep.sum(axis=1)
    support = e.slots[e.first[mats][:, None] + np.arange(kk)] % n
    for r in np.unique(ranks).tolist():
        sub = np.flatnonzero(ranks == r)
        ns = len(sub)
        cols = np.nonzero(keep[sub])[1].reshape(ns, r)
        Vk = np.take_along_axis(V[sub], cols[:, None, :], axis=2)  # [ns, kk, r]
        if r == 1:
            # reference rank-one classification (spr1 / dsr1 by factor density)
            r1nnz = np.sum(np.abs(Vk[:, :, 0]) > 1e-10, axis=1)
            dsr1 = (r1nnz > R1_DENSE_RATIO * n).tolist()
        if r <= rank_cap:
            lam = np.take_along_axis(w[sub], cols, axis=1)
            vecs = np.zeros((ns, r, n))
            vecs[np.arange(ns)[:, None, None], np.arange(r)[None, :, None],
                 support[sub][:, None, :]] = np.swapaxes(Vk, 1, 2)
        for j, i in enumerate(mats[sub].tolist()):
            info = infos[i]
            info.rank = r
            if r == 1:
                info.ref_type = COEFF_DSR1 if dsr1[j] else COEFF_SPR1
            if r <= rank_cap:
                info.lam = lam[j]
                info.vecs = vecs[j]
            else:
                info.dense = e.dense(i)
