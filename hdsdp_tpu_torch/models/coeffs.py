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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from hdsdp_tpu_torch.utils.blas_threads import single_threaded

# dense classification threshold (ref hdsdp_sdpdata.c:2332)
DENSE_NNZ_RATIO = 0.3
# rank-1 factor density threshold spr1 vs dsr1 (ref hdsdp_sdpdata.c:2397-2399)
R1_DENSE_RATIO = 0.5
EIG_RANK_TOL = 1e-10

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
    rank: int  # restricted-eig rank (0 for zero matrix)
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
    """Analyze all m+1 coefficient matrices (index 0 = objective C) of a block."""

    order = np.argsort(con, kind="stable")
    con, row, col, val = con[order], row[order], col[order], val[order]
    bounds = np.searchsorted(con, np.arange(m + 2))
    infos = []
    # one BLAS thread: the restricted eigendecompositions (blocked LAPACK)
    # then give the same bits at any thread count of the host
    with single_threaded():
        for i in range(m + 1):
            lo, hi = bounds[i], bounds[i + 1]
            infos.append(
                analyze_coeff(n, row[lo:hi], col[lo:hi], val[lo:hi], rank_cap, max_eig_support)
            )
    return infos
