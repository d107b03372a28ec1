"""The plain reference: an SDP's data rebuilt from the benchmark's own COO
arrays, the certificate of an answer, and a plain primal-dual
interior-point method.

Plain PyTorch, in the precision asked for, on the device asked for.  It
imports torch and numpy and nothing of the program: it sees the problem
only through ``sdpbench.sdpa.SDPData`` and an answer only as numbers.

  - ``Problem``: C, b and every A_i of one block.  A constraint with at most
    ``SPARSE_MAX`` entries (both triangles counted) is kept as padded
    entry lists and applied by gathers, any other as a dense [n, n] matrix.
  - ``certificate``: the DIMACS errors of an answer (y, and X where the
    answer has one), worked out from the data: ||A(X) - b||, the most
    negative eigenvalue of X and of the slack C - A'y, and the duality gap.
  - ``solve``: an infeasible primal-dual path-following method with the HKM
    direction and Mehrotra's predictor-corrector (Helmberg, Rendl,
    Vanderbei and Wolkowicz 1996; Kojima, Shindoh and Hara 1997; Mehrotra
    1992), as SDPT3 runs it, without its refinements.  In float64 it gives
    the optimum an answer is held to; in float32 it is the lower-precision
    control that the comparison has to refuse.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# A float32 product may run in TF32 on the card unless this is off; the
# control is float32 proper
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SPARSE_MAX = 8


def _sym(G):
    return 0.5 * (G + G.mT)


class Problem:
    """C, b and the constraints of a one-block SDP, on ``device`` in ``dtype``."""

    def __init__(self, data, device="cpu", dtype=torch.float64):
        if len(data.blocks) != 1:
            raise ValueError("the reference takes one SDP block")
        blk = data.blocks[0]
        self.n, self.m = int(blk.dim), int(data.m)
        self.device, self.dtype = torch.device(device), dtype
        n, m = self.n, self.m
        con = np.asarray(blk.con, np.int64)
        row = np.asarray(blk.row, np.int64)
        col = np.asarray(blk.col, np.int64)
        val = np.asarray(blk.val, np.float64)
        off = row != col
        # both triangles: the entry (r, c, v) of a symmetric A stands for v at
        # (r, c) and at (c, r)
        con = np.concatenate([con, con[off]])
        r_all = np.concatenate([row, col[off]])
        c_all = np.concatenate([col, row[off]])
        val = np.concatenate([val, val[off]])

        C = np.zeros((n, n))
        obj = con == 0
        np.add.at(C, (r_all[obj], c_all[obj]), val[obj])
        self.C = self._t(C)
        self.b = self._t(np.asarray(data.b, np.float64))

        keep = ~obj
        con, r_all, c_all, val = con[keep] - 1, r_all[keep], c_all[keep], val[keep]
        order = np.argsort(con, kind="stable")
        con, r_all, c_all, val = con[order], r_all[order], c_all[order], val[order]
        counts = np.bincount(con, minlength=m)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(len(con)) - start[con]
        sparse = counts <= SPARSE_MAX
        self.idx_s = np.flatnonzero(sparse)
        self.idx_d = np.flatnonzero(~sparse)
        s = max(int(counts[sparse].max()) if sparse.any() else 1, 1)
        slot = np.full(m, -1)
        slot[self.idx_s] = np.arange(len(self.idx_s))
        es = sparse[con]
        ra = np.zeros((len(self.idx_s), s), np.int64)
        cb = np.zeros((len(self.idx_s), s), np.int64)
        v = np.zeros((len(self.idx_s), s))
        ra[slot[con[es]], pos[es]] = r_all[es]
        cb[slot[con[es]], pos[es]] = c_all[es]
        v[slot[con[es]], pos[es]] = val[es]
        self.ra = torch.as_tensor(ra, device=self.device)
        self.cb = torch.as_tensor(cb, device=self.device)
        self.v = self._t(v)
        D = np.zeros((len(self.idx_d), n, n))
        dslot = np.full(m, -1)
        dslot[self.idx_d] = np.arange(len(self.idx_d))
        ed = ~es
        np.add.at(D, (dslot[con[ed]], r_all[ed], c_all[ed]), val[ed])
        self.D = self._t(D)
        self.t_idx_s = torch.as_tensor(self.idx_s, device=self.device)
        self.t_idx_d = torch.as_tensor(self.idx_d, device=self.device)
        # norms the certificate and the starting point use
        a_norm = np.zeros(m)
        a_norm[self.idx_s] = np.sqrt((v ** 2).sum(1))
        a_norm[self.idx_d] = np.sqrt((D ** 2).sum((1, 2)))
        self.a_norm = a_norm
        self.c_one = float(np.abs(C).sum())
        self.b_one = float(np.abs(np.asarray(data.b)).sum())

    def _t(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def A(self, G):
        """<A_i, G> for every i (G need not be symmetric)."""
        out = G.new_zeros(self.m)
        if len(self.idx_s):
            out[self.t_idx_s] = (self.v * G[self.ra, self.cb]).sum(1)
        if len(self.idx_d):
            out[self.t_idx_d] = (self.D * G).sum((1, 2))
        return out

    def At(self, y):
        """sum_i y_i A_i."""
        G = torch.zeros((self.n, self.n), dtype=y.dtype, device=y.device)
        if len(self.idx_s):
            w = self.v * y[self.t_idx_s, None]
            G.index_put_((self.ra.reshape(-1), self.cb.reshape(-1)), w.reshape(-1),
                         accumulate=True)
        if len(self.idx_d):
            G = G + torch.einsum("k,kij->ij", y[self.t_idx_d], self.D)
        return G

    def schur(self, X, Zi):
        """M_ij = <A_i, X A_j Z^-1>, the HKM Schur matrix (symmetric)."""
        M = X.new_zeros((self.m, self.m))
        ns = len(self.idx_s)
        if ns:
            Mss = X.new_zeros((ns, ns))
            for p in range(self.ra.shape[1]):
                Xp, Zp = X[self.ra[:, p]], Zi[self.cb[:, p]]
                for q in range(self.ra.shape[1]):
                    Mss += (self.v[:, p, None] * self.v[None, :, q]) * Xp[:, self.ra[:, q]] \
                        * Zp[:, self.cb[:, q]]
            M[self.t_idx_s[:, None], self.t_idx_s[None, :]] = Mss
        for k in range(len(self.idx_d)):
            G = X @ self.D[k] @ Zi
            col = self.A(G)
            M[:, self.t_idx_d[k]] = col
            M[self.t_idx_d[k], :] = col
        return _sym(M)


# ----------------------------------------------------------------------
# the certificate of an answer
# ----------------------------------------------------------------------


def _lam_min(S):
    return float(torch.linalg.eigvalsh(_sym(S))[0])


@dataclass
class Certificate:
    p_obj: Optional[float]  # <C, X>, None without X
    d_obj: float  # b'y
    p_infeas: Optional[float]  # ||A(X) - b||_2 / (1 + ||b||_1)
    x_neg: Optional[float]  # max(0, -lambda_min(X)) / (1 + ||b||_1)
    s_neg: float  # max(0, -lambda_min(C - A'y)) / (1 + ||C||_1)
    gap: Optional[float]  # |<C, X> - b'y| / (1 + |<C, X>| + |b'y|)


def certificate(prob: Problem, y, X=None) -> Certificate:
    """The DIMACS errors of the answer (y, X) of ``prob``, in ``prob``'s
    precision: the primal residual, the most negative eigenvalue of X and
    of the slack S = C - A'y, and the duality gap (errors 1, 2, 4 and 5 of
    Mittelmann's DIMACS measures; error 3 is nought by S's definition)."""
    y = prob._t(np.asarray(y, np.float64))
    d_obj = float(prob.b @ y)
    s_neg = max(0.0, -_lam_min(prob.C - prob.At(y))) / (1.0 + prob.c_one)
    if X is None:
        return Certificate(None, d_obj, None, None, s_neg, None)
    X = prob._t(np.asarray(X, np.float64))
    p_obj = float((prob.C * X).sum())
    p_infeas = float(torch.linalg.vector_norm(prob.A(X) - prob.b)) / (1.0 + prob.b_one)
    x_neg = max(0.0, -_lam_min(X)) / (1.0 + prob.b_one)
    gap = abs(p_obj - d_obj) / (1.0 + abs(p_obj) + abs(d_obj))
    return Certificate(p_obj, d_obj, p_infeas, x_neg, s_neg, gap)


# ----------------------------------------------------------------------
# the plain interior-point method
# ----------------------------------------------------------------------


@dataclass
class Solution:
    status: str  # "optimal" when every error is under tol, else "stalled"
    p_obj: float
    d_obj: float
    y: np.ndarray
    X: np.ndarray
    err: float  # the largest of the relative gap and infeasibilities
    iterations: int


def _max_step(L, dX):
    """The largest a with L L' + a dX >= 0 (inf if dX >= 0)."""
    W = torch.linalg.solve_triangular(L, dX, upper=False)
    W = torch.linalg.solve_triangular(L, W.mT, upper=False)
    lam = _lam_min(W)
    return float("inf") if lam >= 0.0 else -1.0 / lam


def solve(prob: Problem, tol: float = 1e-10, max_iter: int = 100, gamma: float = 0.95,
          stall: int = 5) -> Solution:
    """Solve ``prob`` in its precision; return the iterate with the smallest
    error seen (the last one, unless the method stalled)."""
    n, m = prob.n, prob.m
    eye = torch.eye(n, dtype=prob.dtype, device=prob.device)
    b = prob.b
    bn = np.abs(b.cpu().numpy())
    c_fro = float(torch.linalg.matrix_norm(prob.C))
    b_two, c_two = float(torch.linalg.vector_norm(b)), c_fro
    xi = max(10.0, np.sqrt(n), float(n * np.max((1.0 + bn) / (1.0 + prob.a_norm))))
    eta = max(10.0, np.sqrt(n), 1.0 + max(float(prob.a_norm.max()), c_fro))
    X, Z = xi * eye, eta * eye
    y = torch.zeros(m, dtype=prob.dtype, device=prob.device)
    best, since_best, it = None, 0, 0
    for it in range(max_iter + 1):
        rp = b - prob.A(X)
        Rd = prob.C - prob.At(y) - Z
        p_obj, d_obj = float((prob.C * X).sum()), float(b @ y)
        err = max(abs(p_obj - d_obj) / (1.0 + abs(p_obj) + abs(d_obj)),
                  float(torch.linalg.vector_norm(rp)) / (1.0 + b_two),
                  float(torch.linalg.matrix_norm(Rd)) / (1.0 + c_two))
        if not np.isfinite(err):
            break
        if best is None or err < best[0]:
            best, since_best = (err, p_obj, d_obj, y.clone(), X.clone(), it), 0
        else:
            since_best += 1
        if err < tol or since_best >= stall or it == max_iter:
            break
        LZ, info = torch.linalg.cholesky_ex(Z)
        LX, info_x = torch.linalg.cholesky_ex(X)
        if int(info) or int(info_x):
            break
        Zi = torch.cholesky_inverse(LZ)
        LM, info = torch.linalg.cholesky_ex(prob.schur(X, Zi))
        if int(info):
            break
        XRZ = X @ Rd @ Zi
        mu = float((X * Z).sum()) / n

        def direction(R):
            rhs = rp - prob.A(R - XRZ)
            dy = torch.cholesky_solve(rhs[:, None], LM)[:, 0]
            dZ = _sym(Rd - prob.At(dy))
            dX = _sym(R - X @ dZ @ Zi)
            return dX, dy, dZ

        def steps(dX, dZ, g):
            return min(1.0, g * _max_step(LX, dX)), min(1.0, g * _max_step(LZ, dZ))

        dXa, _, dZa = direction(-X)
        ap, ad = steps(dXa, dZa, 1.0)
        mu_aff = float(((X + ap * dXa) * (Z + ad * dZa)).sum()) / n
        sigma = min(1.0, max(0.0, mu_aff / mu)) ** 3
        dX, dy, dZ = direction(sigma * mu * Zi - X - dXa @ dZa @ Zi)
        ap, ad = steps(dX, dZ, gamma)
        X = _sym(X + ap * dX)
        y = y + ad * dy
        Z = _sym(Z + ad * dZ)
    err, p_obj, d_obj, y, X, it = best
    return Solution("optimal" if err < tol else "stalled", p_obj, d_obj,
                    y.double().cpu().numpy(), X.double().cpu().numpy(), err, it)
