"""The plain reference on tiny instances: its operators against dense
algebra, its optimum against known values, and the certificate."""

import numpy as np
import pytest
import torch

from sdpbench import reference
from sdpbench.generators import maxcut, theta
from sdpbench.sdpa import Block, SDPData


def _dense(d):
    blk = d.blocks[0]
    n = blk.dim
    C, A = np.zeros((n, n)), np.zeros((d.m, n, n))
    for c, r, k, v in zip(blk.con, blk.row, blk.col, blk.val):
        M = C if c == 0 else A[c - 1]
        M[r, k] += v
        if r != k:
            M[k, r] += v
    return C, A


@pytest.mark.parametrize("d", [maxcut.generate(1, n=12, n_edges=20, weights="unit"),
                               theta.generate(2, n=10, n_edges=15)], ids=["maxcut", "theta"])
def test_operators_are_dense_algebra(d):
    C, A = _dense(d)
    p = reference.Problem(d)
    rng = np.random.default_rng(0)
    n = C.shape[0]
    G = rng.normal(size=(n, n))
    y = rng.normal(size=d.m)
    B = rng.normal(size=(n, n))
    X = B @ B.T + np.eye(n)
    Zi = np.linalg.inv(B.T @ B + np.eye(n))
    assert np.allclose(p.C.numpy(), C)
    assert np.allclose(p.A(torch.tensor(G)).numpy(), np.einsum("kij,ij->k", A, G))
    assert np.allclose(p.At(torch.tensor(y)).numpy(), np.einsum("k,kij->ij", y, A))
    M = np.einsum("kab,bc,lcd,da->kl", A, X, A, Zi)
    assert np.allclose(p.schur(torch.tensor(X), torch.tensor(Zi)).numpy(), M)


def test_theta_of_known_graphs():
    # no edges: theta = n; the 5-cycle: theta = sqrt(5) (Lovasz 1979)
    n = 5
    empty = theta.generate(0, n=n, n_edges=0)
    sol = reference.solve(reference.Problem(empty))
    assert sol.status == "optimal" and sol.d_obj == pytest.approx(-n, rel=1e-9)
    i = np.arange(5)
    ei, ej = np.minimum(i, (i + 1) % 5), np.maximum(i, (i + 1) % 5)
    il, jl = np.tril_indices(5)
    c5 = SDPData(m=6, b=np.r_[1.0, np.zeros(5)], blocks=[Block(
        dim=5,
        con=np.concatenate([np.zeros(len(il), np.int32), np.ones(5, np.int32),
                            np.arange(2, 7, dtype=np.int32)]),
        row=np.concatenate([il, np.arange(5), ej]).astype(np.int32),
        col=np.concatenate([jl, np.arange(5), ei]).astype(np.int32),
        val=np.concatenate([-np.ones(len(il)), np.ones(5), np.ones(5)]))])
    sol = reference.solve(reference.Problem(c5))
    assert sol.status == "optimal" and sol.d_obj == pytest.approx(-np.sqrt(5), rel=1e-9)


def test_certificate_of_the_optimum_and_of_a_float32_solve():
    d = maxcut.generate(4, n=40, n_edges=100, weights="unit")
    p = reference.Problem(d)
    sol = reference.solve(p)
    cert = reference.certificate(p, sol.y, sol.X)
    assert sol.status == "optimal"
    assert max(cert.p_infeas, cert.x_neg, cert.s_neg, cert.gap) < 1e-9
    assert cert.d_obj == pytest.approx(sol.d_obj, abs=1e-12)
    low = reference.solve(reference.Problem(d, dtype=torch.float32))
    lc = reference.certificate(p, low.y, low.X)
    assert low.status == "stalled" and lc.gap > 100 * cert.gap
    # an answer that is not dual feasible shows in the slack's eigenvalue
    assert reference.certificate(p, sol.y + 0.1).s_neg > 1e-4
