"""``analyze_block`` (stacked eigendecompositions, rank certificate)
against the plain per-matrix ``analyze_coeff``.

Every field of every ``CoeffInfo`` is equal bit for bit, with one
exception: a matrix the certificate proved dense records its support size
as ``rank``, where the plain path records the computed rank; both exceed
``rank_cap``, and the dense matrices are equal.
"""

import numpy as np
import pytest

from hdsdp_tpu_torch.models import coeffs
from hdsdp_tpu_torch.models import synthetic as syn
from hdsdp_tpu_torch.utils import profile

RANK_CAP = 8
FIELDS = ("n", "nnz", "ref_type", "rank", "lam", "vecs", "dense", "abs_norm", "fro_norm",
          "is_eye_multiple", "unit_col")


def _plain(n, m, con, row, col, val, rank_cap=RANK_CAP, max_eig_support=2048):
    order = np.argsort(con, kind="stable")
    con, row, col, val = con[order], row[order], col[order], val[order]
    b = np.searchsorted(con, np.arange(m + 2))
    with coeffs.single_threaded():
        return [coeffs.analyze_coeff(n, row[b[i]:b[i + 1]], col[b[i]:b[i + 1]],
                                     val[b[i]:b[i + 1]], rank_cap, max_eig_support)
                for i in range(m + 1)]


def _assert_same(got, want, rank_cap=RANK_CAP):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            if f == "rank" and g.lam is None and g.dense is not None:
                assert a > rank_cap and b > rank_cap, (i, a, b)
            elif isinstance(b, np.ndarray):
                assert isinstance(a, np.ndarray), (i, f)
                assert (a.dtype, a.shape) == (b.dtype, b.shape), (i, f)
                assert np.array_equal(a, b), (i, f)
            else:
                assert type(a) is type(b) and a == b, (i, f, a, b)


def _check(n, m, con, row, col, val, **kw):
    got = coeffs.analyze_block(n, m, con, row, col, val, kw.get("rank_cap", RANK_CAP),
                               kw.get("max_eig_support", 2048))
    _assert_same(got, _plain(n, m, con, row, col, val, **kw), kw.get("rank_cap", RANK_CAP))
    return got


FAMILIES = {
    "maxcut": lambda: syn.maxcut_sdpa(n=200, seed=0),
    "theta": lambda: syn.theta_sdpa(n=300, n_edges=4374, seed=0),
    "gpp": lambda: syn.gpp_sdpa(n=100, seed=0),
    "control": lambda: syn.control_sdpa(),
    "torus": lambda: syn.torus_sdpa(),
    "qpg": lambda: syn.qpg_sdpa(),
    "random": lambda: syn.random_sdpa(),
    "random_sparse_lp": lambda: syn.random_sdpa(m=40, block_dims=[30, 12], n_lp=3,
                                                density=0.05, seed=4),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_families_match_plain(family):
    data = FAMILIES[family]()
    for blk in data.blocks:
        _check(blk.dim, data.m, blk.con, blk.row, blk.col, blk.val)


def _coo(mats, n):
    """Lower-triangle COO of dense symmetric matrices, constraint 0 first."""
    cons, rows, cols, vals = [], [], [], []
    il, jl = np.tril_indices(n)
    for i, A in enumerate(mats):
        v = A[il, jl]
        keep = v != 0.0
        cons.append(np.full(int(keep.sum()), i, np.int32))
        rows.append(il[keep].astype(np.int32))
        cols.append(jl[keep].astype(np.int32))
        vals.append(v[keep])
    return tuple(np.concatenate(x) for x in (cons, rows, cols, vals))


def _low_rank(rng, n, support, eigs):
    """sum_k eigs[k] u_k u_k' with orthonormal u_k on ``support``."""
    U = np.zeros((n, len(eigs)))
    U[support] = np.linalg.qr(rng.standard_normal((len(support), len(eigs))))[0]
    return (U * eigs) @ U.T


def _hand_zero():
    rng = np.random.default_rng(1)
    A = np.zeros((3, 12, 12))
    A[0] = np.diag(rng.standard_normal(12))
    A[2, 4, 1] = A[2, 1, 4] = 0.5
    con, row, col, val = _coo(A, 12)  # matrix 1 has no entry
    return dict(n=12, m=2, con=con, row=row, col=col, val=val)


def _hand_duplicates():
    # repeated entries summed, one pair cancelling to an exact zero
    con = np.array([0, 0, 1, 1, 1, 2, 2, 2, 3, 3], np.int32)
    row = np.array([0, 0, 3, 3, 5, 2, 2, 4, 1, 1], np.int32)
    col = np.array([0, 0, 3, 3, 1, 2, 2, 0, 1, 1], np.int32)
    val = np.array([1.0, 2.0, 0.1, 0.2, 0.3, 1.0, -1.0, 0.0, 1e-3, 1e-3])
    return dict(n=6, m=3, con=con, row=row, col=col, val=val)


def _hand_wide_support():
    # support 20 above max_eig_support = 16: kept dense without a decomposition
    rng = np.random.default_rng(2)
    B = rng.standard_normal((20, 20))
    A = np.zeros((3, 24, 24))
    A[1, :20, :20] = B + B.T
    A[2] = _low_rank(rng, 24, np.arange(2, 8), [1.0, -2.0])
    con, row, col, val = _coo(A, 24)
    return dict(n=24, m=2, con=con, row=row, col=col, val=val, max_eig_support=16)


def _hand_rank2_support30():
    # rank 2 over support 30: the certificate fails, the factors are kept
    rng = np.random.default_rng(3)
    A = np.zeros((2, 40, 40))
    A[1] = _low_rank(rng, 40, np.arange(5, 35), [3.0, -0.5])
    con, row, col, val = _coo(A, 40)
    return dict(n=40, m=1, con=con, row=row, col=col, val=val)


HAND = {
    "zero_matrix": _hand_zero,
    "duplicate_entries": _hand_duplicates,
    "support_above_max_eig_support": _hand_wide_support,
    "rank2_dense_support30": _hand_rank2_support30,
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_hand_made_blocks_match_plain(case):
    _check(**HAND[case]())


def _one_matrix(eigs, n=80, support=60, scale=1.0, seed=5):
    rng = np.random.default_rng(seed)
    A = np.zeros((2, n, n))
    A[0] = np.eye(n)
    A[1] = scale * _low_rank(rng, n, rng.permutation(n)[:support], np.asarray(eigs))
    return _coo(A, n)


# (eigenvalues, low-rank after analysis, certificate proves it dense)
CERTIFICATE = {
    "rank_cap": ([1.0, -2.0, 3.0, 0.5, -1.5, 2.5, 1.0, 4.0], True, False),
    "rank_cap_plus_1": ([1.0, -2.0, 3.0, 0.5, -1.5, 2.5, 1.0, 4.0, -3.0], False, None),
    "straddling_low_rank": ([1.0] * 8 + [1e-11] * 30, True, False),
    "straddling_dense": ([1.0] * 12 + [1e-11] * 30, False, None),
}


@pytest.mark.parametrize("case", sorted(CERTIFICATE))
def test_certificate_keeps_the_plain_bucketing(case):
    eigs, low_rank, proven = CERTIFICATE[case]
    scale = 1e6 if case.startswith("straddling") else 1.0
    con, row, col, val = _one_matrix(eigs, scale=scale)
    with profile.recording() as rec:
        got = _check(80, 1, con, row, col, val)
    info = got[1]
    assert (info.lam is not None) == low_rank and (info.dense is not None) == (not low_rank)
    if low_rank:
        assert info.rank <= RANK_CAP
    else:
        assert info.rank > RANK_CAP
    if proven is not None:  # the identity objective is proven either way
        assert rec.counters.get("analyze_eigh_skipped", 0) == 1 + proven
        assert rec.counters.get("analyze_eigh_fallback", 0) == 1 - proven


def test_counters_maxcut():
    data = syn.maxcut_sdpa(n=200, seed=0)
    blk = data.blocks[0]
    with profile.recording() as rec:
        infos = coeffs.analyze_block(blk.dim, data.m, blk.con, blk.row, blk.col, blk.val,
                                     RANK_CAP)
    sizes = {len(np.unique(np.concatenate([blk.row[blk.con == i], blk.col[blk.con == i]])))
             for i in range(data.m + 1)} - {0}
    assert rec.counters["analyze_eigh_skipped"] == 1  # C, the Laplacian
    assert rec.counters.get("analyze_eigh_fallback", 0) == 0
    assert 1 <= rec.counters["analyze_eigh_calls"] <= len(sizes)
    assert infos[0].dense is not None and infos[0].lam is None


def test_no_eigh_of_a_maxcut_objective_above_the_eig_support(monkeypatch):
    """maxG55's shape (C's support 5000 > max_eig_support 2048), cut to
    n = 300 against a support cap of 256: C is bucketed dense with neither
    an eigh nor a certificate; the one stacked eigh is of the X_ii rows."""
    calls = []
    real = np.linalg.eigh

    def counting(a, *args, **kw):
        calls.append(np.shape(a))
        return real(a, *args, **kw)

    monkeypatch.setattr(coeffs.np.linalg, "eigh", counting)
    data = syn.maxcut_sdpa(n=300, seed=1)
    blk = data.blocks[0]
    with profile.recording() as rec:
        infos = _check(blk.dim, data.m, blk.con, blk.row, blk.col, blk.val, max_eig_support=256)
    assert rec.counters == {"analyze_eigh_calls": 1}
    assert calls[0] == (300, 1, 1) and all(c[-1] == 1 for c in calls)
    assert infos[0].dense is not None and infos[0].lam is None and infos[0].rank == 300


def test_counters_theta():
    data = syn.theta_sdpa(n=300, n_edges=4374, seed=0)
    blk = data.blocks[0]
    with profile.recording() as rec:
        infos = coeffs.analyze_block(blk.dim, data.m, blk.con, blk.row, blk.col, blk.val,
                                     RANK_CAP)
    # C = -J has rank 1: its certificate fails and it keeps its factor;
    # the identity row (support 300) is proven dense
    assert rec.counters["analyze_eigh_fallback"] == 1
    assert rec.counters["analyze_eigh_skipped"] == 1
    assert infos[0].rank == 1 and infos[0].lam is not None
    assert infos[1].is_eye_multiple == 1.0 and infos[1].dense is not None


def test_theta_makes_few_eigh_calls(monkeypatch):
    calls = []
    real = np.linalg.eigh

    def counting(a, *args, **kw):
        calls.append(np.shape(a))
        return real(a, *args, **kw)

    monkeypatch.setattr(coeffs.np.linalg, "eigh", counting)
    data = syn.theta_sdpa(n=300, n_edges=4374, seed=0)
    blk = data.blocks[0]
    coeffs.analyze_block(blk.dim, data.m, blk.con, blk.row, blk.col, blk.val, RANK_CAP)
    assert 0 < len(calls) < 10, calls  # one per support size, not one per matrix
