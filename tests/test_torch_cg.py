"""The port's ops.cg (pcg, refine_solve, AdaptiveCG) against the JAX
package's on identical numpy inputs.  Solutions agree to 1e-10 relative;
the policy is held to the JAX package's sequence of tiers (the ``history``
kinds, factor outcomes and refine statuses, in order), not to exact sweep
counts, which may differ by one between LAPACK builds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdsdp_tpu.ops import cg as jcg
from hdsdp_tpu_torch.ops import cg as tcg


def _rel(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.max(np.abs(t - j)) / max(np.max(np.abs(j)), 1e-300))


def _spd(rng, m, cond):
    """SPD [m, m] with eigenvalues log-spaced over ``cond``."""
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    M = (Q * np.logspace(0, -np.log10(cond), m)) @ Q.T
    return 0.5 * (M + M.T)


@pytest.mark.parametrize("use_chol", [False, True])
@pytest.mark.parametrize("cond", [1e2, 1e5])
def test_pcg(use_chol, cond):
    """Jacobi, and a Cholesky preconditioner of a shifted M: converges only
    with the latter at cond 1e2, else bails out at the stall rule after 22
    steps; same status, step count and iterate in both packages."""
    rng = np.random.default_rng(1)
    m = 50
    M = _spd(rng, m, cond)
    rhs = rng.standard_normal(m)
    pre = np.linalg.cholesky(M + 0.05 * np.diag(np.diag(M))) if use_chol else np.diag(M).copy()
    rj = jcg.pcg(jnp.asarray(M), jnp.asarray(rhs), jnp.asarray(pre), max_iter=200,
                 use_chol=use_chol)
    rt = tcg.pcg(torch.as_tensor(M), torch.as_tensor(rhs), torch.as_tensor(pre), max_iter=200,
                 use_chol=use_chol)
    assert rt.status == int(rj.status)
    assert rt.status == (tcg.STATUS_OK if use_chol and cond < 1e3 else tcg.STATUS_MAXITER)
    assert rt.iters == int(rj.iters) and rt.iters > 3
    assert _rel(rt.x, rj.x) < 1e-6
    assert _rel(rt.resi_norm, rj.resi_norm) < 1e-3


def test_pcg_zero_rhs_and_nan():
    M = torch.eye(4, dtype=torch.float64)
    r = tcg.pcg(M, torch.zeros(4, dtype=torch.float64), torch.ones(4, dtype=torch.float64), 10)
    assert (r.status, r.iters) == (tcg.STATUS_OK, 0)
    bad = M.clone()
    bad[0, 0] = float("nan")
    r = tcg.pcg(bad, torch.ones(4, dtype=torch.float64), torch.ones(4, dtype=torch.float64), 10)
    rj = jcg.pcg(jnp.asarray(bad.numpy()), jnp.ones(4), jnp.ones(4), max_iter=10)
    assert r.status == int(rj.status) == tcg.STATUS_NUMERICAL


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("cond", [1e3, 1e10])
def test_equilibrated_factor_and_refine_solve(f32, cond):
    rng = np.random.default_rng(2)
    m = 60
    M = _spd(rng, m, cond) * np.logspace(0, 3, m)[:, None] * np.logspace(0, 3, m)[None, :]
    B = rng.standard_normal((m, 4))
    Lj, sj, okj = jcg._equilibrated_factor(jnp.asarray(M), f32=f32)
    Lt, st, okt = tcg._equilibrated_factor(torch.as_tensor(M), f32=f32)
    assert bool(okj) == bool(okt)
    assert Lt.dtype == (torch.float32 if f32 else torch.float64)
    assert _rel(st, sj) < 1e-15
    if not bool(okt):
        return
    # one factor (the JAX package's) under both refinements
    L = np.asarray(Lj)
    Xj, stj, itj = jcg.refine_solve(jnp.asarray(M), jnp.asarray(L), sj, jnp.asarray(B))
    Xt, stt, itt = tcg.refine_solve(torch.as_tensor(M), torch.tensor(L), st,
                                    torch.as_tensor(B))
    assert stt == int(stj)
    assert abs(itt - int(itj)) <= 1
    if stt == tcg.STATUS_OK:
        assert _rel(Xt, Xj) < 1e-10 * max(1.0, cond * 1e-9)
        res = np.abs(M @ Xt.numpy() - B).max()
        assert res < 1e-9 * (np.abs(B).max() + np.abs(M).sum(1).max() * np.abs(Xt.numpy()).max())
    assert _rel(tcg.chol_apply(torch.tensor(L), torch.as_tensor(B).to(Lt.dtype)),
                jcg.chol_apply(jnp.asarray(L), jnp.asarray(B).astype(Lj.dtype))) < (
                    1e-3 if f32 else 1e-9) * max(1.0, cond * 1e-9)


def test_fleet_refine_solve_matches_jax_per_member():
    """refine_solve on a fleet of three with the middle member frozen
    (``live``), against the JAX package's refine_solve at its default tiers
    on the same factor, member by member, held as above (status, sweeps
    +-1, X to 1e-10); the frozen member keeps the fleet's first apply and
    takes no sweep."""
    rng = np.random.default_rng(7)
    m = 48
    conds = (1e2, 1e3, 1e4)
    Ms = np.stack([_spd(rng, m, c) for c in conds])
    B = rng.standard_normal((3, m, 2))
    L, s, ok = tcg._equilibrated_factor(torch.as_tensor(Ms))
    assert bool(ok.all())
    Bt = torch.as_tensor(B)
    X, st, it = tcg.refine_solve(torch.as_tensor(Ms), L, s, Bt,
                                 live=np.array([True, False, True]))
    first = s[..., None] * tcg.chol_apply(L, (s[..., None] * Bt).to(L.dtype)).to(torch.float64)
    assert it[1] == 0 and torch.equal(X[1], first[1])
    for k in (0, 2):
        Xj, stj, itj = jcg.refine_solve(jnp.asarray(Ms[k]), jnp.asarray(L[k].numpy()),
                                        jnp.asarray(s[k].numpy()), jnp.asarray(B[k]))
        assert st[k] == int(stj) == tcg.STATUS_OK
        assert abs(int(it[k]) - int(itj)) <= 1
        assert _rel(X[k], Xj) < 1e-10


def _drive(systems, rhs):
    """One sequence of systems through both policies; returns the two
    histories (kind, outcome) and the per-system (ok, X) pairs."""
    ja, ta = jcg.AdaptiveCG(), tcg.AdaptiveCG()
    outs = []
    for M, B in zip(systems, rhs):
        ja.update(jnp.asarray(M))
        ta.update(torch.as_tensor(M))
        Xj, okj = ja.solve_mat_checked(jnp.asarray(M), jnp.asarray(B))
        Xt, okt = ta.solve_mat_checked(torch.as_tensor(M), torch.as_tensor(B))
        outs.append((bool(okj), np.asarray(Xj), bool(okt), Xt.numpy()))

    def kinds(h):
        return [(k, d.split(" it=")[0]) for k, d, _ in h]

    assert (ta.n_factor, ta.n_solve) == (ja.n_factor, ja.n_solve)
    return kinds(ja.history), kinds(ta.history), outs, ja, ta


def test_adaptive_cg_reuses_a_stale_factor():
    """A well-conditioned, slowly drifting sequence is served by one f32
    factor; a shift that the stale factor still solves, but in more than
    ``reuse_threshold`` = 8 sweeps, costs a refresh at the NEXT system; a
    jump that it cannot solve costs one at once."""
    rng = np.random.default_rng(3)
    m = 60
    M0 = _spd(rng, m, 1e3)
    G = rng.standard_normal((m, m))
    G = G @ G.T / m
    shifted = M0 + 2e-4 * np.eye(m)
    systems = ([M0 + k * 1e-6 * G for k in range(5)] + [shifted, shifted + 1e-7 * G]
               + [_spd(rng, m, 1e3) * 50.0])
    rhs = [rng.standard_normal((m, 3)) for _ in systems]
    hj, ht, outs, ja, ta = _drive(systems, rhs)
    assert ht == hj
    assert ht == (
        [("factor32", "ok"), ("refine", "st=0")] + [("refine_stale", "st=0")] * 4
        + [("refine_stale", "st=0")]  # the shift: solved, slowly
        + [("factor32", "ok"), ("refine", "st=0")]  # so the next system refactors
        + [("refine_stale", "st=1"), ("factor32", "ok"), ("refine", "st=0")]  # the jump
    )
    slow = int(ta.history[6][1].split("it=")[1])
    assert slow > 8 and abs(slow - int(ja.history[6][1].split("it=")[1])) <= 1
    for okj, Xj, okt, Xt in outs:
        assert okj and okt
        assert _rel(Xt, Xj) < 1e-10
    assert ta.n_factor == 3 and ta.n_solve == 3 * len(systems)
    sj, st = ja.summary(), ta.summary()
    assert {k: v["n"] for k, v in st.items() if k != "refine_iters"} == \
           {k: v["n"] for k, v in sj.items() if k != "refine_iters"}
    assert abs(st["refine_iters"]["max"] - sj["refine_iters"]["max"]) <= 1


def test_adaptive_cg_escalates_to_f64_and_retries_f32():
    """kappa ~ 1e10 at unit diagonal: the f32 Cholesky fails (torch says so
    through ``info``, JAX through NaNs), the f64 factor takes over, and f64
    stays the first choice for the next 8 systems; after that a refresh
    tries f32 again."""
    rng = np.random.default_rng(4)
    m = 60
    hard = _spd(rng, m, 1e10)
    hard = hard / np.sqrt(np.outer(np.diag(hard), np.diag(hard)))  # unit diagonal
    easy = _spd(rng, m, 1e2)
    systems = [hard] * 2 + [easy] * 8 + [_spd(rng, m, 1e2) * 7.0]
    rhs = [rng.standard_normal((m, 2)) for _ in systems]
    hj, ht, outs, ja, ta = _drive(systems, rhs)
    assert ht == hj
    assert ht == (
        [("factor32", "fail"), ("factor64", "ok"), ("refine", "st=0"), ("refine_stale", "st=0")]
        # the easy matrix arrives while f32 is on hold: f64 again
        + [("refine_stale", "st=1"), ("factor64", "ok"), ("refine", "st=0")]
        + [("refine_stale", "st=0")] * 7
        # the hold has run out: the next refresh is f32
        + [("refine_stale", "st=1"), ("factor32", "ok"), ("refine", "st=0")]
    )
    for okj, Xj, okt, Xt in outs:
        assert okj and okt
    for okj, Xj, okt, Xt in outs[2:]:
        assert _rel(Xt, Xj) < 1e-10
    for (okj, Xj, okt, Xt), M, B in zip(outs[:2], systems, rhs):
        # kappa = 1e10: both solutions are backward stable, equal to ~1e-6
        assert _rel(Xt, Xj) < 1e-5
        bound = np.abs(B).max() + np.abs(M).sum(1).max() * np.abs(Xt).max()
        assert np.abs(M @ Xt - B).max() < 1e-9 * bound


def test_adaptive_cg_reports_failure_on_an_indefinite_system():
    rng = np.random.default_rng(5)
    m = 40
    M = _spd(rng, m, 1e2)
    M = M - 0.05 * np.eye(m)  # indefinite, positive diagonal
    assert np.all(np.diag(M) > 0) and np.linalg.eigvalsh(M).min() < 0
    hj, ht, outs, ja, ta = _drive([M, _spd(rng, m, 1e2)], [rng.standard_normal((m, 1))] * 2)
    assert ht == hj
    assert ht[:2] == [("factor32", "fail"), ("factor64", "fail")]
    okj, _, okt, _ = outs[0]
    assert not okj and not okt
    # the next system is served again, f64 first (the f32 tier is on hold)
    assert outs[1][0] and outs[1][2] and ht[2] == ("factor64", "ok")
    assert _rel(outs[1][3], outs[1][1]) < 1e-10


def test_solve_checked_vector():
    rng = np.random.default_rng(6)
    M = _spd(rng, 30, 1e2)
    b = rng.standard_normal(30)
    x, ok = tcg.AdaptiveCG().solve_checked(torch.as_tensor(M), torch.as_tensor(b))
    assert ok and x.shape == (30,)
    assert _rel(x, np.linalg.solve(M, b)) < 1e-10
