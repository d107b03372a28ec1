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


# -- the tiers the JAX package gates on a TPU, forced on in both packages ----


def _spd_up(m, seed, cond):
    """tests/test_cg.py's matrices: eigenvalues geometric from 1 to cond."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    return Q @ np.diag(np.geomspace(1.0, cond, m)) @ Q.T


@pytest.fixture
def one_thread():
    """The DD tier runs the plain panel factor, thousands of tiny torch
    calls, which stall when every worker of the tier-1 run spins eight
    threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def dd_tier(monkeypatch, one_thread):
    """AdaptiveCG's double-single full-precision tier on in both packages
    (the JAX tests force the gate the same way)."""
    monkeypatch.setattr(jcg, "use_dd_full_tier", lambda m: True)
    monkeypatch.setattr(tcg, "use_dd_full_tier", lambda m: True)


def test_gates_are_off_here_and_open_at_their_thresholds(monkeypatch):
    from hdsdp_tpu_torch.utils import device

    assert not (tcg.use_inverted_precond(10 ** 6) or tcg.use_dd_full_tier(10 ** 6)
                or tcg.use_hp_residual(10 ** 6))
    monkeypatch.setattr(device, "is_tpu", lambda: True)
    assert [tcg.use_inverted_precond(m) for m in (511, 512)] == [False, True]
    assert [tcg.use_dd_full_tier(m) for m in (4095, 4096)] == [False, True]
    assert [tcg.use_hp_residual(m) for m in (8191, 8192)] == [False, True]


def test_adaptive_cg_dd_full_tier(dd_tier):
    """tests/test_cg.py's case in both packages: kappa ~ 1e10 escalates past
    f32 to the DD tier (ops.ddchol, pre-inverted, applied through the Ozaki
    matmul), solves to direct-solve accuracy, and a nearby matrix reuses
    the stale DD factor; the same tiers in the same order as the JAX
    package's, both solutions within 1e-5 of numpy's."""
    m = 80
    M = _spd_up(m, 3, 1e10)
    rhs = np.random.default_rng(4).normal(size=(m, 2))
    ja, ta = jcg.AdaptiveCG(), tcg.AdaptiveCG()
    Xj, okj = ja.solve_mat_checked(jnp.asarray(M), jnp.asarray(rhs))
    Xt, okt = ta.solve_mat_checked(torch.as_tensor(M), torch.as_tensor(rhs))
    assert okj and okt
    assert [(k, d.split(" it=")[0]) for k, d, _ in ta.history] == \
        [(k, d.split(" it=")[0]) for k, d, _ in ja.history]
    assert "factor_dd" in [k for k, _, _ in ta.history]
    X_ref = np.linalg.solve(M, rhs)
    np.testing.assert_allclose(Xt.numpy(), X_ref, rtol=1e-5, atol=1e-6)
    assert _rel(Xt, Xj) < 1e-5
    nf = ta.n_factor
    X2, ok2 = ta.solve_mat_checked(torch.as_tensor(M + 1e-6 * np.eye(m)), torch.as_tensor(rhs))
    assert ok2 and ta.n_factor == nf and ta.chol_fac[2] == "dd"
    np.testing.assert_allclose(X2.numpy(), X_ref, rtol=1e-4, atol=1e-5)


def test_refine_solve_pre_inverted_matches_jax_and_direct():
    """The pre-inverted apply (ops.chol.blocked_tri_inverse + two products)
    against the triangular apply and the JAX package's, m = 600."""
    m, k = 600, 8
    M = _spd_up(m, 9, 1e6)
    B = np.random.default_rng(10).normal(size=(m, k))
    L, s, ok = tcg._equilibrated_factor(torch.as_tensor(M), f32=True)
    Li, si, oki = tcg._equilibrated_factor(torch.as_tensor(M), f32=True, inv=True)
    assert bool(ok) and bool(oki) and Li.dtype == torch.float32
    # the explicit inverse of the f32 factor (the two packages' f32 factors
    # themselves part at ~kappa 2^-24, so only the refined solutions meet)
    assert _rel(Li, torch.linalg.inv(L)) < 1e-5
    Lj, sj, _ = jcg._equilibrated_factor(jnp.asarray(M), f32=True, inv=True)
    Xt, stt, _ = tcg.refine_solve(torch.as_tensor(M), Li, si, torch.as_tensor(B),
                                  pre_inverted=True)
    Xj, stj, _ = jcg.refine_solve(jnp.asarray(M), Lj, sj, jnp.asarray(B), pre_inverted=True)
    assert stt == int(stj) == tcg.STATUS_OK
    X_ref = np.linalg.solve(M, B)
    scale = np.max(np.abs(X_ref))
    np.testing.assert_allclose(Xt.numpy() / scale, X_ref / scale, atol=1e-9)
    np.testing.assert_allclose(np.asarray(Xj) / scale, X_ref / scale, atol=1e-9)


def test_refine_solve_hp_residual_matches_jax_and_direct():
    """The residual through the Ozaki matmul (M sliced once), m = 384: the
    2^-45 acceptance floor still reaches the direct solve's grade."""
    m, k = 384, 5
    M = _spd_up(m, 12, 1e6)
    B = np.random.default_rng(13).normal(size=(m, k))
    L, s, _ = tcg._equilibrated_factor(torch.as_tensor(M), f32=True)
    Xt, stt, _ = tcg.refine_solve(torch.as_tensor(M), L, s, torch.as_tensor(B),
                                  hp_residual=True)
    Lj, sj, _ = jcg._equilibrated_factor(jnp.asarray(M), f32=True)
    Xj, stj, _ = jcg.refine_solve(jnp.asarray(M), Lj, sj, jnp.asarray(B), hp_residual=True)
    assert stt == int(stj) == tcg.STATUS_OK
    X_ref = np.linalg.solve(M, B)
    scale = np.max(np.abs(X_ref))
    np.testing.assert_allclose(Xt.numpy() / scale, X_ref / scale, atol=1e-7)
    np.testing.assert_allclose(np.asarray(Xj) / scale, X_ref / scale, atol=1e-7)


def test_check_time_dd_solve(dd_tier):
    """dimacs._dd_solve_checked against the f64 ladder it short-circuits
    and against the JAX package's; on an indefinite M the factor fails and
    it returns None (the caller's ladder takes over); and its own tier
    guard: with the gate off it returns None instead of assuming its
    caller checked (hdsdp_tpu/solver/dimacs.py:327 does not guard)."""
    from hdsdp_tpu.solver import dimacs as jdm
    from hdsdp_tpu_torch.solver import dimacs as tdm

    m = 96
    M = _spd_up(m, 21, 1e9)
    rhs = np.random.default_rng(22).normal(size=m)
    dy = tdm._dd_solve_checked(torch.as_tensor(M), torch.as_tensor(rhs))
    ok, dy_ref = tdm._chol_solve_ladder(torch.as_tensor(M), torch.as_tensor(rhs))
    assert dy is not None and ok
    dy_j = np.asarray(jdm._dd_solve_checked(jnp.asarray(M), jnp.asarray(rhs)))
    # every one of the three is backward stable (the residual of numpy's
    # direct solve, within 2x), so any two lie within kappa eps = 1.1e-7 of
    # each other, relative to scale (tests/test_cg.py's 1e-9 between the JAX
    # package's pair holds on its LAPACK; the port's pair parts at 3.8e-9)
    x = np.linalg.solve(M, rhs)
    floor = np.abs(M @ x - rhs).max()
    for d in (dy.numpy(), dy_ref.numpy(), dy_j):
        assert np.abs(M @ d - rhs).max() <= 2.0 * floor
    scale = float(dy_ref.abs().max())
    for d in (dy_ref.numpy(), dy_j):
        np.testing.assert_allclose(dy.numpy() / scale, d / scale, atol=1.1e-7)
    bad = _spd_up(64, 31, 1e3) - 5.0 * np.eye(64)
    rb = np.random.default_rng(32).normal(size=64)
    assert tdm._dd_solve_checked(torch.as_tensor(bad), torch.as_tensor(rb)) is None
    assert jdm._dd_solve_checked(jnp.asarray(bad), jnp.asarray(rb)) is None
    tcg.use_dd_full_tier = lambda m: False  # undone by the fixture's monkeypatch
    assert tdm._dd_solve_checked(torch.as_tensor(M), torch.as_tensor(rhs)) is None


def test_uwu_routes(monkeypatch):
    """dimacs._uwu: U W U in f64 by default (bit for bit the product the
    recovery has always taken), and on a TPU at n >= 8192 two Ozaki
    products (routing checked with a stand-in for hpmm and zero-stride
    operands; the product itself is held on the card by chip_smoke.py)."""
    from hdsdp_tpu_torch.ops import hpmm
    from hdsdp_tpu_torch.solver import dimacs as tdm
    from hdsdp_tpu_torch.utils import device

    rng = np.random.default_rng(40)
    U = torch.as_tensor(_spd_up(30, 41, 1e2))[None]
    W = torch.as_tensor(rng.standard_normal((1, 30, 30)))
    assert torch.equal(tdm._uwu(U, W), U @ W @ U)
    calls = []
    monkeypatch.setattr(device, "is_tpu", lambda: True)
    monkeypatch.setattr(hpmm, "hpmm", lambda a, b: calls.append((a.shape, b.shape)) or a)
    assert torch.equal(tdm._uwu(U, W), U @ W @ U) and not calls  # n < 8192
    big = torch.zeros((), dtype=torch.float64).expand(1, 8192, 8192)
    assert tdm._uwu(big, big).shape == (1, 8192, 8192)
    assert calls == [((8192, 8192), (8192, 8192))] * 2


@pytest.mark.parametrize("tier", ["inverted", "hp_residual"])
def test_fused_mp_refine_tiers_match_jax(tier, monkeypatch, one_thread):
    """kkt_mp="on" with a TPU-gated refine tier forced on in both
    packages' fused bodies: the same solve (status, iterations +-1, d_obj
    1e-7).  The problem's shape is used by no other test, so the JAX
    package's program cache cannot hand back a program traced with the
    gates off."""
    from hdsdp_tpu.models import synthetic as jsyn
    from hdsdp_tpu.models.problem import SDPProblem as JProblem
    from hdsdp_tpu.solver.solver import HDSDPSolver as JSolver
    from hdsdp_tpu_torch.models import synthetic as tsyn
    from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
    from hdsdp_tpu_torch.solver.solver import HDSDPSolver as TSolver

    gate = {"inverted": "use_inverted_precond", "hp_residual": "use_hp_residual"}[tier]
    monkeypatch.setattr(jcg, gate, lambda m: True)
    monkeypatch.setattr(tcg, gate, lambda m: True)
    kw = dict(m=23 if tier == "inverted" else 21, block_dims=[9], seed=17)
    over = dict(fused="phase", kkt_mp="on", verbose=False)
    rj = JSolver(JProblem.from_sdpa(jsyn.random_sdpa(**kw)), **over).optimize()
    rt = TSolver(TProblem.from_sdpa(tsyn.random_sdpa(**kw)), device="cpu", **over).optimize()
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert abs(rt.n_iters - rj.n_iters) <= 1
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-7)
