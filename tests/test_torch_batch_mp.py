"""solve_batch with kkt_mp="on" (hdsdp_tpu_torch.solver.batch over the
fused bodies' mixed-precision Schur backend) against the JAX package, on
the CPU.

The JAX package keeps ``need64`` traced in its fused ``_factor_m_mp``, so
under ``jax.vmap`` every instance of a fleet decides on its own whether
the f32 equilibrated factor with its probe refinement suffices or the f64
ladder is needed, and ``solve_m`` selects per instance.  The port reads
that decision per instance on the host: the fleet's factor and solve of
a stack of one well-conditioned M and one M of condition ~1e10 (whose
members take different branches) are held bit for bit to each member's
solo call and to ``jax.vmap`` over the JAX functions (1e-12; the f64
branch's member as a backward-stable solve of its condition), with the
same ``need64``; end to end, a fleet of three maxcut instances with
kkt_mp="on" is held to the JAX package's solve_batch (status, iterations
+-1, d_obj 1e-7) and to the port's solo solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.models.synthetic import maxcut_sdpa as jmaxcut
from hdsdp_tpu.solver import fused as jfused
from hdsdp_tpu.solver.batch import solve_batch as jsolve_batch
from hdsdp_tpu_torch import solve_batch
from hdsdp_tpu_torch.models.problem import SDPProblem
from hdsdp_tpu_torch.models.synthetic import maxcut_sdpa
from hdsdp_tpu_torch.ops import cg as cg_ops
from hdsdp_tpu_torch.solver import fused
from hdsdp_tpu_torch.solver.solver import HDSDPSolver

M_SIZE = 48
CONDS = (1e2, 1e10)  # the f32 refinement carries the first, not the second


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _spd(m, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    M = (Q * np.logspace(0, -np.log10(cond), m)) @ Q.T
    return (M + M.T) / 2


def _colnorm(A):
    return float(np.max(np.linalg.norm(A.reshape(A.shape[0], -1), axis=0)))


def _accept_level(M, B, X, tol=1e-10):
    """The residual (largest column 2-norm) below which ops.cg.refine_solve
    accepts X at its default tolerances: max(abs_tol, rel_tol |B|, 16 eps
    (|B| + |M|_inf |X|))."""
    bnorm, mnorm = _colnorm(B), float(np.max(np.abs(M).sum(1)))
    return max(tol, tol * bnorm, 16.0 * 2.0 ** -52 * (bnorm + mnorm * _colnorm(X)))


def _cones(fleet):
    lead = (fleet,) if fleet else ()
    z = torch.zeros(lead + (M_SIZE,), dtype=torch.float64)
    return fused.Cones(groups=(), lp=None, b=z, bound_lo=z, bound_up=z,
                       cfg=fused.Config(mp=True), fleet=fleet)


@pytest.fixture(scope="module")
def factor_runs():
    Ms = np.stack([_spd(M_SIZE, c, seed=k) for k, c in enumerate(CONDS)])
    rhs = np.random.default_rng(5).normal(size=(len(CONDS), M_SIZE, 3))
    Mt, rt = torch.as_tensor(Ms), torch.as_tensor(rhs)
    c = _cones(len(CONDS))
    Lm, ok = fused._factor_m_mp(c, Mt)
    fleet = {"need64": np.asarray(Lm[4]), "ok": ok.numpy(),
             "X": fused.solve_m(c, Lm, rt).numpy(), "x": fused.solve_m(c, Lm, rt[..., 0]).numpy(),
             "mp_f64": np.asarray(c.mp_f64), "mp_factors": np.asarray(c.mp_factors)}
    solos = []
    for k in range(len(CONDS)):
        c1 = _cones(0)
        Lm1, ok1 = fused._factor_m_mp(c1, Mt[k])
        solos.append({"need64": Lm1[4], "ok": bool(ok1), "X": fused.solve_m(c1, Lm1, rt[k]).numpy(),
                      "x": fused.solve_m(c1, Lm1, rt[k, :, 0]).numpy()})
    return Ms, rhs, fleet, solos


def test_fleet_splits_between_the_branches(factor_runs):
    _, _, fleet, _ = factor_runs
    assert fleet["need64"].tolist() == [False, True]
    assert fleet["ok"].all()
    assert fleet["mp_f64"].tolist() == [0, 1] and fleet["mp_factors"].tolist() == [1, 1]


def test_fleet_factor_and_solve_repeat_the_solo_calls(factor_runs):
    """Each member of the split fleet is its solo call, bit for bit."""
    _, _, fleet, solos = factor_runs
    for k, solo in enumerate(solos):
        assert bool(fleet["need64"][k]) == solo["need64"]
        assert bool(fleet["ok"][k]) == solo["ok"]
        np.testing.assert_array_equal(fleet["X"][k], solo["X"])
        np.testing.assert_array_equal(fleet["x"][k], solo["x"])


def test_fleet_factor_and_solve_match_jax_vmap(factor_runs, monkeypatch):
    """Against jax.vmap of the JAX package's own _factor_m_mp and solve_m:
    need64 equal per member.  The refined member (condition 1e2) is held to
    refine_solve's own acceptance: its residual below the level at which
    the refinement stops (``_accept_level``), and so within twice that
    level times cond (|M^-1| = cond here, M's largest eigenvalue being 1)
    of JAX's, which stops by the same rule.  The two f32 factors that drive
    the sweeps round by host (torch's MKL and XLA), so the two stop at
    different remainders below that level: the port's differed from JAX's
    by 7.8e-11 against a scale of 75 on one CPU.  The member on the f64
    branch (condition 1e10) is held
    as two backward-stable solves can be: its residual within 1e-12 of
    |M| |x|, and the two solutions within 1e-14 times the condition of
    their scale (two LAPACK solves of it differ by ~4e-8 relative)."""
    Ms, rhs, fleet, _ = factor_runs
    monkeypatch.setitem(jfused._KKT_CFG, "mp", True)

    def factor(M):
        (_, L32, s, Lf64, need64, _, _), ok = jfused._factor_m_mp(M)
        return L32, s, Lf64, need64, ok

    def solve(M, L32, s, Lf64, need64, r):
        return jfused.solve_m((M, L32, s, Lf64, need64, False, False), r)

    Mj, rj = jnp.asarray(Ms), jnp.asarray(rhs)
    L32, s, Lf64, need64, ok = jax.vmap(factor)(Mj)
    assert np.asarray(need64).tolist() == fleet["need64"].tolist()
    assert np.asarray(ok).all()
    for got, r in ((fleet["X"], rj), (fleet["x"], rj[..., 0])):
        want = np.asarray(jax.vmap(solve)(Mj, L32, s, Lf64, need64, r))
        r = np.asarray(r)
        for k, cond in enumerate(CONDS):
            scale = max(1.0, float(np.max(np.abs(want[k]))))
            err = float(np.max(np.abs(got[k] - want[k])))
            if not fleet["need64"][k]:
                level = _accept_level(Ms[k], r[k], got[k])
                assert _colnorm(Ms[k] @ got[k] - r[k]) <= level
                assert err <= 2.0 * cond * level
                continue
            res = float(np.max(np.abs(Ms[k] @ got[k] - r[k])))
            assert res <= 1e-12 * float(np.max(np.abs(Ms[k]).sum(1))) * scale
            assert err <= 1e-14 * cond * scale


def test_refine_solve_freezes_finished_members():
    """A fleet's refinement: each member's X, status and sweeps are its
    solo refinement's, whichever member stops first; a member outside
    ``live`` is not swept."""
    Ms = torch.as_tensor(np.stack([_spd(M_SIZE, c, seed=k) for k, c in
                                   enumerate((1e1, 1e4, 3e6))]))
    B = torch.as_tensor(np.random.default_rng(2).normal(size=(3, M_SIZE, 2)))
    L, s, ok = cg_ops._equilibrated_factor(Ms)
    assert ok.all()
    X, st, it = cg_ops.refine_solve(Ms, L, s, B, max_iter=30)
    for k in range(3):
        Lk, sk, _ = cg_ops._equilibrated_factor(Ms[k])
        Xk, stk, itk = cg_ops.refine_solve(Ms[k], Lk, sk, B[k], max_iter=30)
        np.testing.assert_array_equal(X[k].numpy(), Xk.numpy())
        assert (int(st[k]), int(it[k])) == (stk, itk)
    assert len(set(it.tolist())) == 3  # the members stop at different sweeps
    _, st2, it2 = cg_ops.refine_solve(Ms, L, s, B, max_iter=30,
                                      live=np.array([True, False, True]))
    assert it2[1] == 0 and it2[0] == it[0] and it2[2] == it[2]


SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def fleet_runs():
    jr = jsolve_batch([JProblem.from_sdpa(jmaxcut(n=30, seed=s)) for s in SEEDS],
                      kkt_mp="on", verbose=False)
    probs = [SDPProblem.from_sdpa(maxcut_sdpa(n=30, seed=s)) for s in SEEDS]
    tr = solve_batch(probs, device="cpu", kkt_mp="on")
    solo = [HDSDPSolver(p, device="cpu", verbose=False, kkt_mp="on").optimize() for p in probs]
    return jr, tr, solo


def test_mp_fleet_matches_jax_solve_batch(fleet_runs):
    jr, tr, _ = fleet_runs
    for a, b in zip(tr, jr):
        assert a.status == b.status == "PRIMAL_DUAL_OPTIMAL"
        assert abs(a.n_iters - b.n_iters) <= 1
        assert a.d_obj == pytest.approx(b.d_obj, rel=1e-7)


def test_mp_fleet_matches_its_solo_solves(fleet_runs):
    """Every member finishes in the fleet, on the mixed-precision backend,
    at its solo kkt_mp="on" solve's status, iterations and d_obj."""
    _, tr, solo = fleet_runs
    for a, b in zip(tr, solo):
        assert a.stats["batch_solo"] == 0 and a.stats["fused"] == "batch"
        assert a.stats["mp_factors"] > 0
        assert 0 <= a.stats["mp_f64_factors"] <= a.stats["mp_factors"]
        assert b.stats["mp_factors"] > 0
        assert a.status == b.status
        assert abs(a.n_iters - b.n_iters) <= 1
        assert a.d_obj == pytest.approx(b.d_obj, rel=1e-7)
