"""The port's LP interior-point solver (solver/lpsolve.py) against the JAX
package's on the same numpy data, both on the CPU.

Each step function is held to 1e-12 relative (the scaling, a numpy copy,
bitwise); the regularization ladder must pick the same rung; whole solves
hold the status, the iteration count to +-1, the objectives to 1e-8
relative and the phase that ended the solve.  The switch to the primal
phase depends on a measured factor:solve wall-time ratio, so every solve
pins it: ``primal_switch_ratio=0.0`` lets the primal phase start at the
first iteration that qualifies, ``1e30`` forbids it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdsdp_tpu.solver import lpsolve as jlp
from hdsdp_tpu_torch.solver import lpsolve as tlp

FORBID, FORCE = 1e30, 0.0


def _rel(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t, dtype=np.float64)
    j = np.asarray(j, dtype=np.float64)
    return float(np.max(np.abs(t - j)) / max(np.max(np.abs(j)), 1e-300))


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _feasible_lp(seed, m, n, spread=0.0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    if spread:
        A = A * np.exp(rng.normal(size=(1, n)) * spread)
    x0 = rng.random(n) + 0.5
    b = A @ x0
    c = A.T @ rng.normal(size=m) + rng.random(n) + 0.5
    return A, b, c


@pytest.fixture(scope="module")
def scaled():
    """A scaled LP (the solver's own scaling) and the JAX Mehrotra start."""
    A, b, c = _feasible_lp(11, 12, 30, spread=1.0)
    r, cs = jlp.scale_data(A, "geometric", 10)
    As, bs, cc = A / r[:, None] / cs[None, :], b / r, c / cs
    x, y, s, mu = (np.asarray(v) for v in jlp._mehrotra_start(
        jnp.asarray(As), jnp.asarray(bs), jnp.asarray(cc), 1e-12))
    return dict(A=As, b=bs, c=cc, x=x, y=y, s=s, mu=float(mu))


@pytest.mark.parametrize("method", ["ruiz", "geometric", "l2", "none"])
def test_scale_data(method):
    A, _, _ = _feasible_lp(3, 10, 25, spread=2.0)
    A[2, 5] = 0.0
    A[:, 7] = 0.0  # an empty column keeps its scaler at 1
    rj, cj = jlp.scale_data(A, method, 10)
    rt, ct = tlp.scale_data(A, method, 10)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ct, cj)


def test_mehrotra_start(scaled):
    d = scaled
    outj = jlp._mehrotra_start(jnp.asarray(d["A"]), jnp.asarray(d["b"]),
                               jnp.asarray(d["c"]), 1e-12)
    outt = tlp._mehrotra_start(_t(d["A"]), _t(d["b"]), _t(d["c"]), 1e-12)
    for t, j in zip(outt, outj):
        assert _rel(t, j) < 1e-12


def _pd_args(d, pkg):
    conv = jnp.asarray if pkg is jlp else _t
    return (conv(d["A"]), conv(d["b"]), conv(d["c"]), conv(d["x"]), conv(d["y"]),
            conv(d["s"]), d["mu"], 1e-13, 0.995, 0.995, 1e-14, 1e-12)


@pytest.mark.parametrize("rung", [0, 3])
def test_pd_step(scaled, rung):
    outj = jlp._pd_step(*_pd_args(scaled, jlp), rung)
    xt, yt, st, mut, apt, adt, okt, rungt, vals = tlp._pd_step(*_pd_args(scaled, tlp), rung)
    xj, yj, sj, muj, apj, adj, okj, rungj = outj
    assert okt is bool(okj) is True and rungt == int(rungj) == rung
    for t, j in ((xt, xj), (yt, yj), (st, sj), (mut, muj), (apt, apj), (adt, adj)):
        assert _rel(t, j) < 1e-12
    # the host values of (mu, ap, ad) came in the same read
    assert vals == [float(mut), float(apt), float(adt)]


def test_pd_step_reads_extra_scalars_with_its_own(scaled):
    def extra(x, y, s):
        return (x.sum(), torch.linalg.norm(s))

    x, y, s, *_, vals = tlp._pd_step(*_pd_args(scaled, tlp), 0, extra)
    assert vals[3:] == [float(x.sum()), float(torch.linalg.norm(s))]


@pytest.mark.parametrize("n_inner", [0, 3])
def test_primal_step(scaled, n_inner):
    d = scaled
    d0 = d["x"]
    M0 = (d["A"] * (d0 * d0)[None, :]) @ d["A"].T + 1e-12 * np.eye(d["A"].shape[0])
    L0 = np.linalg.cholesky(M0)
    thresh = 1e-3 / np.linalg.norm(d["A"])

    def args(conv):
        return (conv(d["A"]), conv(d["b"]), conv(d["c"]), conv(d["x"]), conv(d["y"]),
                conv(d["s"]), d["mu"], conv(L0), conv(d0), 2.0, thresh, 0.995, 0.995, 1e-12)

    outj = jlp._primal_step(*args(jnp.asarray), n_inner)
    outt = tlp._primal_step(*args(_t), n_inner)
    for t, j in zip(outt, outj):
        assert _rel(t, j) < 1e-12


def _redundant_system(shift):
    """A A' - shift max(diag) I with two exactly repeated rows of A: the
    smallest eigenvalue is -shift max(diag), so rung k factors once
    1e-14 100^k > shift (with a margin of 3x on either side)."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(8, 20))
    A[6] = A[1]
    A[7] = 2.0 * A[3]
    M = A @ A.T
    return M - shift * np.max(np.diag(M)) * np.eye(8)


@pytest.mark.parametrize("shift,k0,want", [
    (0.0, 0, None),      # singular: the rung is LAPACK's call, held equal
    (3e-12, 0, 2),       # fails rungs 0 and 1
    (3e-10, 0, 3),
    (3e-10, 2, 3),       # carried rung 2 fails, 3 factors
    (3e-10, 3, 3),       # carried rung factors at once
])
def test_factor_ladder_climbs_to_the_same_rung(shift, k0, want):
    M = _redundant_system(shift)
    Lj, okj, kj = jlp._factor_ladder(jnp.asarray(M), k0)
    Lt, okt, kt = tlp._factor_ladder(_t(M), k0)
    assert okt is bool(okj) is True
    assert kt == int(kj)
    if want is not None:  # a regularized, well-defined factor
        assert kt == want
        assert _rel(Lt, Lj) < 1e-10


def test_factor_ladder_reports_failure_of_every_rung():
    M = -np.eye(5)
    Lj, okj, kj = jlp._factor_ladder(jnp.asarray(M), 1)
    Lt, okt, kt = tlp._factor_ladder(_t(M), 1)
    assert okt is bool(okj) is False and kt == int(kj) == 1
    assert bool(torch.isnan(Lt).all())


def _both(A, b, c, **params):
    js = jlp.LPSolver(A, b, c, jlp.LPParams(verbose=False, **params))
    rj = js.optimize()
    ts = tlp.LPSolver(A, b, c, tlp.LPParams(verbose=False, **params), device="cpu")
    rt = ts.optimize()
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert abs(rt.n_iters - rj.n_iters) <= 1
    assert rt.p_obj == pytest.approx(rj.p_obj, rel=1e-8)
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-8)
    assert ts.last_method == js.last_method == rt.last_method
    return js, rj, ts, rt


@pytest.mark.parametrize("ratio", [FORBID, FORCE])
def test_lp_random_feasible(ratio):
    A, b, c = _feasible_lp(0, 30, 80)
    _, _, _, r = _both(A, b, c, primal_switch_ratio=ratio)
    assert r.p_obj == pytest.approx(r.d_obj, rel=1e-7)
    assert np.all(r.x > -1e-9)
    assert np.linalg.norm(A @ r.x - b) < 1e-6 * (1 + np.linalg.norm(b))


@pytest.mark.parametrize("scal", ["ruiz", "geometric", "l2", "none"])
def test_lp_scalings(scal):
    A, b, c = _feasible_lp(3, 10, 25, spread=2.0)
    _both(A, b, c, scal_method=scal, primal_switch_ratio=FORBID)


def test_lp_primal_phase_runs():
    A, b, c = _feasible_lp(7, 40, 100)
    _, _, ts, r = _both(A, b, c, primal_switch_ratio=FORCE)
    assert ts.last_method == "primal"
    assert r.p_obj == pytest.approx(r.d_obj, rel=1e-6)
    assert r.factor_solve_ratio == ts.factor_solve_ratio > 0.0


def test_lp_primal_phase_with_inner_pcg():
    A, b, c = _feasible_lp(7, 40, 100)
    _both(A, b, c, primal_switch_ratio=FORCE, n_inner_cg=2)


RANGED_MPS = """NAME          RANGED
ROWS
 N  COST
 L  R1
 G  R2
 E  R3
COLUMNS
    X1        COST      -1.0   R1   1.0
    X1        R2         1.0   R3   1.0
    X2        COST      -2.0   R1   1.0
    X2        R2        -1.0   R3   2.0
RHS
    RHS       R1         4.0   R2  -1.0
    RHS       R3         3.0
RANGES
    RNG       R1         2.0   R2   3.0
    RNG       R3         {r3}
ENDATA
"""


@pytest.mark.parametrize("r3,obj", [(4.0, -6.5), (-4.0, -3.0)])
def test_lp_ranges_full_semantics(tmp_path, r3, obj):
    path = tmp_path / "ranged.mps"
    path.write_text(RANGED_MPS.format(r3=r3))
    rj = jlp.solve_mps_file(str(path), verbose=False, primal_switch_ratio=FORBID)
    rt = tlp.solve_mps_file(str(path), device="cpu", verbose=False,
                            primal_switch_ratio=FORBID)
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert abs(rt.n_iters - rj.n_iters) <= 1
    assert rt.p_obj == pytest.approx(obj, rel=1e-6)
    assert rt.p_obj == pytest.approx(rj.p_obj, rel=1e-8)
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-8)
    assert rt.last_method == "pd"


def test_lp_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    A, b, c = _feasible_lp(0, 4, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tlp.LPSolver(A, b, c)
    with pytest.raises(RuntimeError, match="cuda"):
        tlp.solve_mps_file(__file__.replace(".py", ".mps"))  # device checked first


def test_unknown_scaling_raises():
    A, b, c = _feasible_lp(0, 4, 8)
    with pytest.raises(ValueError, match="scaling"):
        tlp.LPSolver(A, b, c, tlp.LPParams(scal_method="max"), device="cpu")
