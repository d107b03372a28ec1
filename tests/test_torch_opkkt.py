"""Operator mode of the port (the matrix-free Schur operator, its PCG pair,
the row-chunked f32 Cholesky preconditioner, the CG ladder of the host loop,
PSDP's operator branch and the matrix-free DIMACS re-solve) against the JAX
package on identical inputs, on the CPU.

Tolerances.  f64 operator functions: 1e-12 of max|M| against JAX (the two
packages order their sums differently) and 1e-9 of max|M| against the port's
own dense M (the hold of the JAX package's operator tests).  PCG: X to 1e-9
relative and the same step count.  ``factor_scaled_f32``: 1e-4 of max|Linv|
(f32 rounding, 6e-8, times the condition number of the test matrix, below
1e3).  End to end: status equal, d_obj to 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.ops import cg as jcg
from hdsdp_tpu.solver import cones as jcones
from hdsdp_tpu.solver import psdp as jpsdp
from hdsdp_tpu.solver.solver import HDSDPSolver as JSolver
from hdsdp_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
from hdsdp_tpu_torch.ops import cg as tcg
from hdsdp_tpu_torch.ops import schur as tschur
from hdsdp_tpu_torch.solver import algo as talgo
from hdsdp_tpu_torch.solver import cones as tcones
from hdsdp_tpu_torch.solver import dimacs as tdimacs
from hdsdp_tpu_torch.solver import psdp as tpsdp
from hdsdp_tpu_torch.solver.params import Params
from hdsdp_tpu_torch.solver.solver import HDSDPSolver as TSolver

CASES = {
    # name: (generator, kwargs, bucket, row-chunkable)
    "maxcut120": ("maxcut_sdpa", dict(n=120), "diag", True),  # identity map
    "qpg60": ("qpg_sdpa", dict(n=60), "diag", True),  # position map + LP cone
    "theta60": ("theta_sdpa", dict(n=60, n_edges=400), "support", True),  # + dense identity row
    "gpp30": ("gpp_sdpa", dict(n=30, seed=0), "slot", True),  # + dense all-ones row
    "control6": ("control_sdpa", dict(k=6, n_sys=2, seed=0), "flat", False),
}
CHUNK = 48


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side of this file is hundreds of thousands of tiny torch
    calls (m <= 401): one thread runs them as fast as eight, and does not
    stall when other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _problems(name):
    gen, kw = CASES[name][:2]
    return (JProblem.from_sdpa(getattr(jsyn, gen)(**kw)),
            TProblem.from_sdpa(getattr(tsyn, gen)(**kw)))


@pytest.fixture(scope="module", params=sorted(CASES))
def point(request):
    """Both cone systems at one random interior point, with the dense KKT
    of each package and the inverses the operator functions take."""
    name = request.param
    jp, tp = _problems(name)
    m = jp.m
    rng = np.random.default_rng(3)
    y = rng.normal(size=m) * 0.01
    shift = 10.0 + jp.features.obj_fro_norm
    jc = jcones.ConeSystem(jp)
    S, s_lp = jc.assemble(1.0, -1.0, jnp.asarray(y), shift)
    ok, L = jc.factor(S, s_lp)
    assert bool(ok)
    j = dict(cs=jc, s_lp=s_lp, Us=jc.inverses(L), kkt=jc.build_kkt(L, s_lp, -1.3, "hsd"))
    tc = tcones.ConeSystem(tp, "cpu")
    S, s_lp = tc.assemble(1.0, -1.0, torch.as_tensor(y), shift)
    ok, L = tc.factor(S, s_lp)
    assert bool(ok)
    t = dict(cs=tc, s_lp=s_lp, Us=tc.inverses(L), kkt=tc.build_kkt(L, s_lp, -1.3, "hsd"))
    M = _np(t["kkt"].M)
    return dict(name=name, m=m, j=j, t=t, M=M, scale=max(1.0, np.abs(M).max()),
                V=rng.normal(size=(m, 3)), extra=rng.uniform(0.5, 2.0, size=m))


def test_case_takes_its_bucket(point):
    t, j = point["t"], point["j"]
    assert [tschur.bucket(g) for g in t["cs"].groups] == [CASES[point["name"]][2]]
    assert t["cs"].kkt_rows_supported() == j["cs"].kkt_rows_supported() == CASES[point["name"]][3]


def test_build_kkt_rhs(point):
    t, j = point["t"], point["j"]
    rt = t["cs"].build_kkt_rhs(t["Us"], t["s_lp"], -1.3, "hsd")
    rj = j["cs"].build_kkt_rhs(j["Us"], j["s_lp"], -1.3, "hsd")
    assert rt.M is None
    for f in ("asinv", "asinvrdsinv", "asinvcsinv"):
        a, b, d = _np(getattr(rt, f)), _np(getattr(rj, f)), _np(getattr(t["kkt"], f))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * max(1.0, np.abs(b).max()))
        np.testing.assert_allclose(a, d, rtol=1e-10, atol=1e-10)
    for f in ("csinv", "csinvcsinv", "csinvrdsinv", "trace_sinv"):
        assert float(getattr(rt, f)) == pytest.approx(float(getattr(rj, f)), rel=1e-12, abs=1e-12)
        assert float(getattr(rt, f)) == pytest.approx(float(getattr(t["kkt"], f)), rel=1e-10,
                                                      abs=1e-12)


def test_kkt_matvec(point):
    t, j, V, scale = point["t"], point["j"], point["V"], point["scale"]
    extra = point["extra"]
    MVt = _np(t["cs"].kkt_matvec(t["Us"], t["s_lp"], torch.as_tensor(extra), torch.as_tensor(V)))
    MVj = _np(j["cs"].kkt_matvec(j["Us"], j["s_lp"], jnp.asarray(extra), jnp.asarray(V)))
    np.testing.assert_allclose(MVt, MVj, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(MVt, (point["M"] + np.diag(extra)) @ V, rtol=0, atol=1e-9 * scale)
    # a column's product does not depend on how many columns go with it
    for i in range(V.shape[1]):
        one = t["cs"].kkt_matvec(t["Us"], t["s_lp"], torch.as_tensor(extra),
                                 torch.as_tensor(V[:, i:i + 1]))
        np.testing.assert_array_equal(_np(one)[:, 0], MVt[:, i])


def test_kkt_diag(point):
    t, j, scale = point["t"], point["j"], point["scale"]
    dt = _np(t["cs"].kkt_diag(t["Us"], t["s_lp"]))
    np.testing.assert_allclose(dt, _np(j["cs"].kkt_diag(j["Us"], j["s_lp"])), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(dt, np.diag(point["M"]), rtol=0, atol=1e-9 * scale)


def test_kkt_rows_every_chunk(point):
    """All chunks, the overlapping last one included (120, 61, 401 and 31
    rows are no multiples of 48), with the diagonal bound/reg terms."""
    t, j, m, scale = point["t"], point["j"], point["m"], point["scale"]
    extra = point["extra"]
    if not CASES[point["name"]][3]:
        assert tschur.group_schur_rows(t["cs"].groups[0], t["Us"][0], 0, 4, m) is None
        with pytest.raises(ValueError, match="flat"):
            t["cs"].kkt_rows(t["Us"], t["s_lp"], torch.as_tensor(extra), 0, 4)
        return
    chunk = min(CHUNK, m)
    starts = tcones.chunk_starts(m, chunk)
    assert starts[-1] == m - chunk and all(i0 + chunk <= m for i0 in starts)
    got = np.zeros((m, m))
    for i0 in starts:
        rt = _np(t["cs"].kkt_rows(t["Us"], t["s_lp"], torch.as_tensor(extra), i0, chunk))
        rj = _np(j["cs"].kkt_rows(j["Us"], j["s_lp"], jnp.asarray(extra), i0, chunk))
        np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-12 * scale)
        got[i0:i0 + chunk] = rt
    np.testing.assert_allclose(got, point["M"] + np.diag(extra), rtol=0, atol=1e-9 * scale)


def test_kkt_full_from_rows(point):
    t, j, m, scale = point["t"], point["j"], point["m"], point["scale"]
    if not CASES[point["name"]][3]:  # the flat layout has no row-chunked build
        with pytest.raises(ValueError, match="flat"):
            t["cs"].kkt_full_from_rows(t["Us"], t["s_lp"], torch.zeros(m, dtype=torch.float64))
        return
    Mt = _np(t["cs"].kkt_full_from_rows(t["Us"], t["s_lp"], torch.zeros(m, dtype=torch.float64),
                                        chunk=CHUNK))
    Mj = _np(j["cs"].kkt_full_from_rows(j["Us"], j["s_lp"], jnp.zeros((m,)), chunk=min(CHUNK, m)))
    np.testing.assert_allclose(Mt, Mj, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(Mt, point["M"], rtol=0, atol=1e-9 * scale)


def test_chunk_starts():
    assert tcones.chunk_starts(10, 4) == [0, 4, 6]
    assert tcones.chunk_starts(8, 4) == [0, 4]
    assert tcones.chunk_starts(3, 3) == [0]
    assert tcones.chunk_starts(25001, 2048)[-2:] == [22528, 22953]


# ----------------------------------------------------------------------
# the PCG pair
# ----------------------------------------------------------------------


def _precond(M, extra):
    """The JAX package's inverted f32 factor of the equilibrated M + extra
    (both packages then apply the same Linv)."""
    A = M + np.diag(extra)
    s = 1.0 / np.sqrt(np.diag(A))
    Linv, ok = jcg.factor_scaled_f32(jnp.asarray((s[:, None] * A * s[None, :]).astype(np.float32)))
    assert bool(ok)
    return np.asarray(Linv), s


def test_kkt_pcg_matches_jax(point):
    t, j, m = point["t"], point["j"], point["m"]
    rng = np.random.default_rng(5)
    B = rng.normal(size=(m, 2))
    reg = np.full(m, 1e-08 * point["scale"])
    d = _np(t["cs"].kkt_diag(t["Us"], t["s_lp"])) + reg
    Xt, rest, nt = t["cs"].kkt_pcg(t["Us"], t["s_lp"], torch.as_tensor(reg),
                                   torch.as_tensor(1.0 / d), torch.as_tensor(B),
                                   abs_tol=1e-12, rel_tol=1e-12, max_iter=4 * m)
    Xj, resj, nj = j["cs"].kkt_pcg(j["Us"], j["s_lp"], jnp.asarray(reg), jnp.asarray(1.0 / d),
                                   jnp.asarray(B), abs_tol=1e-12, rel_tol=1e-12, max_iter=4 * m)
    assert int(nt) == int(nj), (int(nt), int(nj))
    np.testing.assert_allclose(_np(Xt), _np(Xj), rtol=0, atol=1e-9 * np.abs(_np(Xj)).max())
    Xd = np.linalg.solve(point["M"] + np.diag(reg), B)
    np.testing.assert_allclose(_np(Xt), Xd, rtol=1e-6, atol=1e-6)
    assert _np(rest).shape == (2,)


def test_kkt_pcg_chol_matches_jax(point):
    t, j, m = point["t"], point["j"], point["m"]
    rng = np.random.default_rng(6)
    B = rng.normal(size=(m, 3))
    Linv, s = _precond(point["M"], point["extra"])
    Xt, rest, nt = t["cs"].kkt_pcg_chol(
        t["Us"], t["s_lp"], torch.as_tensor(point["extra"]), torch.as_tensor(Linv),
        torch.as_tensor(s), torch.as_tensor(B), abs_tol=1e-10, rel_tol=1e-10, max_iter=50)
    Xj, resj, nj = j["cs"].kkt_pcg_chol(
        j["Us"], j["s_lp"], jnp.asarray(point["extra"]), jnp.asarray(Linv), jnp.asarray(s),
        jnp.asarray(B), abs_tol=1e-10, rel_tol=1e-10, max_iter=50)
    assert int(nt) == int(nj), (int(nt), int(nj))
    assert 0 < int(nt) <= 6  # an f32 factor of M itself: a few polishing steps
    np.testing.assert_allclose(_np(Xt), _np(Xj), rtol=0, atol=1e-9 * np.abs(_np(Xj)).max())
    Xd = np.linalg.solve(point["M"] + np.diag(point["extra"]), B)
    np.testing.assert_allclose(_np(Xt), Xd, rtol=0, atol=1e-8 * np.abs(Xd).max())


@pytest.mark.parametrize("max_iter", [600, 7])
def test_pcg_exit_check_every_few_steps_equals_step_by_step(point, max_iter):
    """The loop may read its exit flag once every few steps: X, the
    residual norms and the step count are those of the step-by-step form,
    bit for bit, also when the budget ends the loop (max_iter 7 is no
    multiple of 4 or 5)."""
    t, m = point["t"], point["m"]
    rng = np.random.default_rng(8)
    B = torch.as_tensor(rng.normal(size=(m, 3)) * np.array([1.0, 1e-3, 1e3]))
    extra = torch.as_tensor(point["extra"])
    pinv = 1.0 / (t["cs"].kkt_diag(t["Us"], t["s_lp"]) + extra)
    runs = [
        tcones.kkt_pcg(t["cs"].groups, t["cs"].lp, t["Us"], t["s_lp"], extra, pinv, B, m,
                       1e-10, 1e-10, max_iter, check_every=k)
        for k in (1, 4, 5)
    ]
    X1, r1, n1 = runs[0]
    assert 0 < int(n1) <= max_iter
    for X, r, n in runs[1:]:
        assert torch.equal(X, X1) and torch.equal(r, r1) and int(n) == int(n1)


def test_pcg_column_does_not_depend_on_its_neighbours(point):
    """Each column runs its own recurrence and freezes when it converges:
    solved alone or beside two others it comes out the same to rounding,
    and the loop runs as long as its slowest column."""
    t, m = point["t"], point["m"]
    rng = np.random.default_rng(9)
    B = torch.as_tensor(rng.normal(size=(m, 3)) * np.array([1.0, 1e-4, 1e2]))
    extra = torch.as_tensor(point["extra"])
    pinv = 1.0 / (t["cs"].kkt_diag(t["Us"], t["s_lp"]) + extra)
    X, res, n = t["cs"].kkt_pcg(t["Us"], t["s_lp"], extra, pinv, B)
    steps = []
    for i in range(3):
        Xi, ri, ni = t["cs"].kkt_pcg(t["Us"], t["s_lp"], extra, pinv, B[:, i:i + 1])
        # not bit for bit: the dot products of a column of [m, 3] are
        # reduced over another stride than those of [m, 1]
        np.testing.assert_allclose(_np(Xi[:, 0]), _np(X[:, i]), rtol=0,
                                   atol=1e-10 * float(X[:, i].abs().max()))
        assert float(ri[0]) == pytest.approx(float(res[i]), rel=1e-6)
        steps.append(int(ni))
    assert int(n) == max(steps)


# ----------------------------------------------------------------------
# factor_scaled_f32
# ----------------------------------------------------------------------


def test_factor_scaled_f32_matches_jax():
    rng = np.random.default_rng(11)
    n = 200
    Q = rng.normal(size=(n, n))
    A = Q @ Q.T / n + 0.05 * np.eye(n)
    s = 1.0 / np.sqrt(np.diag(A))
    Ms = (s[:, None] * A * s[None, :]).astype(np.float32)
    assert np.linalg.cond(Ms.astype(np.float64)) < 1e3
    Lt, okt = tcg.factor_scaled_f32(torch.as_tensor(Ms))
    Lj, okj = jcg.factor_scaled_f32(jnp.asarray(Ms))
    assert okt is True and bool(okj)
    assert Lt.dtype == torch.float32 and Lt.shape == (n, n)
    Lt, Lj = _np(Lt), np.asarray(Lj)
    assert np.abs(Lt - Lj).max() <= 1e-4 * np.abs(Lj).max()
    assert np.abs(np.triu(Lt, 1)).max() == 0.0
    # it is the inverse factor: Linv Ms Linv^T = I at f32 rounding
    R = Lt.astype(np.float64) @ Ms.astype(np.float64) @ Lt.astype(np.float64).T
    assert np.abs(R - np.eye(n)).max() < 1e-3


def test_factor_scaled_f32_reads_the_lower_triangle():
    rng = np.random.default_rng(12)
    n = 40
    Q = rng.normal(size=(n, n))
    Ms = (Q @ Q.T / n + np.eye(n)).astype(np.float32)
    noisy = Ms + np.triu(rng.normal(size=(n, n)).astype(np.float32), 1)
    a, _ = tcg.factor_scaled_f32(torch.as_tensor(Ms))
    b, ok = tcg.factor_scaled_f32(torch.as_tensor(noisy))
    assert ok and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["indefinite", "nan"])
def test_factor_scaled_f32_reports_failure(kind):
    Ms = np.eye(6, dtype=np.float32)
    if kind == "indefinite":
        Ms[2, 2] = -1.0
    else:
        Ms[3, 1] = Ms[1, 3] = np.nan
    Linv, ok = tcg.factor_scaled_f32(torch.as_tensor(Ms))
    assert ok is False and Linv is None
    assert not bool(jcg.factor_scaled_f32(jnp.asarray(Ms))[1])


# ----------------------------------------------------------------------
# the ladder, end to end
# ----------------------------------------------------------------------

LADDER = {
    # the four configurations of the JAX package's operator tests on theta60
    "free": dict(kkt_mode="free"),
    "starved_precond": dict(kkt_mode="free", kkt_free_maxiter=40, op_precond_chunk=64,
                            op_materialize_cap=0),
    "starved_escalates": dict(kkt_mode="free", kkt_free_maxiter=2),
    "starved_no_materialize": dict(kkt_mode="free", kkt_free_maxiter=60, op_materialize_cap=0),
}


@pytest.fixture(scope="module")
def theta60_dense():
    jp, tp = _problems("theta60")
    return (JSolver(jp, verbose=False, fused=False).optimize(),
            TSolver(tp, device="cpu", verbose=False, fused=False).optimize())


@pytest.fixture(scope="module", params=sorted(LADDER))
def ladder_runs(request):
    jp, tp = _problems("theta60")
    over = LADDER[request.param]
    ts = TSolver(tp, device="cpu", verbose=False, **over)
    return dict(name=request.param, ts=ts, rt=ts.optimize(),
                rj=JSolver(jp, verbose=False, fused=False, **over).optimize())


def test_ladder_reaches_the_optimum(ladder_runs, theta60_dense):
    rt, rj = ladder_runs["rt"], ladder_runs["rj"]
    dense_j, dense_t = theta60_dense
    told = f"iterations port {rt.n_iters} jax {rj.n_iters} dense {dense_t.n_iters}"
    assert rt.status == rj.status == dense_t.status == "PRIMAL_DUAL_OPTIMAL", told
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-6), told
    assert rt.d_obj == pytest.approx(dense_t.d_obj, rel=1e-6), told
    assert np.max(np.abs(rt.dimacs)) < 1e-6, told


def test_ladder_evidence(ladder_runs):
    """Which tiers ran, as the JAX package's operator tests hold them, and
    that no dense M existed where none may."""
    name, rt, rj, ts = (ladder_runs[k] for k in ("name", "rt", "rj", "ts"))
    assert ts.ipm.kkt_free and rt.stats["opcg_iters"] > 0 and rj.stats["opcg_iters"] > 0
    assert ts.ipm._op_Us is None and ts.ipm._op_pc is None  # released before the check
    if name == "starved_precond":
        assert rt.stats.get("op_pc_builds", 0) >= 1 and rj.stats.get("op_pc_builds", 0) >= 1
    if name == "starved_escalates":
        assert rt.stats.get("op_escalations", 0) > 0 and rj.stats.get("op_escalations", 0) > 0
    if name in ("starved_precond", "starved_no_materialize"):
        assert rt.stats.get("op_escalations", 0) == 0
        assert rt.stats["psdp_op_runs"] == rt.stats["psdp_runs"] >= 1  # no dense M for PSDP either
    else:
        # below the materialization cap the refiner of an operator-mode
        # solve builds its X-weighted M once and factors it directly (the
        # dual solve's ``kkt_free`` is put back afterwards)
        assert rt.stats["psdp_runs"] >= 1 and "psdp_op_runs" not in rt.stats


def test_ladder_iteration_counts(ladder_runs):
    """Held to +-2 of the JAX host loop where the solves are exact enough
    for both packages to walk one path: the full-budget run and the run
    that escalates every stalled system to a direct factor.  The two
    starved runs without a dense M accept CG iterates of relative residual
    up to 1e-6, which differ between the packages' BLAS at that level and
    move PSDP's hand-over by a few iterations; their counts are printed by
    the test above when it fails and are not held."""
    name, rt, rj = (ladder_runs[k] for k in ("name", "rt", "rj"))
    if name in ("free", "starved_escalates"):
        assert abs(rt.n_iters - rj.n_iters) <= 2, (rt.n_iters, rj.n_iters)
    else:
        assert rt.n_iters > 0 and rj.n_iters > 0


def test_operator_mode_lp_mix_end_to_end():
    jp, tp = _problems("qpg60")
    rj = JSolver(jp, verbose=False, fused=False, kkt_mode="free").optimize()
    dense = TSolver(tp, device="cpu", verbose=False, fused=False).optimize()
    rt = TSolver(tp, device="cpu", verbose=False, kkt_mode="free").optimize()
    assert rt.status == rj.status == dense.status == "PRIMAL_DUAL_OPTIMAL"
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-6)
    assert rt.d_obj == pytest.approx(dense.d_obj, rel=1e-6)
    assert abs(rt.n_iters - rj.n_iters) <= 2, (rt.n_iters, rj.n_iters)


def test_operator_mode_flat_layout_runs_on_jacobi():
    """A multi-block (flat) problem has no row-chunked build: operator mode
    never builds the f32 preconditioner and still reaches the optimum."""
    jp, tp = _problems("control6")
    dense = TSolver(tp, device="cpu", verbose=False, fused=False).optimize()
    rt = TSolver(tp, device="cpu", verbose=False, kkt_mode="free").optimize()
    assert rt.status == dense.status == "PRIMAL_DUAL_OPTIMAL"
    assert rt.d_obj == pytest.approx(dense.d_obj, rel=1e-6)
    assert rt.stats.get("op_pc_builds", 0) == 0 and rt.stats["opcg_iters"] > 0


def test_auto_mode_engages_at_the_threshold():
    _, tp = _problems("gpp30")
    mk = lambda **kw: talgo.DualIPM(tp, Params(verbose=False, **kw), device="cpu")
    assert not mk().kkt_free and not mk(kkt_mode="dense").kkt_free
    assert mk(kkt_mode="free").kkt_free
    assert mk(kkt_free_threshold=31).kkt_free and not mk(kkt_free_threshold=32).kkt_free
    assert not mk(kkt_mode="dense", kkt_free_threshold=1).kkt_free
    p = Params()
    assert (p.kkt_free_threshold, p.kkt_free_maxiter, p.op_materialize_cap, p.op_precond_cap,
            p.op_precond_chunk, p.op_precond_refresh_iters) == (20000, 600, 32768, 32768, 2048, 80)


def test_operator_solves_repeat_bit_for_bit():
    _, tp = _problems("theta60")
    over = dict(LADDER["starved_precond"], max_iter=25)
    a = TSolver(tp, device="cpu", verbose=False, **over).optimize()
    b = TSolver(tp, device="cpu", verbose=False, **over).optimize()
    assert a.stats["op_pc_builds"] >= 1
    assert a.d_obj == b.d_obj and a.n_iters == b.n_iters
    assert a.stats["opcg_iters"] == b.stats["opcg_iters"]
    np.testing.assert_array_equal(a.y, b.y)


def test_only_out_of_memory_is_caught_on_the_materialize_tier(monkeypatch):
    """Tier 3 remembers an out-of-memory build and returns the CG iterate;
    any other error of the dense build propagates."""
    _, tp = _problems("theta60")

    def run(exc):
        def failing_build(self, *args, **kwargs):
            raise exc

        ts = TSolver(tp, device="cpu", verbose=False, max_iter=16, **LADDER["starved_escalates"])
        monkeypatch.setattr(tcones.ConeSystem, "build_kkt", failing_build)
        try:
            return ts, ts.optimize()
        finally:
            monkeypatch.undo()

    ts, r = run(torch.cuda.OutOfMemoryError("no room for M"))
    assert ts.ipm._op_mat_unavailable and r.stats["op_escalations"] == 1
    with pytest.raises(RuntimeError, match="some other fault"):
        run(RuntimeError("some other fault"))


# ----------------------------------------------------------------------
# PSDP's operator branch
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def refined_operator(tmp_path_factory):
    """Both refiners from the JAX iterate at the phase-B hook, theta60 with
    ``kkt_mode="free", op_materialize_cap=0``, which makes ``use_operator``
    true at a small size."""
    over = dict(kkt_mode="free", op_materialize_cap=0)
    jp, tp = _problems("theta60")
    path = str(tmp_path_factory.mktemp("psdp_op") / "state.npz")
    snap = {}
    orig = jpsdp.PSDPRefiner.optimize

    def spy(self):
        ipm = self.ipm
        if "ret" in snap:
            return orig(self)
        save_checkpoint(path, ipm)
        before = dict(comp=ipm.comp, p_obj_val=ipm.p_obj_val, d_obj_val=ipm.d_obj_val,
                      p_obj_internal=ipm.p_obj_internal, d_obj_internal=ipm.d_obj_internal)
        n0, b0 = ipm.n_iter, ipm._factor_stats.get("op_pc_builds", 0)
        ret = orig(self)
        snap.update(before=before, ret=ret, iters=ipm.n_iter - n0, p_obj=ipm.p_obj_val,
                    d_obj=ipm.d_obj_val, builds=ipm._factor_stats.get("op_pc_builds", 0) - b0)
        return ret

    jpsdp.PSDPRefiner.optimize = spy
    try:
        JSolver(jp, verbose=False, fused=False, **over).optimize()
    finally:
        jpsdp.PSDPRefiner.optimize = orig
    assert "ret" in snap, "the JAX solve never reached its refiner"

    ipm = talgo.DualIPM(tp, Params(verbose=False, **over), device="cpu")
    talgo.load_state(ipm, load_checkpoint(path))
    ipm.which_method = "potential"
    for k, v in snap["before"].items():
        setattr(ipm, k, float(v))
    assert ipm.check_is_interior(1.0, ipm.y)
    ref = tpsdp.PSDPRefiner(ipm)
    return dict(snap=snap, ipm=ipm, ref=ref, ret=ref.optimize())


def test_psdp_operator_branch_runs_matrix_free(refined_operator):
    ipm, ref, snap = (refined_operator[k] for k in ("ipm", "ref", "snap"))
    assert ref.used_operator and ipm.kkt_free
    assert ipm.kkt is None or ipm.kkt.M is None  # no X-weighted dense M was built
    # the recovery's and the refiner's preconditioners, as in the JAX run
    assert ipm._factor_stats["op_pc_builds"] >= 2 and snap["builds"] >= 2


def test_psdp_operator_branch_flag_and_objectives(refined_operator):
    snap, ipm, ref = (refined_operator[k] for k in ("snap", "ipm", "ref"))
    assert refined_operator["ret"] == snap["ret"]
    # the count of either package moves by one or two with the number of
    # BLAS threads (34-36 here): PSDP's late iterates walk into a nearly
    # singular X, and here every step comes from CG, not a direct factor
    assert abs(ref.n_iter - snap["iters"]) <= 3, (ref.n_iter, snap["iters"])
    assert ref.n_iter >= 10
    assert ipm.d_obj_val == pytest.approx(snap["d_obj"], rel=1e-7)
    assert ipm.p_obj_val == pytest.approx(snap["p_obj"], rel=1e-7)


# ----------------------------------------------------------------------
# the DIMACS check, matrix-free
# ----------------------------------------------------------------------

CHECKS = {
    # name: (case, overrides, preconditioner builds of the check)
    "chol_pcg": ("gpp30", dict(kkt_mode="free"), 1),
    "support": ("theta60", dict(kkt_mode="free"), 1),
    "jacobi_runs": ("gpp30", dict(kkt_mode="free", op_precond_cap=0), 0),
    "flat_jacobi": ("control6", dict(kkt_mode="free"), 0),
    # the fault of the earlier slices: a dense-mode solve above the
    # materialization cap must check matrix-free, not raise
    "dense_above_cap": ("gpp30", dict(op_materialize_cap=10), 1),
}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_dimacs_check_matrix_free_from_jax_iterate(name, tmp_path):
    """The six errors of the port's check on a JAX run's state, at the
    maker of iteration 11 (well conditioned; at the final maker both checks
    are rounding noise).  Both re-solve dy by CG to a residual of 1e-10 of
    the right-hand side, so the errors agree to 1e-6 relative plus 1e-9:
    err1 IS that residual, small and different in each package."""
    case, over, builds = CHECKS[name]
    jp, tp = _problems(case)
    js = JSolver(jp, verbose=False, fused=False, max_iter=11, **over)
    rj = js.optimize()
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, js.ipm)
    ipm = talgo.DualIPM(tp, Params(verbose=False, max_iter=11, **over), device="cpu")
    talgo.load_state(ipm, load_checkpoint(path))
    assert ipm.kkt_free == ("kkt_mode" in over)
    errs = tdimacs.check_solution(ipm)
    assert ipm.status == js.ipm.status
    np.testing.assert_allclose(errs, rj.dimacs, rtol=1e-6, atol=1e-9)
    assert ipm.d_obj_val == pytest.approx(rj.d_obj, rel=1e-12)
    assert ipm.p_obj_val == pytest.approx(rj.p_obj, rel=1e-8)
    assert ipm._factor_stats.get("op_pc_builds", 0) == builds


def test_dense_solve_above_the_cap_checks_and_matches_jax():
    """End to end: dense mode with ``op_materialize_cap`` below m solves
    with its dense M and checks matrix-free, in both packages."""
    jp, tp = _problems("gpp30")
    rj = JSolver(jp, verbose=False, fused=False, op_materialize_cap=10).optimize()
    ts = TSolver(tp, device="cpu", verbose=False, fused=False, op_materialize_cap=10)
    rt = ts.optimize()
    assert not ts.ipm.kkt_free and "opcg_iters" not in rt.stats
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-7)
    assert abs(rt.n_iters - rj.n_iters) <= 1
    assert np.max(np.abs(rt.dimacs)) < 1e-6


def test_operator_mode_on_gpp_walks_the_whole_ladder_as_jax_does():
    """CG cannot carry the gpp family: its Schur system (the all-ones
    constraint leaves the primal without an interior) defeats Jacobi and
    the f32 factor alike, so system after system goes down the whole
    ladder to the materialized direct factor (generic slot-major rows,
    tier 3), tens of thousands of CG steps for a problem of 31 rows.  Both
    packages do, and still end at the dense optimum."""
    jp, tp = _problems("gpp30")
    rj = JSolver(jp, verbose=False, fused=False, kkt_mode="free").optimize()
    dense = TSolver(tp, device="cpu", verbose=False, fused=False).optimize()
    rt = TSolver(tp, device="cpu", verbose=False, kkt_mode="free").optimize()
    assert rt.status == rj.status == dense.status == "PRIMAL_DUAL_OPTIMAL"
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-6)
    assert rt.d_obj == pytest.approx(dense.d_obj, rel=1e-6)
    assert abs(rt.n_iters - rj.n_iters) <= 2, (rt.n_iters, rj.n_iters)
    assert rt.stats["op_escalations"] >= 3
    assert abs(rt.stats["op_escalations"] - rj.stats["op_escalations"]) <= 1
    assert rt.stats["opcg_iters"] > 10000
    # whether a stalled run slips under its 1e-6 acceptance is rounding
    # noise, and each miss costs up to 9 more runs of 600 steps
    assert rt.stats["opcg_iters"] == pytest.approx(rj.stats["opcg_iters"], rel=0.25)
