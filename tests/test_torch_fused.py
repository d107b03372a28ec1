"""The port's fused IPM bodies (hdsdp_tpu_torch.solver.fused) against the
JAX package's fused programs (hdsdp_tpu.solver.fused) on the CPU.

Per function, both packages start from one iterate: a state that the JAX
package's own "iter" solve handed to its iteration body, carried across
by ``state_from_numpy``.  Tolerances: f64 fields 1e-10 of the field's
largest entry, the f32 Lanczos warm vectors 1e-5, integer counters and
status codes exactly.  End to end, against ``fused=True`` of the JAX
package: status equal, iterations +-1 and d_obj to 1e-7 (the JAX fused
tests' instances), and the port's own "phase" against "iter" bit for bit.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdsdp_tpu.io.sdpa import BlockEntries as JBlock, SDPAData as JData
from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.solver import algo as jalgo
from hdsdp_tpu.solver import fused as jfused
from hdsdp_tpu.solver.params import Params as JParams
from hdsdp_tpu.solver.solver import HDSDPSolver as JSolver
from hdsdp_tpu_torch.io.sdpa import BlockEntries as TBlock, SDPAData as TData
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
from hdsdp_tpu_torch.solver import algo as talgo
from hdsdp_tpu_torch.solver import fused as tfused
from hdsdp_tpu_torch.solver.params import Params
from hdsdp_tpu_torch.solver.solver import HDSDPSolver as TSolver

MIXED = dict(m=24, block_dims=[10, 6], n_lp=5)  # two groups + an LP cone


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny torch calls: one thread is as fast and does not
    stall beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_default_config():
    """The JAX module's trace-time dicts at their defaults around each test
    (solve_fused leaves them as its last solve set them)."""
    saved = (dict(jfused._RATIO_CFG), dict(jfused._KKT_CFG), dict(jfused._CONE_CFG))
    jfused._RATIO_CFG.update(mode="auto", krylov=30, kwarm=16)
    jfused._KKT_CFG.update(mp=False, hp=False, dhp=False)
    jfused._CONE_CFG.update(dd=False)
    yield
    for d, v in zip((jfused._RATIO_CFG, jfused._KKT_CFG, jfused._CONE_CFG), saved):
        d.clear()
        d.update(v)


def _infeasible(kind: str, pkg: str):
    """test_infeas.py's two problems.  "primal": tr(X) = -1 with X >= 0,
    the dual is unbounded; "dual": C = [[0,1],[1,0]], A1 = diag(1, 0), the
    dual has no interior point."""
    Block, Data, Problem = (JBlock, JData, JProblem) if pkg == "jax" else (
        TBlock, TData, TProblem)
    if kind == "primal":
        n = 4
        rows = np.arange(n, dtype=np.int32)
        r = np.concatenate([rows, rows])
        blk = Block(dim=n, con=np.concatenate([np.zeros(n, np.int32), np.ones(n, np.int32)]),
                    row=r, col=r.copy(), val=np.ones(2 * n))
        return Problem.from_sdpa(Data(m=1, block_dims=[n], b=np.array([-1.0]), blocks=[blk],
                                      nnz=2 * n))
    blk = Block(dim=2, con=np.array([0, 1], np.int32), row=np.array([1, 0], np.int32),
                col=np.array([0, 0], np.int32), val=np.array([1.0, 1.0]))
    return Problem.from_sdpa(Data(m=1, block_dims=[2], b=np.array([1.0]), blocks=[blk], nnz=2))


def _problems(name):
    if name in ("primal", "dual"):
        return _infeasible(name, "jax"), _infeasible(name, "torch")
    kw = dict(MIXED, seed=0) if name == "mixed" else dict(m=30, block_dims=[8], seed=4)
    return (JProblem.from_sdpa(jsyn.random_sdpa(**kw)),
            TProblem.from_sdpa(tsyn.random_sdpa(**kw)))


def _np_tree(x):
    return jax.tree.map(lambda a: np.array(a), x)


@pytest.fixture(scope="module")
def recorded():
    """Every state the JAX package's "iter" solves handed to an iteration
    body (as numpy), by phase, with the cones and parameters of both
    packages: the mixed instance (phases A and B) and the dual-infeasible
    one (phase A')."""
    out = {}
    orig = jfused._drive_iterated

    for name in ("mixed", "dual"):
        states = {"infeas": [], "potential": [], "hsd": []}

        def recording(ipm, body_fn, st, max_iter, is_phase_b):
            tag = ipm.which_method

            def body(x):
                states[tag].append(_np_tree(x))
                return body_fn(x)

            return orig(ipm, body, st, max_iter, is_phase_b)

        jp, tp = _problems(name)
        jfused._drive_iterated = recording
        try:
            js = JSolver(jp, verbose=False, fused="iter")
            js.optimize()
        finally:
            jfused._drive_iterated = orig
        jipm = js.ipm
        tipm = talgo.DualIPM(tp, Params(verbose=False), device="cpu")
        out[name] = dict(states=states, jipm=jipm, tipm=tipm,
                         jc=jfused._cones_from_ipm(jipm), tc=tfused._cones_from_ipm(tipm))
    return out


def _close(t, j, what, rtol=1e-10):
    j = np.asarray(j)
    t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert t.shape == j.shape, what
    if not np.issubdtype(j.dtype, np.floating):
        np.testing.assert_array_equal(t, j, err_msg=what)
        return
    if j.dtype == np.float32:
        rtol = max(rtol, 1e-5)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j), err_msg=what)
    fin = np.isfinite(j)
    scale = max(float(np.max(np.abs(j[fin]), initial=0.0)), 1e-300)
    err = float(np.max(np.abs(t[fin] - j[fin]), initial=0.0))
    assert err <= rtol * scale, f"{what}: max |diff| {err:.3e}, scale {scale:.3e}"


def _tril(L):
    """A Cholesky factor's value: its lower triangle.  Above the diagonal
    a failed factor is NaN in the port and 0 in the JAX package."""
    return np.tril(L.numpy() if isinstance(L, torch.Tensor) else np.asarray(L))


def _assert_state(t, j):
    for f in dataclasses.fields(tfused.State):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if jv is None:
            assert tv is None, f.name
        elif f.name.startswith("maker"):
            for k in ("mu", "y", "dy"):
                _close(getattr(tv, k), getattr(jv, k), f"{f.name}.{k}")
        elif isinstance(jv, tuple):
            assert len(tv) == len(jv), f.name
            for i, (a, b) in enumerate(zip(tv, jv)):
                if f.name in ("L", "Lchk"):
                    a, b = _tril(a), _tril(b)
                _close(a, b, f"{f.name}[{i}]")
        else:
            _close(tv, jv, f.name)


def _jstate(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tstate(tree):
    return tfused.state_from_numpy(tree, "cpu")


def test_state_from_numpy_keeps_every_field(recorded):
    tree = recorded["mixed"]["states"]["infeas"][0]
    st = _tstate(tree)
    _assert_state(st, tree)
    assert st.n_iter.dtype == torch.int32 and st.lz[0].dtype == torch.float32
    assert st.y.dtype == torch.float64 and st.s_lp is not None


@pytest.mark.parametrize("k", [0, -1])
def test_phase_a_iteration(recorded, k):
    r = recorded["mixed"]
    tree = r["states"]["infeas"][k]
    jp = jfused._pars_from_ipm(r["jipm"], "a")
    tp = tfused._pars_from_ipm(r["tipm"], "a")
    corr = r["jipm"].params.corrector_a
    assert corr == r["tipm"].params.corrector_a
    jout = _np_tree(jfused._phase_a_iteration(r["jc"], jp, _jstate(tree), corr))
    tout = tfused._phase_a_iteration(r["tc"], tp, _tstate(tree), corr)
    _assert_state(tout, jout)


def test_phase_a_body_takes_the_reset(recorded):
    """The n_iter == 3 reset (no primal objective found yet) of
    _phase_a_body, on a recorded state set to n_iter 3."""
    r = recorded["mixed"]
    tree = r["states"]["infeas"][-1]
    tree = tree._replace(n_iter=np.asarray(3, np.int32), p_obj_found=np.asarray(0, np.int32))
    rrd = -1e8
    jp = jfused._pars_from_ipm(r["jipm"], "a")
    tp = tfused._pars_from_ipm(r["tipm"], "a")
    corr = r["jipm"].params.corrector_a
    jout = _np_tree(jfused._phase_a_body(r["jc"], jp, jnp.asarray(rrd), _jstate(tree), corr,
                                         True))
    tout = tfused._phase_a_body(r["tc"], tp, torch.tensor(rrd, dtype=torch.float64),
                                _tstate(tree), corr, True)
    _assert_state(tout, jout)
    assert int(tout.n_iter) == 4


@pytest.mark.parametrize("k", [0, 6, -2])
def test_phase_b_iteration_with_extras(recorded, k):
    r = recorded["mixed"]
    st_ex = r["states"]["potential"][k]
    jp = jfused._pars_from_ipm(r["jipm"], "b")
    tp = tfused._pars_from_ipm(r["tipm"], "b")
    corr = r["jipm"].params.corrector_b
    assert corr == r["tipm"].params.corrector_b
    psdp = bool(r["jipm"].params.psdp)
    jst = (_jstate(st_ex[0]),) + tuple(jnp.asarray(x) for x in st_ex[1:])
    tst = (_tstate(st_ex[0]),) + tuple(torch.as_tensor(np.array(x)) for x in st_ex[1:])
    jout = _np_tree(jfused._phase_b_iteration(r["jc"], jp, jst, corr, psdp))
    tout = tfused._phase_b_iteration(r["tc"], tp, tst, corr, psdp)
    _assert_state(tout[0], jout[0])
    for i, (a, b) in enumerate(zip(tout[1:], jout[1:])):
        _close(a, b, f"extra {i}")


def test_hsd_iteration(recorded):
    r = recorded["dual"]
    states = r["states"]["hsd"]
    assert len(states) >= 2 and not r["states"]["potential"]
    jipm, tipm = r["jipm"], r["tipm"]
    hp_args = dict(
        feas_tol=1e-8, abs_opt=1e+16, rel_opt=1e+12, hsd_gamma=jipm.params.hsd_gamma,
        reset_rd=-1e+8, pd_base=1.0 / (jipm.rhs_scal * jipm.obj_scal))
    jhp = jfused.HsdPars(**{k: jnp.asarray(v) for k, v in hp_args.items()})
    thp = tfused.HsdPars(**{k: torch.tensor(v, dtype=torch.float64)
                            for k, v in hp_args.items()})
    for tree in states[:3]:
        jout = _np_tree(jfused._hsd_iteration(r["jc"], jhp, _jstate(tree)))
        tout = tfused._hsd_iteration(r["tc"], thp, _tstate(tree))
        _assert_state(tout, jout)
        # and the body, with its interior check and reset branch
        jout = _np_tree(jfused._hsd_body(r["jc"], jhp, _jstate(tree)))
        tout = tfused._hsd_body(r["tc"], thp, _tstate(tree))
        _assert_state(tout, jout)


def _kkt_inputs(r, tree):
    """One KKT build and solve of the JAX package at a recorded state, as
    (JAX kkt, port kkt, d1, d2) on identical numbers."""
    st = _jstate(tree)
    kkt = jfused.build_kkt(r["jc"], st.L, st.s_lp, st.Rd, "inf")
    M = kkt[0] + jnp.diag(1.0 / st.sl ** 2 + 1.0 / st.su ** 2)
    asinv = kkt[1] + 1.0 / st.su - 1.0 / st.sl
    kkt = (M, asinv) + kkt[2:]
    L, _ = jfused._factor_m_f64(M)
    sols = jfused.solve_m(L, jnp.stack([r["jc"].b, asinv], axis=1))
    tk = tfused.cone_ops.KKTOut(*(None if x is None else torch.as_tensor(np.array(x))
                                  for x in kkt))
    return kkt, tk, sols[:, 0], sols[:, 1]


@pytest.mark.parametrize("phase,k", [("infeas", -1), ("potential", 3), ("potential", 9)])
def test_prox_measure(recorded, phase, k):
    r = recorded["mixed"]
    tree = r["states"][phase][k]
    tree = tree if phase == "infeas" else tree[0]
    kkt, tk, d1, d2 = _kkt_inputs(r, tree)
    which = phase == "infeas"
    pj = jfused._pars_from_ipm(r["jipm"], "a" if which else "b")
    pt = tfused._pars_from_ipm(r["tipm"], "a" if which else "b")
    jtype, jout = jfused.prox_measure(r["jc"], pj, _jstate(tree), kkt, d1, d2, which)
    ttype, tout = tfused.prox_measure(r["tc"], pt, _tstate(tree), tk,
                                      torch.as_tensor(np.array(d1)),
                                      torch.as_tensor(np.array(d2)), which)
    assert int(ttype) == int(jtype)
    _assert_state(tout, _np_tree(jout))


def test_cone_ratio_with_warm_vectors(recorded):
    """The warm-started fixed-depth Lanczos (mode "lanczos" at these small
    blocks) threading State.lz over three calls.  The warm vectors agree up
    to the sign of the top Ritz vector, which each eigensolver picks its
    own way; the next call's anti-stagnation perturbation does not flip
    with it, so the later steps agree to f32 rounding, not bit for bit."""
    r = recorded["mixed"]
    tree = r["states"]["potential"][4][0]
    jfused._RATIO_CFG["mode"] = "lanczos"
    tc = r["tc"]._replace(cfg=dataclasses.replace(r["tc"].cfg, ratio_mode="lanczos"))
    jst, tst = _jstate(tree), _tstate(tree)
    rng = np.random.default_rng(0)
    jlz, tlz = jst.lz, tst.lz
    for _ in range(3):
        dy = rng.standard_normal(tree.y.shape) * 1e-2
        jdS, jds, _, _ = jfused.set_step(r["jc"], jst, 0.0, jnp.asarray(dy), 0.0)
        tdS, tds, _, _ = tfused.set_step(tc, tst, 0.0, torch.as_tensor(dy), 0.0)
        jstep, jlz = jfused.cone_ratio(r["jc"], jst.L, jst.s_lp, jdS, jds, jlz)
        tstep, tlz = tfused.cone_ratio(tc, tst.L, tst.s_lp, tdS, tds, tlz)
        _close(tstep, jstep, "step", rtol=1e-5)
        for i, (a, b) in enumerate(zip(tlz, jlz)):
            # a Ritz vector's sign is the eigensolver's choice
            a = a.numpy()
            b = np.asarray(b)
            _close(a * np.sign(np.sum(a * b, axis=-1, keepdims=True)), b, f"lz[{i}]")
    assert all(not np.array_equal(np.array(a), np.array(b)) for a, b in zip(jlz, jst.lz))


def test_factor_m_f64_ladder_on_an_indefinite_matrix():
    """An indefinite M that the third rung (base * 1e4) factors: the same
    rung in both packages, found from M + reg I = L L^T."""
    rng = np.random.default_rng(3)
    m = 12
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    lam = np.linspace(1.0, 2.0, m)
    M = (Q * lam) @ Q.T
    base = np.max(np.diag(M)) * 1e-14 + 1e-300
    lam[0] = -0.5e4 * base
    M = (Q * lam) @ Q.T
    M = 0.5 * (M + M.T)
    c = tfused._cones_from_ipm(talgo.DualIPM(
        TProblem.from_sdpa(tsyn.random_sdpa(m=m, block_dims=[4], seed=0)),
        Params(verbose=False), device="cpu"))
    Lj, okj = jfused._factor_m_f64(jnp.asarray(M))
    Lt, okt = tfused._factor_m_f64(c, torch.as_tensor(M))
    assert bool(okj) and bool(okt)
    _close(Lt, np.asarray(Lj), "L")
    Lt = Lt.numpy()
    reg = np.mean(np.diag(Lt @ Lt.T - M))
    assert reg == pytest.approx(base * 1e4, rel=1e-3)
    # a matrix no rung can factor: both report failure with a NaN factor
    Mbad = M - 10.0 * np.eye(m)
    Lj, okj = jfused._factor_m_f64(jnp.asarray(Mbad))
    Lt, okt = tfused._factor_m_f64(c, torch.as_tensor(Mbad))
    assert not bool(okj) and not bool(okt)
    _close(_tril(Lt), _tril(Lj), "failed L")
    assert np.isnan(np.asarray(Lj)[np.tril_indices(m)]).all()


# ----------------------------------------------------------------------
# end to end against the JAX package's fused=True
# ----------------------------------------------------------------------


E2E = {
    # name: (problems, overrides, the JAX fused tests' status set)
    "mixed_seed0": (lambda: _problems_seed(0), {}, ("PRIMAL_DUAL_OPTIMAL",)),
    "mixed_seed1": (lambda: _problems_seed(1), {}, ("PRIMAL_DUAL_OPTIMAL",)),
    "kkt_mp_on": (lambda: _problems_seed(0), dict(kkt_mp="on"), ("PRIMAL_DUAL_OPTIMAL",)),
    "primal_infeasible": (lambda: _problems("primal"), {}, ("INFEAS_OR_UNBOUNDED",)),
    "dual_infeasible": (lambda: _problems("dual"), {},
                        ("INFEAS_OR_UNBOUNDED", "SUSPECT_INFEAS_OR_UNBOUNDED")),
}


def _problems_seed(seed):
    return (JProblem.from_sdpa(jsyn.random_sdpa(**MIXED, seed=seed)),
            TProblem.from_sdpa(tsyn.random_sdpa(**MIXED, seed=seed)))


@pytest.mark.parametrize("name", sorted(E2E))
def test_fused_matches_jax_fused(name, monkeypatch):
    make, over, statuses = E2E[name]
    jp, tp = make()
    rj = JSolver(jp, verbose=False, fused=True, **over).optimize()
    mp_factors = []
    plain_mp = tfused._factor_m_mp
    monkeypatch.setattr(tfused, "_factor_m_mp",
                        lambda c, M: mp_factors.append(1) or plain_mp(c, M))
    ts = TSolver(tp, device="cpu", verbose=False, fused=True, **over)
    rt = ts.optimize()
    assert bool(mp_factors) == (name == "kkt_mp_on")
    assert rt.stats["fused"] == "phase"
    assert rt.status == rj.status and rt.status in statuses
    assert abs(rt.n_iters - rj.n_iters) <= 1
    if rt.status == "PRIMAL_DUAL_OPTIMAL":
        assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-7)
        assert np.max(np.abs(rt.dimacs)) < 1e-6
    if name == "dual_infeasible":  # Phase A' ran: the HSD header method
        assert ts.ipm.which_method == "hsd"


def test_fused_psdp_handoff_matches_jax():
    """random_sdpa(m=30, [8], seed=4): both fused phase B runs hand off to
    PSDP at the same iteration; the refiner fails in both packages (at its
    iteration 41 in the JAX run, 39 in the port's: its late iterates near a
    singular X differ between LAPACK builds, see test_torch_psdp) and the
    dual method finishes, optimal in both."""
    from hdsdp_tpu.solver import psdp as jpsdp
    from hdsdp_tpu_torch.solver import psdp as tpsdp

    at = {}

    def spy(mod, key):
        orig = mod.PSDPRefiner.optimize

        def optimize(self):
            at[key] = self.ipm.n_iter
            return orig(self)

        return orig, optimize

    jp, tp = _problems("psdp")
    oj, mod_j = spy(jpsdp, "jax")
    ot, mod_t = spy(tpsdp, "torch")
    jpsdp.PSDPRefiner.optimize, tpsdp.PSDPRefiner.optimize = mod_j, mod_t
    try:
        rj = JSolver(jp, verbose=False, fused=True).optimize()
        ts = TSolver(tp, device="cpu", verbose=False, fused=True)
        rt = ts.optimize()
    finally:
        jpsdp.PSDPRefiner.optimize, tpsdp.PSDPRefiner.optimize = oj, ot
    assert at["jax"] == at["torch"] and rt.stats["psdp_runs"] == 1
    assert ts.ipm.psdp is None
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-7)
    assert np.max(np.abs(rt.dimacs)) < 1e-6


def test_phase_and_iter_are_bit_equal():
    prob = TProblem.from_sdpa(tsyn.random_sdpa(**MIXED, seed=3))
    rp = TSolver(prob, device="cpu", verbose=False, fused="phase").optimize()
    ri = TSolver(prob, device="cpu", verbose=False, fused="iter").optimize()
    assert rp.status == ri.status == "PRIMAL_DUAL_OPTIMAL"
    assert (rp.stats["fused"], ri.stats["fused"]) == ("phase", "iter")
    assert rp.n_iters == ri.n_iters and rp.d_obj == ri.d_obj and rp.p_obj == ri.p_obj
    np.testing.assert_array_equal(rp.y, ri.y)


def test_two_same_shape_problems_in_one_process():
    """Same shapes, different data: each fused solve uses its own data."""
    kws = [dict(m=16, block_dims=[8], seed=s) for s in (21, 22)]
    rt = [TSolver(TProblem.from_sdpa(tsyn.random_sdpa(**kw)), device="cpu", verbose=False,
                  fused=True).optimize() for kw in kws]
    rj = [JSolver(JProblem.from_sdpa(jsyn.random_sdpa(**kw)), verbose=False,
                  fused=True).optimize() for kw in kws]
    for a, b in zip(rt, rj):
        assert a.status == b.status == "PRIMAL_DUAL_OPTIMAL"
        assert a.d_obj == pytest.approx(b.d_obj, rel=1e-7)
    assert abs(rt[0].d_obj - rt[1].d_obj) > 1e-6


def test_time_limit_in_iter_mode():
    """"iter" checks the wall clock after every iteration, "phase" cannot:
    with no time at all "iter" stops after one iteration (and the DIMACS
    check then finds no primal: NUMERICAL), as the JAX package's does."""
    jp, tp = _problems_seed(0)
    rj = JSolver(jp, verbose=False, fused="iter", time_limit=0.0).optimize()
    ts = TSolver(tp, device="cpu", verbose=False, fused="iter", time_limit=0.0)
    rt = ts.optimize()
    assert rt.n_iters == rj.n_iters == 1 and rt.status == rj.status
    rp = TSolver(tp, device="cpu", verbose=False, fused="phase", time_limit=0.0).optimize()
    assert rp.status == "PRIMAL_DUAL_OPTIMAL" and rp.n_iters > 1


# ----------------------------------------------------------------------
# the IPM mode choice
# ----------------------------------------------------------------------


# (m, n_max, n_sum, kkt_free, fused) -> the mode, per
# hdsdp_tpu/solver/algo.py:1779-1812 with the default sizes (fused_max_m
# 512, fused_max_n 256, fused_hbm_budget 12e9)
CHOICES = [
    (41, 40, 40, False, "auto", "phase"),
    (512, 256, 256, False, "auto", "phase"),
    (513, 10, 10, False, "auto", "iter"),
    (500, 257, 257, False, "auto", "iter"),
    (501, 500, 500, False, "auto", "iter"),  # gpp500: 6.4e7 bytes
    (5000, 5000, 5000, False, "auto", "iter"),  # maxG55: 6.4e9
    (1540, 55, 165, False, "auto", "iter"),  # control11: 3.0e8
    (9682, 10, 10, False, "auto", "iter"),  # 128 m^2 = 11.999e9
    (9683, 10, 10, False, "auto", False),  # 12.0013e9 > 12e9
    (7000, 7000, 7000, False, "auto", False),
    (100, 50, 50, True, "auto", False),  # operator mode: the host loop
    (100, 50, 50, False, True, "phase"),
    (100, 50, 50, False, "iter", "iter"),
    (100, 50, 50, False, "phase", "phase"),
    (100, 50, 50, False, False, False),
    (100, 50, 50, True, True, False),
]


@pytest.mark.parametrize("m,n_max,n_sum,kkt_free,fused,want", CHOICES)
def test_choose_fused_mode_table(m, n_max, n_sum, kkt_free, fused, want):
    assert talgo.choose_fused_mode(m, n_max, n_sum, kkt_free, Params(fused=fused)) == want


@pytest.mark.parametrize("gen,kw,over", [
    ("gpp_sdpa", dict(n=40, seed=0), {}),
    ("maxcut_sdpa", dict(n=300, seed=0), dict(fused_max_n=100)),
    ("control_sdpa", dict(k=6, n_sys=2, seed=0), dict(fused_hbm_budget=1e3)),
    ("maxcut_sdpa", dict(n=40, seed=0), dict(kkt_mode="free")),
])
def test_choice_matches_the_jax_solve(monkeypatch, gen, kw, over):
    """The mode the JAX package's DualIPM.solve hands to solve_fused (or
    False when it runs its host loop) is what the port's solve records."""
    seen = {}
    monkeypatch.setattr(jfused, "solve_fused", lambda ipm, d_only, mode: seen.setdefault(
        "mode", mode))
    monkeypatch.setattr(jalgo.DualIPM, "phase_a", lambda self, d_only=False: seen.setdefault(
        "mode", False))
    jipm = jalgo.DualIPM(JProblem.from_sdpa(getattr(jsyn, gen)(**kw)),
                         JParams(verbose=False, **over))
    jipm.solve()
    tipm = talgo.DualIPM(TProblem.from_sdpa(getattr(tsyn, gen)(**kw)),
                         Params(verbose=False, **over), device="cpu")
    monkeypatch.setattr(tfused, "solve_fused", lambda ipm, d_only, mode: None)
    monkeypatch.setattr(talgo.DualIPM, "phase_a", lambda self, d_only=False: None)
    tipm.solve()
    assert tipm._factor_stats["fused"] == seen["mode"]


def test_fused_values_and_invalid_value():
    prob = TProblem.from_sdpa(tsyn.gpp_sdpa(n=8, seed=0))
    for fused in (True, False, "auto", "phase", "iter"):
        r = TSolver(prob, device="cpu", verbose=False, fused=fused).optimize()
        assert r.status == "PRIMAL_DUAL_OPTIMAL"
        assert r.stats["fused"] == ("phase" if fused in (True, "auto") else fused)
        assert (r.stats.get("fused_host_reads", 0) > 0) == bool(fused)
    with pytest.raises(ValueError, match="fused"):
        TSolver(prob, device="cpu", verbose=False, fused="whole").optimize()


def test_fused_module_imports_no_jax():
    code = (
        "import sys, hdsdp_tpu_torch.solver.fused;"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'hdsdp_tpu.'))"
        " or k == 'hdsdp_tpu'];"
        "print(bad)"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
