"""The port's host-loop solver (fused=False on both sides) end to end
against the JAX package's on every synthetic family, its CLI, its device
policy and what it does not port."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.solver import dimacs as jdimacs
from hdsdp_tpu.solver.solver import HDSDPSolver as JSolver
from hdsdp_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from hdsdp_tpu_torch.io.sdpa import write_sdpa
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
from hdsdp_tpu_torch.solver import algo as talgo
from hdsdp_tpu_torch.solver import dimacs as tdimacs
from hdsdp_tpu_torch.solver.params import Params
from hdsdp_tpu_torch.solver.solver import HDSDPSolver as TSolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX host loop on gpp_sdpa(n=40): one solve per kkt_hp setting
    (solver kept for its final iterate)."""
    out = {}
    for hp in ("on", "off"):
        s = JSolver(JProblem.from_sdpa(jsyn.gpp_sdpa(n=40, seed=0)),
                    verbose=False, fused=False, kkt_hp=hp)
        out[hp] = (s, s.optimize())
    return out


@pytest.mark.parametrize("hp", ["on", "off"])
def test_gpp40_matches_jax(jax_runs, hp):
    _, rj = jax_runs[hp]
    rt = TSolver(TProblem.from_sdpa(tsyn.gpp_sdpa(n=40, seed=0)), device="cpu",
                 verbose=False, fused=False, kkt_hp=hp).optimize()
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert abs(rt.n_iters - rj.n_iters) <= 1
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-7)
    assert np.max(np.abs(rt.dimacs)) < 1e-2
    assert rt.y.shape == (41,) and np.isfinite(rt.y).all()
    assert rt.device == "cpu"


def test_dimacs_check_from_jax_iterate(tmp_path):
    """The port's DIMACS check on a JAX run's state (makers included)
    gives the JAX check's errors.  The run stops at iteration 11, whose
    maker (mu* ~ 1e-3) leaves the check-time S well conditioned; at the
    final maker of this instance cond(S) ~ 1e14 and both checks are
    rounding noise at the 1e-6 level."""
    js = JSolver(JProblem.from_sdpa(jsyn.gpp_sdpa(n=40, seed=0)), verbose=False,
                 fused=False, max_iter=11)
    rj = js.optimize()
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, js.ipm)
    ipm = talgo.DualIPM(TProblem.from_sdpa(tsyn.gpp_sdpa(n=40, seed=0)),
                        Params(verbose=False, max_iter=11), device="cpu")
    talgo.load_state(ipm, load_checkpoint(path))
    errs = tdimacs.check_solution(ipm)
    assert ipm.status == js.ipm.status == "PRIMAL_DUAL_OPTIMAL"
    np.testing.assert_allclose(errs, rj.dimacs, rtol=1e-6, atol=1e-15)
    assert ipm.d_obj_val == pytest.approx(rj.d_obj, rel=1e-12)
    assert ipm.p_obj_val == pytest.approx(rj.p_obj, rel=1e-10)
    # the recovered primal agrees too
    jrec = jdimacs.recover_primal(js.ipm, js.ipm.maker_inacc)
    trec = tdimacs.recover_primal(ipm, ipm.maker_inacc)
    np.testing.assert_allclose(trec[0][0].numpy(), np.asarray(jrec[0][0]),
                               rtol=1e-8, atol=1e-10)


def _mixed():
    """One slot-major block with a dense bucket, plus an LP block."""
    return dict(m=40, block_dims=[30], n_lp=6, seed=1)


def test_mixed_sdp_lp_with_dual_start_matches_jax():
    """SDP + LP cones end to end, started from the same dual point."""
    y0 = np.random.default_rng(4).standard_normal(40) * 1e-2
    js = JSolver(JProblem.from_sdpa(jsyn.random_sdpa(**_mixed())), verbose=False,
                 fused=False)
    js.set_dual_start(y0)
    rj = js.optimize()
    ts = TSolver(TProblem.from_sdpa(tsyn.random_sdpa(**_mixed())), device="cpu",
                 verbose=False, fused=False)
    ts.set_dual_start(y0)
    rt = ts.optimize()
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert abs(rt.n_iters - rj.n_iters) <= 1
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-7)
    assert np.max(np.abs(rt.dimacs)) < 1e-6


def test_solution_getters_from_jax_iterate(tmp_path):
    """get_row_dual, get_dual_slacks and get_primal of both packages at
    one iterate (a JAX run's state moved over by load_state)."""
    js = JSolver(JProblem.from_sdpa(jsyn.random_sdpa(**_mixed())), verbose=False,
                 fused=False, max_iter=30)
    js.optimize()
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, js.ipm)
    ts = TSolver(TProblem.from_sdpa(tsyn.random_sdpa(**_mixed())), device="cpu",
                 verbose=False, max_iter=30)
    ts.ipm = talgo.DualIPM(ts.prob, ts.params, device="cpu")
    talgo.load_state(ts.ipm, load_checkpoint(path))
    np.testing.assert_array_equal(ts.get_row_dual(), js.get_row_dual())
    (Sj,), sj = js.get_dual_slacks()
    (St,), st = ts.get_dual_slacks()
    np.testing.assert_allclose(St, Sj, rtol=1e-12, atol=1e-12 * np.abs(Sj).max())
    np.testing.assert_allclose(st, sj, rtol=1e-12)
    (Xj,), xj = js.get_primal()
    (Xt,), xt = ts.get_primal()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-8, atol=1e-8 * np.abs(Xj).max())
    np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-8 * np.abs(xj).max())


def test_cli_json(tmp_path):
    path = tmp_path / "gpp12.dat-s"
    write_sdpa(tsyn.gpp_sdpa(n=12, seed=1), str(path))
    out = subprocess.run(
        [sys.executable, "-m", "hdsdp_tpu_torch", str(path), "--json", "--quiet",
         "--device", "cpu", "--no-fused"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["status"] == "PRIMAL_DUAL_OPTIMAL"
    assert summary["dimacs_max"] < 1e-2 and summary["device"] == "cpu"
    rj = JSolver(JProblem.from_sdpa(jsyn.gpp_sdpa(n=12, seed=1)), verbose=False,
                 fused=False).optimize()
    assert summary["dObj"] == pytest.approx(rj.d_obj, rel=1e-7)


def test_import_leaves_jax_out():
    code = (
        "import sys, hdsdp_tpu_torch.solver.solver, hdsdp_tpu_torch.__main__;"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'hdsdp_tpu.'))"
        " or k == 'hdsdp_tpu'];"
        "print(bad)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prob = TProblem.from_sdpa(tsyn.gpp_sdpa(n=8, seed=0))
    with pytest.raises(RuntimeError, match="cuda"):
        TSolver(prob)  # the default device is "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        TSolver(prob, device="cuda")


FAMILIES = {
    # name: (generator, kwargs, overrides, bucket, PSDP ends the solve)
    "maxcut": ("maxcut_sdpa", dict(n=40, seed=0), {}, "diag", False),
    "torus": ("torus_sdpa", dict(side=3, seed=0), {}, "diag", False),
    "qpg": ("qpg_sdpa", dict(n=30, seed=0), {}, "diag", False),
    # one cone with n < m/3: phase B hands over to PSDP, which converges
    "theta": ("theta_sdpa", dict(n=30, n_edges=250, seed=0), {}, "support", True),
    "control": ("control_sdpa", dict(k=6, n_sys=2, seed=0), {}, "flat", False),
    # every Schur solve through AdaptiveCG
    "maxcut_cg": ("maxcut_sdpa", dict(n=40, seed=0), dict(kkt_solver="cg"), "diag", False),
    "theta_cg": ("theta_sdpa", dict(n=30, n_edges=250, seed=0), dict(kkt_solver="cg"),
                 "support", True),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_runs(request):
    gen, kw, over, bucket, psdp = FAMILIES[request.param]
    js = JSolver(JProblem.from_sdpa(getattr(jsyn, gen)(**kw)), verbose=False, fused=False,
                 **over)
    rj = js.optimize()
    ts = TSolver(TProblem.from_sdpa(getattr(tsyn, gen)(**kw)), device="cpu", verbose=False,
                 fused=False, **over)
    rt = ts.optimize()
    return dict(name=request.param, js=js, rj=rj, ts=ts, rt=rt, bucket=bucket, psdp=psdp,
                cg="kkt_solver" in over)


def test_family_matches_jax(family_runs):
    rj, rt = family_runs["rj"], family_runs["rt"]
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert abs(rt.n_iters - rj.n_iters) <= 1
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-7)
    assert rt.p_obj == pytest.approx(rj.p_obj, rel=1e-7)
    assert np.max(np.abs(rt.dimacs)) < 1e-6
    np.testing.assert_allclose(rt.y, rj.y, rtol=1e-5, atol=1e-6 * np.abs(rj.y).max())


def test_family_runs_its_bucket_and_solver(family_runs):
    from hdsdp_tpu_torch.ops.schur import bucket

    ts, js, rt, rj = (family_runs[k] for k in ("ts", "js", "rt", "rj"))
    assert [bucket(g) for g in ts.ipm.cones.groups] == [family_runs["bucket"]]
    for k in ("n_factor", "n_solve", "n_kkt"):
        assert abs(rt.stats[k] - rj.stats[k]) <= 3, k
    assert ("cg_n_factor" in rt.stats) == family_runs["cg"]
    if family_runs["cg"]:
        # the policy's evidence survives release_solve_buffers, the object not
        assert ts.ipm._cg is None and rt.stats["cg_summary"]["refine"]["n"] > 0
        assert abs(rt.stats["cg_n_factor"] - rj.stats["cg_n_factor"]) <= 2
        assert abs(rt.stats["cg_n_solve"] - rj.stats["cg_n_solve"]) <= 6
        assert 0 < rt.stats["cg_n_factor"] < rt.stats["cg_n_solve"]


def test_family_primal(family_runs):
    """get_primal of both packages: the refined X where PSDP ended the
    solve, else the maker's recovery."""
    ts, js = family_runs["ts"], family_runs["js"]
    assert (ts.ipm.psdp is not None) == (js.ipm.psdp is not None) == family_runs["psdp"]
    assert ts.params.psdp == (1 if family_runs["psdp"] else 0)
    if family_runs["psdp"]:
        assert ts.ipm.psdp.converged and family_runs["rt"].stats["psdp_runs"] == 1
        assert ts.ipm.psdp.n_iter == family_runs["rt"].stats["psdp_iters"] >= 10
    Xt, xt = ts.get_primal()
    Xj, xj = js.get_primal()
    assert (xt is None) == (xj is None)
    for a, b in zip(Xt, Xj):
        a, b = a + a.T, np.asarray(b) + np.asarray(b).T
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


def test_two_solves_repeat_bit_for_bit():
    """Every reduction over duplicate indices has a fixed order, so one
    process solves one instance twice with identical bits (support bucket
    + PSDP + AdaptiveCG here; the card is held to the same by its smoke
    run)."""
    prob = TProblem.from_sdpa(tsyn.theta_sdpa(n=30, n_edges=250, seed=0))
    a = TSolver(prob, device="cpu", verbose=False, fused=False, kkt_solver="cg").optimize()
    b = TSolver(prob, device="cpu", verbose=False, fused=False, kkt_solver="cg").optimize()
    assert a.d_obj == b.d_obj and a.p_obj == b.p_obj and a.n_iters == b.n_iters
    np.testing.assert_array_equal(a.y, b.y)


def test_psdp_failure_switches_it_off_and_the_dual_method_finishes():
    """random_sdpa(m=30, [8], seed=4): the refiner fails in both packages
    (see test_torch_psdp), phase B goes on without it and ends optimal."""
    kw = dict(m=30, block_dims=[8], seed=4)
    js = JSolver(JProblem.from_sdpa(jsyn.random_sdpa(**kw)), verbose=False, fused=False)
    rj = js.optimize()
    ts = TSolver(TProblem.from_sdpa(tsyn.random_sdpa(**kw)), device="cpu", verbose=False,
                 fused=False)
    rt = ts.optimize()
    assert ts.ipm.psdp is None and js.ipm.psdp is None
    assert rt.stats["psdp_runs"] == 1 and rt.stats["psdp_iters"] > 0
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-7)
    assert np.max(np.abs(rt.dimacs)) < 1e-6


def test_cone_system_layout_argument():
    from hdsdp_tpu_torch.ops.schur import bucket
    from hdsdp_tpu_torch.solver.cones import ConeSystem

    prob = TProblem.from_sdpa(tsyn.maxcut_sdpa(n=10, seed=0))
    assert [bucket(ConeSystem(prob, "cpu", layout=k).groups[0])
            for k in ("auto", "slot", "flat")] == ["diag", "slot", "flat"]
    cs = ConeSystem(prob, "cpu")
    assert (cs.group_dims, cs.group_nblk, cs.n_cones) == ([10], [1], 1)
    with pytest.raises(ValueError, match="layout"):
        ConeSystem(prob, "cpu", layout="packed")


@pytest.mark.parametrize("override,what", [
    (dict(fused="phase", cone_fp="dd"), "ddchol"),
    (dict(cone_fp="dd"), "ddchol"),
    (dict(kkt_fp="dd", fused=False), "ddchol"),
])
def test_unported_options_raise(override, what):
    """The double-single options ("ddchol": cone_fp / kkt_fp = "dd"), which
    raised until ops.ddchol was ported, now solve and must match the JAX package's run with the same
    overrides: status, iterations +-1, d_obj 1e-7.  At this size (one 8 x 8
    block, m = 9) cone_fp="dd" sets the flag and leaves the factor in f64
    (the DD cone factor starts at n = 512, as in the JAX package), and
    kkt_fp="dd" on the host loop factors every Schur system with ddchol."""
    prob = TProblem.from_sdpa(tsyn.gpp_sdpa(n=8, seed=0))
    rj = JSolver(JProblem.from_sdpa(jsyn.gpp_sdpa(n=8, seed=0)), verbose=False,
                 **override).optimize()
    # one torch thread: the DD panel factor is thousands of tiny calls, which
    # stall when every worker of the tier-1 run spins eight threads
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ts = TSolver(prob, device="cpu", verbose=False, **override)
        rt = ts.optimize()
    finally:
        torch.set_num_threads(n_threads)
    assert ts.ipm.cones.cone_dd == (override.get("cone_fp") == "dd")
    assert ts.ipm._use_dd() == (override.get("kkt_fp") == "dd")
    assert rt.status == rj.status == "PRIMAL_DUAL_OPTIMAL"
    assert abs(rt.n_iters - rj.n_iters) <= 1
    assert rt.d_obj == pytest.approx(rj.d_obj, rel=1e-7)


def test_kkt_hp_auto_is_off():
    prob = TProblem.from_sdpa(tsyn.gpp_sdpa(n=8, seed=0))
    ipm = talgo.DualIPM(prob, Params(verbose=False, kkt_hp="auto"), device="cpu")
    assert ipm.cones.kkt_hp is False
    ipm = talgo.DualIPM(prob, Params(verbose=False, kkt_hp="on"), device="cpu")
    assert ipm.cones.kkt_hp is True and ipm.cones.dual_hp is False


@pytest.mark.parametrize("field", ["kkt_dd_threshold", "cone_dd_threshold",
                                   "kkt_mp_threshold", "kkt_hp_threshold"])
def test_size_thresholds_of_the_tpu_tiers_are_gone(field):
    """The JAX package's size gates of its TPU tiers decide nothing on the
    port, which has no such fields."""
    with pytest.raises(TypeError):
        Params(**{field: 768})


class _Forbidden(RuntimeError):
    pass


@pytest.fixture(scope="module")
def maxcut768():
    """One block of n = 768 and m = 768: at the JAX package's thresholds of
    the DD cone factor and the DD Schur factor (768 each)."""
    return TProblem.from_sdpa(tsyn.maxcut_sdpa(n=768, seed=0))


@pytest.mark.parametrize("fused", [False, "auto"], ids=["host", "fused"])
@pytest.mark.parametrize("option,f64,on", [("cone_fp", "off", "dd"), ("kkt_fp", "xla", "dd"),
                                           ("kkt_mp", "off", "on")])
def test_auto_is_the_f64_path(maxcut768, option, f64, on, fused, monkeypatch):
    """An option's "auto" solves bit for bit as its f64 setting, on the host
    loop and on the fused driver ("iter" at m = 768), and neither runs a DD
    factor, an Ozaki product or the mixed-precision refinement (each made to
    raise here); the setting that turns the tier on reaches it.  Four
    iterations: the tiers act from the first."""
    from hdsdp_tpu_torch.ops import cg, ddchol, hpmm

    calls = []

    def forbid(name):
        def f(*a, **k):
            calls.append(name)
            raise _Forbidden(name)
        return f

    for mod, name in ((ddchol, "factor"), (hpmm, "hpmm"), (cg, "refine_solve")):
        monkeypatch.setattr(mod, name, forbid(name))
    over = dict(device="cpu", verbose=False, fused=fused, max_iter=4)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = [TSolver(maxcut768, **over, **{option: v}).optimize() for v in ("auto", f64)]
        assert not calls
        acts = (option, fused) in {("cone_fp", False), ("cone_fp", "auto"), ("kkt_fp", False),
                                   ("kkt_mp", "auto")}
        if acts:
            with pytest.raises(_Forbidden):
                TSolver(maxcut768, **over, **{option: on}).optimize()
            assert calls
    finally:
        torch.set_num_threads(n_threads)
    a, b = runs
    assert a.stats["fused"] == b.stats["fused"] == ("iter" if fused else False)
    assert (a.status, a.n_iters, a.d_obj, a.p_obj) == (b.status, b.n_iters, b.d_obj, b.p_obj)
    np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(a.dimacs, b.dimacs)


@pytest.mark.cuda
def test_small_solve_on_card_matches_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hdsdp_tpu_torch.ops import hpmm

    prob = TProblem.from_sdpa(tsyn.gpp_sdpa(n=40, seed=0))
    before = hpmm.KERNEL_LAUNCHES
    rg = TSolver(prob, device="cuda", verbose=False, fused=False, kkt_hp="on").optimize()
    rc = TSolver(prob, device="cpu", verbose=False, fused=False, kkt_hp="on").optimize()
    assert hpmm.KERNEL_LAUNCHES > before
    assert rg.status == rc.status == "PRIMAL_DUAL_OPTIMAL"
    assert abs(rg.n_iters - rc.n_iters) <= 1
    assert rg.d_obj == pytest.approx(rc.d_obj, rel=1e-7)
