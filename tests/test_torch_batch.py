"""The port's solve_batch (hdsdp_tpu_torch.solver.batch) against the JAX
package's solve_batch and against the port's own solo fused solve, on the
same numpy-built problems, on the CPU.

Each fleet runs once per module (fixtures): the JAX package's vmapped
program, the port's masked fleet, and the port's default (fused) solve of
every instance alone.  Every instance is held to both in status,
iterations (+-1) and d_obj (1e-7 relative).  Also: the fleet's Schur
buckets and cone functions against the same functions on each instance
alone (the padded summation tables of the theta and flat layouts), and,
at sizes where batched products round as single ones, each member bit for
bit against its solo solve."""

import numpy as np
import pytest
import torch

from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.models.synthetic import maxcut_sdpa as jmaxcut
from hdsdp_tpu.models.synthetic import random_sdpa as jrandom
from hdsdp_tpu.models.synthetic import theta_sdpa as jtheta
from hdsdp_tpu.solver.batch import solve_batch as jsolve_batch
from hdsdp_tpu_torch import solve_batch
from hdsdp_tpu_torch.models.problem import SDPProblem
from hdsdp_tpu_torch.models.synthetic import (
    control_sdpa,
    gpp_sdpa,
    maxcut_sdpa,
    random_sdpa,
    theta_sdpa,
)
from hdsdp_tpu_torch.ops import schur
from hdsdp_tpu_torch.solver import algo, cones
from hdsdp_tpu_torch.solver.params import Params
from hdsdp_tpu_torch.solver.solver import HDSDPSolver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side is small torch calls: one thread keeps them from
    stalling when the tier-1 run's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _negated_b(data):
    data.b = -data.b  # diag(X) = -1: primal infeasible, the dual unbounded
    return data


# name -> (port generator calls, JAX generator calls); both packages'
# generators draw the same numpy numbers
FLEETS = {
    "random": ([lambda s=s: random_sdpa(m=16, block_dims=[8], n_lp=0, seed=s) for s in (21, 22, 23)],
               [lambda s=s: jrandom(m=16, block_dims=[8], n_lp=0, seed=s) for s in (21, 22, 23)]),
    "maxcut": ([lambda s=s: maxcut_sdpa(n=40, seed=s) for s in range(4)],
               [lambda s=s: jmaxcut(n=40, seed=s) for s in range(4)]),
    # different graphs: the support bucket's tables differ in size
    "theta": ([lambda s=s: theta_sdpa(n=20, n_edges=40, seed=s) for s in range(3)],
              [lambda s=s: jtheta(n=20, n_edges=40, seed=s) for s in range(3)]),
    # the last instance leaves the A -> B path (phase B finds a dual ray)
    "leaves": ([lambda s=s: maxcut_sdpa(n=40, seed=s) for s in range(3)]
               + [lambda: _negated_b(maxcut_sdpa(n=40, seed=3))],
               [lambda s=s: jmaxcut(n=40, seed=s) for s in range(3)]
               + [lambda: _negated_b(jmaxcut(n=40, seed=3))]),
}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, (tgen, jgen) in FLEETS.items():
        tdata = [g() for g in tgen]
        jdata = [g() for g in jgen]
        for a, b in zip(tdata, jdata):
            np.testing.assert_array_equal(a.b, b.b)  # the same problems
        tprobs = [SDPProblem.from_sdpa(d) for d in tdata]
        out[name] = dict(
            probs=tprobs,
            port=solve_batch(tprobs, device="cpu"),
            jax=jsolve_batch([JProblem.from_sdpa(d) for d in jdata]),
            solo=[HDSDPSolver(p, device="cpu", verbose=False).optimize() for p in tprobs],
        )
    return out


def _hold(r, ref, what):
    assert r.status == ref.status, what
    assert abs(r.n_iters - ref.n_iters) <= 1, (what, r.n_iters, ref.n_iters)
    assert abs(r.d_obj - ref.d_obj) <= 1e-7 * max(abs(ref.d_obj), 1.0), (what, r.d_obj, ref.d_obj)


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_matches_jax_solve_batch(runs, name):
    r = runs[name]
    assert len(r["port"]) == len(r["jax"]) == len(r["probs"])
    for k, (a, b) in enumerate(zip(r["port"], r["jax"])):
        _hold(a, b, f"{name}[{k}] vs JAX solve_batch")


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_matches_solo_fused_solves(runs, name):
    r = runs[name]
    for k, (a, b) in enumerate(zip(r["port"], r["solo"])):
        _hold(a, b, f"{name}[{k}] vs its solo solve")
        assert b.stats["fused"] == "phase"
        assert a.stats["fleet"]["size"] == len(r["probs"])
        if a.stats["batch_solo"] == 0:
            assert a.stats["fused"] == "batch"
            assert float(np.max(np.abs(a.dimacs))) < 1e-6


def test_fleet_results_are_optimal_and_distinct(runs):
    """test_batch.py's maxcut case: every instance reaches its own optimum."""
    objs = set()
    for r in runs["maxcut"]["port"]:
        assert r.status == "PRIMAL_DUAL_OPTIMAL" and r.stats["batch_solo"] == 0
        objs.add(round(r.d_obj, 6))
    assert len(objs) == 4


def test_instance_leaving_the_path_is_its_solo_solve(runs):
    r = runs["leaves"]
    assert [x.stats["batch_solo"] for x in r["port"]] == [0, 0, 0, 1]
    out, solo = r["port"][3], r["solo"][3]
    assert out.stats["batch_exit"].startswith("phase B: INFEAS_OR_UNBOUNDED")
    assert out.status == solo.status == "INFEAS_OR_UNBOUNDED"
    assert out.n_iters == solo.n_iters and out.d_obj == solo.d_obj and out.p_obj == solo.p_obj
    np.testing.assert_array_equal(out.y, solo.y)
    np.testing.assert_array_equal(out.dimacs, solo.dimacs)


@pytest.mark.parametrize("gen,seeds", [
    (lambda s: random_sdpa(m=16, block_dims=[8], n_lp=0, seed=s), (21, 22, 23)),
    (lambda s: gpp_sdpa(n=24, seed=s), (0, 1, 2)),
], ids=["random", "gpp"])
def test_member_is_independent_of_its_partners(gen, seeds):
    """The masked control flow keeps instances apart: instance a's result
    is bitwise the same in fleet (a, b) and in fleet (a, c), whose
    partners take other numbers of trips through the same loops."""
    a, b, c = (SDPProblem.from_sdpa(gen(s)) for s in seeds)
    ra, rb = (solve_batch([a, p], device="cpu", kkt_hp="on")[0] for p in (b, c))
    assert ra.stats["batch_solo"] == rb.stats["batch_solo"] == 0
    assert ra.n_iters == rb.n_iters and ra.d_obj == rb.d_obj and ra.p_obj == rb.p_obj
    np.testing.assert_array_equal(ra.y, rb.y)


# fleets at sizes where the host's batched BLAS calls round as its single
# calls do: every member repeats its solo solve bit for bit (a fault of the
# masked control flow shows here even where the iterations agree).  The
# padded tables of a theta fleet, and batched products at larger sizes,
# round otherwise, so there the members agree to rounding only.  So does
# gpp-ozaki (ROUNDING_FLEETS) on some CPUs: its M is 41 x 41 f64, so every
# odd member of the fleet's stack starts 8 bytes off a 16-byte boundary,
# and MKL's triangular solve with an AVX-512 code path rounds such an
# operand otherwise than the solo solve's aligned one.
BIT_FLEETS = {
    "gpp-ozaki": ([lambda s=s: gpp_sdpa(n=40, seed=s) for s in range(4)], dict(kkt_hp="on")),
    "maxcut": ([lambda s=s: maxcut_sdpa(n=40, seed=s) for s in range(4)], {}),
    "flat": ([lambda s=s: control_sdpa(k=8, seed=s) for s in range(3)], {}),
    "slot": ([lambda s=s: random_sdpa(m=30, block_dims=[12], seed=s) for s in range(3)], {}),
    # a fleet of one through the Lanczos ratio test (the factors' memory
    # layout survives the stacking), on an instance whose phase B ends
    # OPTIMAL, so that the fleet keeps its own result: at this size gpp's
    # phase B ends NUMERICAL on about a third of the seeds, a rare event
    # of the f32 bound (seed 0 does since the operator goes through L^-1)
    "lanczos": ([lambda: gpp_sdpa(n=40, seed=4)], dict(kkt_hp="on", ratio_test="lanczos")),
}
ROUNDING_FLEETS = {"gpp-ozaki"}


@pytest.mark.parametrize("name", list(BIT_FLEETS))
def test_fleet_member_repeats_its_solo_bits(name):
    """Bit for bit, or, in ROUNDING_FLEETS, as two runs whose products
    round apart: status, d_obj to 1e-7 (``_hold``'s tolerance) and the
    DIMACS grade, which holds p_obj through the gap.  gpp40's last maker is
    nearly singular (cond ~1e14), so X and p_obj move with the rounding
    (6e-5 relative on one CPU) and the grade lands anywhere in 5e-8 - 2e-5
    (fleet and solo, four seeds): held to 1e-4, two orders inside the
    check's 1e-2 gate.  The iteration count of the two trajectories is not
    held."""
    gens, over = BIT_FLEETS[name]
    probs = [SDPProblem.from_sdpa(g()) for g in gens]
    fleet = solve_batch(probs, device="cpu", **over)
    for k, (a, p) in enumerate(zip(fleet, probs)):
        b = HDSDPSolver(p, device="cpu", verbose=False, **over).optimize()
        assert a.stats["batch_solo"] == 0, (name, k)
        if name in ROUNDING_FLEETS:
            assert a.status == b.status == "PRIMAL_DUAL_OPTIMAL", (name, k, a.n_iters, b.n_iters)
            assert abs(a.d_obj - b.d_obj) <= 1e-7 * max(abs(b.d_obj), 1.0), (name, k)
            assert np.max(np.abs(a.dimacs)) <= 1e-4 and np.max(np.abs(b.dimacs)) <= 1e-4, (
                name, k, a.dimacs, b.dimacs)
        else:
            assert (a.status, a.n_iters, a.d_obj, a.p_obj) == (b.status, b.n_iters, b.d_obj,
                                                               b.p_obj), (name, k)
            np.testing.assert_array_equal(a.y, b.y)
        # the solo solve's phase B ended OPTIMAL too (before its DIMACS check)
        assert b.stats["fused_exit"] == f"phase B: PRIMAL_DUAL_OPTIMAL at iteration {b.n_iters}"


def test_stacking_keeps_the_memory_layout():
    from hdsdp_tpu_torch.solver import fused

    A = torch.randn(3, 5, 5, dtype=torch.float64)
    L, _ = torch.linalg.cholesky_ex(A @ A.mT + 5 * torch.eye(5, dtype=torch.float64))
    assert not L.is_contiguous()  # column-major, as LAPACK leaves it
    st = fused.stack_tree([L[:1], L[1:2]])
    assert st.stride()[1:] == L[:1].stride()
    torch.testing.assert_close(st[:, 0], L[:2], rtol=0, atol=0)


def test_theta_fleet_pads_its_tables(runs):
    groups = [algo.DualIPM(p, Params(verbose=False), device="cpu").cones.groups[0]
              for p in runs["theta"]["probs"]]
    assert {schur.bucket(g) for g in groups} == {"support"}
    # the instances' tables differ, so the fleet's are padded
    assert len({tuple(g.stab.shape) for g in groups}) > 1
    st = schur.stack_groups(groups)
    assert st.stab.shape[1:] == tuple(max(g.stab.shape[d] for g in groups) for d in (0, 1))


def test_mixed_shapes_raise():
    probs = [
        SDPProblem.from_sdpa(random_sdpa(m=16, block_dims=[8], seed=1)),
        SDPProblem.from_sdpa(random_sdpa(m=20, block_dims=[8], seed=2)),
    ]
    with pytest.raises(ValueError):
        solve_batch(probs, device="cpu")
    assert solve_batch([], device="cpu") == []


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        solve_batch([SDPProblem.from_sdpa(maxcut_sdpa(n=10, seed=0))])


# -- the fleet's cone functions against each instance alone -----------------

FAMILIES = {
    "diag": lambda s: maxcut_sdpa(n=30, seed=s),
    "diag-gather": lambda s: maxcut_sdpa(n=30, seed=s),  # dpos forced below
    "support": lambda s: theta_sdpa(n=16, n_edges=30, seed=s),
    "slot": lambda s: gpp_sdpa(n=24, seed=s),
    "flat": lambda s: control_sdpa(k=6, n_sys=2, seed=s),
    "slot+lp": lambda s: random_sdpa(m=24, block_dims=[10], n_lp=6, seed=s),
}


def _fleet_setup(family, hp):
    ipms = [algo.DualIPM(SDPProblem.from_sdpa(FAMILIES[family](s)), Params(verbose=False),
                         device="cpu") for s in range(3)]
    gss = [ipm.cones.groups for ipm in ipms]
    if family == "diag-gather":  # the diag bucket with a position map
        gss = [tuple(schur.with_tables(g._replace(dpos=torch.roll(torch.arange(g.dw.shape[0]),
                                                                   s + 1)), g.dw.shape[0])
                     for g in gs) for s, gs in enumerate(gss)]
    lps = [ipm.cones.lp for ipm in ipms]
    m = ipms[0].m
    rng = np.random.default_rng(7)
    ys = [torch.as_tensor(rng.standard_normal(m) * 0.1) for _ in ipms]
    return ipms, gss, lps, m, ys


@pytest.mark.parametrize("hp", [False, True], ids=["f64", "ozaki"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_fleet_cone_functions_match_instances(family, hp):
    ipms, gss, lps, m, ys = _fleet_setup(family, hp)
    n_f = len(ipms)
    fleet_groups = tuple(schur.stack_groups([gs[i] for gs in gss]) for i in range(len(gss[0])))
    fleet_lp = None if lps[0] is None else schur.LPArrays(
        A=torch.stack([lp.A for lp in lps]), c=torch.stack([lp.c for lp in lps]))
    y = torch.stack(ys)
    tau = torch.tensor([1.0, 0.9, 1.1], dtype=torch.float64)
    dEye = torch.tensor([5.0, 6.0, 7.0], dtype=torch.float64)
    S, s_lp = cones.assemble(fleet_groups, fleet_lp, tau, -1.0, y, dEye, hp=hp)
    ok, L = cones.factor(S, s_lp)
    assert ok.shape == (n_f,)
    ld = cones.logdet(L, s_lp)
    Rd = torch.tensor([-1.0, -2.0, -0.5], dtype=torch.float64)
    kkt = cones.build_kkt(fleet_groups, fleet_lp, L, s_lp, Rd, m, "hsd", hp=hp)
    for i in range(n_f):
        Si, s_lpi = cones.assemble(gss[i], lps[i], tau[i], -1.0, ys[i], dEye[i], hp=hp)
        oki, Li = cones.factor(Si, s_lpi)
        assert bool(ok[i]) == bool(oki)
        for a, b in zip(S, Si):
            torch.testing.assert_close(a[i], b, rtol=1e-13, atol=1e-13)
        if bool(oki):
            torch.testing.assert_close(ld[i], cones.logdet(Li, s_lpi), rtol=1e-13, atol=1e-13)
            ki = cones.build_kkt(gss[i], lps[i], Li, s_lpi, Rd[i], m, "hsd", hp=hp)
            for f in ki._fields:
                torch.testing.assert_close(getattr(kkt, f)[i], getattr(ki, f), rtol=1e-11,
                                           atol=1e-11 * float(getattr(ki, f).abs().max()))
