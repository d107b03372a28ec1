"""The port's mesh path (hdsdp_tpu_torch.parallel) against the JAX
package's (hdsdp_tpu.parallel), on the CPU.

Port side: one gloo world of 4 ranks (``parallel.mesh.spawn``; the
children import only hdsdp_tpu_torch and run ``parallel.run``'s bodies),
started in a thread when the module begins, so that the JAX side runs
meanwhile.  JAX side: ``make_mesh(4)`` in this process (conftest gives 8
virtual devices).  Tolerances: the Schur matrix gathered from the shards
1e-12 max|M| and its identity tail exact; vectors 1e-12 of their scale;
the distributed factor 1e-12, its solves 1e-10; the sharded PCG 1e-10
with the same step count; the sharded operator matvec 1e-12 against the
port's single-device one; end to end status, iterations +-1 and d_obj
1e-7 relative (1e-6 for the float32 solve), with every rank's y
bit-equal; kkt_fp="dd" bit for bit the default run, and one rank's DD
cone factor bit for bit the single-device one."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.parallel import make_mesh as jmake_mesh
from hdsdp_tpu.solver.solver import HDSDPSolver as JSolver
from hdsdp_tpu_torch.io.sdpa import BlockEntries, SDPAData
from hdsdp_tpu_torch.parallel import run
from hdsdp_tpu_torch.parallel.mesh import spawn

NDEV = 4
WORLD_TIMEOUT = 60.0  # every collective of the world

KKT_CASES = {
    # (generator, kwargs, system, kkt_hp)
    "random_sharded": ("random_sdpa", dict(m=20, block_dims=[10, 6], n_lp=4, seed=5),
                       "sharded", False),
    "control_sharded": ("control_sdpa", dict(k=6, n_sys=2, seed=0), "sharded", False),
    "theta_row": ("theta_sdpa", dict(n=50, n_edges=300, seed=4), "row", False),
    "maxcut_row": ("maxcut_sdpa", dict(n=96, seed=4), "row", False),
    "gpp_row_hp": ("gpp_sdpa", dict(n=40, seed=0), "row", True),
}
MATVEC_CASES = {
    "theta_row": ("theta_sdpa", dict(n=50, n_edges=300, seed=4), "row"),
    "maxcut_row": ("maxcut_sdpa", dict(n=96, seed=4), "row"),
    "gpp_row": ("gpp_sdpa", dict(n=40, seed=0), "row"),
    "random_row": ("random_sdpa", dict(m=30, block_dims=[20], n_lp=4, seed=2), "row"),
    "control_sharded": ("control_sdpa", dict(k=6, n_sys=2, seed=0), "sharded"),
    "random3_sharded": ("random_sdpa", dict(m=30, block_dims=[12, 12, 12], seed=2), "sharded"),
}


def _hsd_data(pkg):
    """The JAX package's dual-infeasible instance (tests/test_parallel.py
    test_mesh_hsd_path): det(C - y A1) = -1 on block 1, so no dual
    interior exists and the HSD phase must run; m = 1 leaves three of the
    four ranks without a row."""
    return pkg.SDPAData(
        m=1, block_dims=[2, 3], b=np.array([1.0]),
        blocks=[
            pkg.BlockEntries(dim=2, con=np.array([0, 1], np.int32),
                             row=np.array([1, 0], np.int32), col=np.array([0, 0], np.int32),
                             val=np.array([1.0, 1.0])),
            pkg.BlockEntries(dim=3, con=np.zeros(3, np.int32),
                             row=np.arange(3, dtype=np.int32), col=np.arange(3, dtype=np.int32),
                             val=np.ones(3)),
        ],
        nnz=5,
    )


class _TorchSDPA:
    SDPAData, BlockEntries = SDPAData, BlockEntries


class _JaxSDPA:
    from hdsdp_tpu.io.sdpa import BlockEntries, SDPAData


THETA40 = ("theta_sdpa", dict(n=40, n_edges=200, seed=9))
E2E_CASES = {
    # the random multi-block + LP instance (both packages pick the
    # row-sharded system: every group is one block)
    "random": (("random_sdpa", dict(m=20, block_dims=[10, 6], n_lp=4, seed=5)), {}),
    "hsd": ((_hsd_data, None), {}),
    # theta n = 40: row-sharded, distributed Cholesky, PSDP handoff
    "theta40": (THETA40, {}),
    "theta40_free": (THETA40, dict(kkt_mode="free")),
    # three equal blocks in one group: the slot-partitioned system
    "control": (("control_sdpa", dict(k=5, n_sys=2, seed=0)), {}),
    # cone_fp="dd" is honoured on a mesh (below n = 512 it sets the flag
    # and the factor stays f64, in both packages)
    "random_cone_dd": (("random_sdpa", dict(m=20, block_dims=[10, 6], n_lp=4, seed=5)),
                       dict(cone_fp="dd")),
    # dtype="float32" on the mesh (the row-sharded system), promoted as
    # the JAX package promotes it (tests/test_torch_f32.py)
    "maxcut_f32": (("maxcut_sdpa", dict(n=20, seed=0)), dict(dtype="float32")),
}
# d_obj of a float32 solve is a float32 DIMACS evaluation: held to 1e-6
# (tests/test_torch_f32.py), every other case to 1e-7
D_OBJ_REL = {"maxcut_f32": 1e-6}
# kkt_fp="dd" on a mesh changes nothing (the Schur factor is the
# distributed Cholesky, also in PSDP): key -> (the E2E case it must repeat
# bit for bit, overrides)
SAME_AS_CASES = {
    "random_kkt_dd": ("random", dict(kkt_fp="dd")),
    "theta40_kkt_dd": ("theta40", dict(kkt_fp="dd")),
}
# one rank's DD cone factor of a single 512 x 512 block
CONE_FACTOR = ("maxcut_sdpa", dict(n=512, seed=3))


def _dchol_inputs():
    rng = np.random.default_rng(0)
    m = 217  # uneven: exercises both paddings
    A = rng.normal(size=(m, m))
    return dict(M=A @ A.T + m * np.eye(m), rhs=rng.normal(size=(m, 3)),
                bad=A @ A.T - 1e3 * np.eye(m), block=32)


def _pcg_inputs():
    rng = np.random.default_rng(1)
    m = 217
    A = rng.normal(size=(m, m)) / np.sqrt(m)
    return dict(M=A @ A.T + np.diag(1.0 + rng.random(m)), rhs=rng.normal(size=m))


def _port_calls():
    calls = []
    for gen, kw, system, hp in KKT_CASES.values():
        calls.append(("kkt", dict(gen=gen, kwargs=kw, system=system, kkt_hp=hp)))
    calls.append(("dchol", _dchol_inputs()))
    calls.append(("pcg", _pcg_inputs()))
    for gen, kw, system in MATVEC_CASES.values():
        calls.append(("matvec", dict(gen=gen, kwargs=kw, system=system)))
    for (gen, kw), over in E2E_CASES.values():
        if callable(gen):
            gen, kw = gen(_TorchSDPA), {}
        calls.append(("solve", dict(gen=gen, kwargs=kw, overrides=over)))
    for base, over in SAME_AS_CASES.values():
        (gen, kw), base_over = E2E_CASES[base]
        calls.append(("solve", dict(gen=gen, kwargs=kw, overrides=dict(base_over, **over))))
    calls.append(("cone_factor", dict(gen=CONE_FACTOR[0], kwargs=CONE_FACTOR[1])))
    calls.append(("dryrun", {}))
    calls.append(("collectives", {}))
    return calls


@pytest.fixture(scope="module")
def port():
    """Every port-side result, from one world of 4 ranks running in a
    thread while the JAX side computes; ``port()`` waits for it."""
    calls = _port_calls()
    box = {}

    def go():
        try:
            box["out"] = spawn(run.calls, NDEV, "gloo", "cpu", calls,
                               timeout=WORLD_TIMEOUT)
        except BaseException as e:  # handed to the tests
            box["err"] = e

    th = threading.Thread(target=go, daemon=True)
    th.start()

    def get():
        th.join()
        if "err" in box:
            raise box["err"]
        out = iter(box["out"])
        res = {}
        for key in KKT_CASES:
            res["kkt", key] = next(out)
        res["dchol"] = next(out)
        res["pcg"] = next(out)
        for key in MATVEC_CASES:
            res["matvec", key] = next(out)
        for key in E2E_CASES:
            res["solve", key] = next(out)
        for key in SAME_AS_CASES:
            res["solve", key] = next(out)
        res["cone_factor"] = next(out)
        res["dryrun"] = next(out)
        res["collectives"] = next(out)
        return res

    memo = {}

    def cached():
        if "v" not in memo:
            memo["v"] = get()
        return memo["v"]

    return cached


@pytest.fixture(scope="module")
def mesh():
    return jmake_mesh(NDEV)


def _close(got, want, scale_tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    assert float(np.max(np.abs(got - want), initial=0.0)) <= scale_tol * scale


@pytest.mark.parametrize("key", sorted(KKT_CASES))
def test_kkt_matches_jax(port, mesh, key):
    """(a) ShardedConeSystem and (b) RowShardedConeSystem: assemble and
    build_kkt of each kind against the JAX class at the same point (the
    JAX row-sharded build never passes kkt_hp on, so its gpp M is plain
    f64 where the port's rows come from the Ozaki products: 1e-12
    covers their 2^-45)."""
    from hdsdp_tpu.parallel.schur import RowShardedConeSystem, ShardedConeSystem

    gen, kw, system, _ = KKT_CASES[key]
    prob = JProblem.from_sdpa(getattr(jsyn, gen)(**kw))
    cls = ShardedConeSystem if system == "sharded" else RowShardedConeSystem
    jc = cls(prob, mesh)
    y = jnp.asarray(np.random.default_rng(11).normal(size=prob.m) * 0.01)
    shift = 10.0 + prob.features.obj_fro_norm
    S, s_lp = jc.assemble(1.0, -1.0, y, shift)
    ok, L = jc.factor(S, s_lp)
    got = port()["kkt", key]
    assert bool(ok) and got["ok"]
    for a, b in zip(got["S"], S):
        _close(a, b, 1e-12)
    m = prob.m
    for kind in ("hsd", "inf", "corr"):
        kj = jc.build_kkt(L, s_lp, -1.3, kind)
        kt = got[kind]
        for f in ("asinv", "asinvrdsinv", "asinvcsinv", "csinv", "csinvcsinv", "csinvrdsinv",
                  "trace_sinv"):
            vj = getattr(kj, f)
            assert (vj is None) == (kt[f] is None), f
            if vj is not None:
                _close(kt[f], vj, 1e-12)
        if kind == "corr":
            assert "M" not in kt
            continue
        Mt, Mj = kt["M"], np.asarray(kj.M)
        assert Mt.shape == Mj.shape == (got["m_pad"],) * 2
        scale = float(np.max(np.abs(Mj[:m, :m])))
        assert float(np.max(np.abs(Mt[:m, :m] - Mj[:m, :m]))) <= 1e-12 * scale
        pad = Mt.shape[0] - m
        np.testing.assert_array_equal(Mt[m:, m:], np.eye(pad))  # the identity tail, exact
        assert not Mt[m:, :m].any() and not Mt[:m, m:].any()
        assert max(kt["rows_per_rank"]) < m  # no rank held every row
        assert sum(kt["rows_per_rank"]) == Mt.shape[0]


def test_distributed_cholesky_matches_jax(port, mesh):
    """(c) sharded_cholesky / sharded_chol_solve at m = 217, block 32:
    the factor 1e-12, one and three right-hand sides 1e-10, the non-PSD
    matrix flagged (tests/test_parallel.py test_distributed_cholesky)."""
    from hdsdp_tpu.parallel.dchol import sharded_chol_solve, sharded_cholesky

    inp = _dchol_inputs()
    fac = sharded_cholesky(mesh, jnp.asarray(inp["M"]), block=32)
    got = port()["dchol"]
    m = inp["M"].shape[0]
    assert got["ok"] and bool(fac.ok)
    assert got["mp"] == fac.mp == 256 and got["rows"] == 64
    Lj = np.asarray(fac.L)[:m, :m]
    _close(got["L"][:m, :m], Lj, 1e-12)
    xj = np.asarray(sharded_chol_solve(fac, jnp.asarray(inp["rhs"])))
    x_ref = np.linalg.solve(inp["M"], inp["rhs"])
    np.testing.assert_allclose(got["x"], xj, atol=1e-10)
    np.testing.assert_allclose(got["x"], x_ref, atol=1e-10)
    np.testing.assert_allclose(got["x1"], x_ref[:, 0], atol=1e-10)
    assert not got["bad_ok"]
    assert not bool(sharded_cholesky(mesh, jnp.asarray(inp["bad"]), block=32).ok)


def test_sharded_pcg_matches_jax(port, mesh):
    """(d) sharded_pcg: x within 1e-10, the same step count."""
    from hdsdp_tpu.parallel.cg import sharded_pcg

    inp = _pcg_inputs()
    xj, itj = sharded_pcg(mesh, jnp.asarray(inp["M"]), jnp.asarray(inp["rhs"]))
    got = port()["pcg"]
    np.testing.assert_allclose(got["x"], np.asarray(xj), atol=1e-10)
    assert got["iters"] == int(itj) > 0


@pytest.mark.parametrize("key", sorted(MATVEC_CASES))
def test_sharded_operator_matvec(port, key):
    """(e) the sharded operator matvec (each rank's rows of U W U, partial
    inner products, one all_reduce) against the port's single-device
    group_schur_matvec on the same groups, 1e-12."""
    got = port()["matvec", key]
    assert got["ok"]
    _close(got["sharded"], got["single"], 1e-12)
    assert got["counts"].get("all_reduce", 0) >= 1


@pytest.mark.parametrize("key", sorted(E2E_CASES))
def test_end_to_end_matches_jax_mesh(port, mesh, key):
    """(f) a solve on 4 ranks against the JAX package's solve on a mesh
    of 4: status, iterations +-1, d_obj 1e-7 relative; every rank ends
    on the same y, bit for bit."""
    (gen, kw), over = E2E_CASES[key]
    data = gen(_JaxSDPA) if callable(gen) else getattr(jsyn, gen)(**kw)
    js = JSolver(JProblem.from_sdpa(data), mesh=mesh, verbose=False, **over)
    rj = js.optimize()
    got = port()["solve", key]
    assert got["same_y"] and got["same_obj"]
    assert got["size"] == NDEV and got["stats"]["fused"] is False
    assert got["status"] == rj.status
    assert abs(got["iterations"] - rj.n_iters) <= 1
    assert abs(got["d_obj"] - rj.d_obj) <= D_OBJ_REL.get(key, 1e-7) * max(abs(rj.d_obj), 1.0)
    assert got["cones"] == type(js.ipm.cones).__name__
    if key == "hsd":
        assert got["which_method"] == js.ipm.which_method == "hsd"
    if key == "theta40":
        assert got["psdp"] and js.ipm.psdp is not None and js.ipm.psdp.X is not None
        assert np.max(np.abs(got["dimacs"])) < 1e-2
    if key == "theta40_free":
        assert got["kkt_free"] and got["stats"].get("opcg_iters", 0) > 0
        assert rj.stats.get("opcg_iters", 0) > 0
    if key == "control":
        assert got["cones"] == "ShardedConeSystem"
        assert got["counts"].get("reduce_scatter", 0) > 0
    if key == "random_cone_dd":
        assert js.ipm.cones.cone_dd
    if key == "maxcut_f32":
        assert got["y"].dtype == np.asarray(js.ipm.y).dtype == np.float64


@pytest.mark.parametrize("key", sorted(SAME_AS_CASES))
def test_kkt_dd_on_a_mesh_changes_nothing(port, key):
    """kkt_fp="dd" on a mesh is inert, as in the JAX package (its mesh
    systems are row-sharded, so factor_kkt never reaches _direct_factor,
    the only reader of _use_dd; theta40 also runs PSDP's factors there):
    the solve repeats the default mesh run's iterates bit for bit."""
    base = port()["solve", SAME_AS_CASES[key][0]]
    got = port()["solve", key]
    assert got["same_y"] and got["status"] == base["status"]
    assert got["iterations"] == base["iterations"]
    assert got["d_obj"] == base["d_obj"] and got["p_obj"] == base["p_obj"]
    np.testing.assert_array_equal(got["y"], base["y"])
    assert got["log_rows"] == base["log_rows"]
    assert got["psdp"] == base["psdp"]


def test_dd_cone_factor_on_a_mesh_rank(port):
    """cone_fp="dd" reaches the DD blocked Cholesky on every rank: the
    row-sharded system's factor of a single 512 x 512 block is bit for
    bit the single-device ConeSystem's, and it is not the f64 Cholesky."""
    got = port()["cone_factor"]
    assert got["n"] == 512 and got["ok"]
    assert got["same"] and got["differs_from_f64"]


def test_dryrun(port):
    """(g) one full sharded KKT iteration on each path, 4 ranks."""
    got = port()["dryrun"]
    row, slot = got["row_sharded"], got["slot_sharded"]
    assert row["m"] == 512 and max(row["rows_per_rank"]) < 512
    assert slot["m"] == 24 and max(slot["rows_per_rank"]) < 24
    assert np.isfinite(row["dy_norm"]) and np.isfinite(slot["dy_norm"])
    assert set(got["counts"]) == {"all_gather", "all_reduce", "broadcast", "reduce_scatter"}


COLLECTIVES = ("all_reduce", "all_reduce_max", "all_reduce_min", "all_gather",
               "reduce_scatter", "broadcast")


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective(port, name):
    """Each collective of the mesh (gloo, 4 ranks) gives what its JAX
    counterpart (psum, pmax, pmin, all_gather and psum_scatter tiled) or a
    broadcast must, bit for bit, on inputs seeded by the rank; sums are
    held on one nonzero term per entry, exact in any order of addition."""
    got = port()["collectives"]
    assert got["same"][name]
    assert got["counts"] == {"all_reduce": 3, "all_gather": 1, "reduce_scatter": 1,
                             "broadcast": 1}


@pytest.mark.parametrize("fused", [False, True, "auto", "phase", "iter"])
def test_mesh_runs_the_host_loop(fused):
    """(h) choose_fused_mode: a mesh always runs the host loop."""
    from hdsdp_tpu_torch.solver.algo import choose_fused_mode
    from hdsdp_tpu_torch.solver.params import Params

    assert choose_fused_mode(40, 40, 40, False, Params(fused=fused), mesh=True) is False


def test_mesh_needs_a_group_and_its_device():
    """(i) no mesh without a process group; a device that disagrees with
    the mesh raises (a gloo world of one rank in this process)."""
    import torch.distributed as dist

    from hdsdp_tpu_torch.models.problem import SDPProblem
    from hdsdp_tpu_torch.models.synthetic import maxcut_sdpa
    from hdsdp_tpu_torch.parallel.mesh import free_port, init_world, make_mesh
    from hdsdp_tpu_torch.solver.solver import HDSDPSolver

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh("cpu")
    init_world(0, 1, "gloo", free_port(), timeout=30)
    try:
        mesh = make_mesh("cpu")
        assert (mesh.rank, mesh.size, mesh.axis) == (0, 1, "row")
        prob = SDPProblem.from_sdpa(maxcut_sdpa(n=12, seed=0))
        with pytest.raises(ValueError, match="disagrees"):
            HDSDPSolver(prob, device="cuda", mesh=mesh)
        s = HDSDPSolver(prob, device="cpu", mesh=mesh, verbose=False)
        assert s.device == torch.device("cpu")
        r = s.optimize()
        assert r.status == "PRIMAL_DUAL_OPTIMAL" and r.stats["fused"] is False
        t = torch.arange(3.0)
        mesh.assert_same(t)
    finally:
        dist.destroy_process_group()
