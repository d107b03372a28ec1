"""dtype="float32" in the port against the JAX package, on the CPU.

The JAX package runs float32 on its host loop and on its mesh, not on its
fused driver (its phase bodies fail on it) and so not in solve_batch.
Its float32 loop is a mixed one: under x64 a float32 array that meets a
numpy float64 scalar (the mu that ``np.sqrt`` makes in phase B's
corrector, the trace estimate of theta's presolve) or a float64 array
becomes float64, so y goes float64 during the solve while b stays
float32, and the final DIMACS check casts the maker point back to
float32.  The port follows those promotions (``utils.device.jdtype``):

* every host-loop solve takes its dtypes in the JAX package's order: the
  sequence of dtypes each iterate attribute of DualIPM takes is the same
  in both packages, and so are the dtypes after the first iteration and
  before the final check (y, b, dy, each S, L, the Schur matrix and its
  factor, the ratio test's step);
* status equal, d_obj within 1e-6 relative, the DIMACS grade within 10x
  the JAX package's.  The tolerance: both packages end on a float32
  DIMACS evaluation of b'y (a float32 ulp is 6e-8 relative), and their
  float32 phase A rounds its sums in different orders; on these instances
  the two differ by at most 1.1e-7 relative, and the JAX package's
  float32 runs differ from its float64 runs by up to 1e-7.  The iteration
  count is not held: a float32 trajectory's count moves with the host
  BLAS's rounding (gpp took 21 iterations on one CPU with MKL's AVX-512
  path at one thread, 19 at six threads or on its AVX2 path; JAX 19);
* every combination of float32 with another option runs in the JAX
  package's host loop, so it runs in the port and is held here:
  kkt_hp="on", cone_fp="dd" (below n = 512 the flag, and one DD cone
  factor of a 512 x 512 float32 S), kkt_fp="dd", kkt_mp="on",
  kkt_mode="free", operator mode by threshold and kkt_solver="cg";
* the fused driver and solve_batch refuse float32 with a hint to pass
  fused=False;
* a float32 solve's end state, moved into a fresh DualIPM, keeps its
  dtypes and checks as the solve did (``chip_smoke.py`` checks the card's
  end state on the host).

The float32 mesh case is in tests/test_torch_parallel.py's world."""

import numpy as np
import pytest
import torch

from hdsdp_tpu.models import synthetic as jsyn
from hdsdp_tpu.models.problem import SDPProblem as JProblem
from hdsdp_tpu.solver import algo as jalgo
from hdsdp_tpu.solver.solver import HDSDPSolver as JSolver
from hdsdp_tpu_torch import solve_batch
from hdsdp_tpu_torch.models import synthetic as tsyn
from hdsdp_tpu_torch.models.problem import SDPProblem as TProblem
from hdsdp_tpu_torch.solver import algo as talgo
from hdsdp_tpu_torch.solver.solver import HDSDPSolver as TSolver

D_OBJ_REL = 1e-6

INSTANCES = {
    "maxcut": ("maxcut_sdpa", dict(n=20, seed=0)),
    "theta": ("theta_sdpa", dict(n=20, n_edges=40, seed=0)),
    "gpp": ("gpp_sdpa", dict(n=20, seed=0)),
}
# the iterate attributes whose dtypes are traced
TRACED = ("y", "S", "L", "sl", "su", "kkt", "Mfac", "d1", "d2", "d3", "d4", "dS", "dsl",
          "dsu", "Schk", "Lchk", "sl_chk", "su_chk", "mu", "p_obj_internal", "Rd", "tau",
          "perturb")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _dt(v):
    """A value's dtype as a string: tensors and arrays by dtype, numpy
    scalars as such (they promote in JAX), Python numbers by type."""
    if v is None:
        return "None"
    if isinstance(v, tuple):
        return "(" + ",".join(_dt(x) for x in v) + ")"
    if hasattr(v, "dtype") and not isinstance(v, np.generic):
        return str(v.dtype).replace("torch.", "")
    if isinstance(v, np.generic):
        return "np." + str(v.dtype)
    return type(v).__name__


def _snapshot(ipm):
    k = ipm.kkt
    return {
        "y": _dt(ipm.y), "b": _dt(ipm.b), "d1": _dt(ipm.d1), "d2": _dt(ipm.d2),
        "S": _dt(tuple(ipm.S)), "L": _dt(tuple(ipm.L)), "dS": _dt(tuple(ipm.dS)),
        "M": _dt(None if k is None else k.M), "asinv": _dt(None if k is None else k.asinv),
        "Mfac": _dt(ipm.Mfac[1]) if ipm.Mfac is not None else "None",
    }


def _traced_solve(cls_ipm, make_solver):
    """Solve with DualIPM's attribute writes recorded: the ordered first
    occurrences of (attribute, dtype) for TRACED, a snapshot at the
    first iteration's log row and one before the final check, and the
    dtype of the step the first ratio test returned."""
    seen, snaps = [], {}
    orig_set = cls_ipm.__setattr__
    orig_log = cls_ipm.print_log
    orig_release = cls_ipm.release_solve_buffers
    orig_ratio = cls_ipm.ratio_test

    def setattr_(self, k, v):
        if k in TRACED and (k, _dt(v)) not in seen:
            seen.append((k, _dt(v)))
        orig_set(self, k, v)

    def print_log(self, method):
        snaps.setdefault("first", _snapshot(self))
        return orig_log(self, method)

    def release(self):
        snaps["end"] = _snapshot(self)
        return orig_release(self)

    def ratio_test(self, *a, **kw):
        snaps.setdefault("ratio_input", (_dt(tuple(self.L)), _dt(a[1])))
        return orig_ratio(self, *a, **kw)

    cls_ipm.__setattr__ = setattr_
    cls_ipm.print_log = print_log
    cls_ipm.release_solve_buffers = release
    cls_ipm.ratio_test = ratio_test
    try:
        s = make_solver()
        r = s.optimize()
    finally:
        cls_ipm.__setattr__ = orig_set
        cls_ipm.print_log = orig_log
        cls_ipm.release_solve_buffers = orig_release
        cls_ipm.ratio_test = orig_ratio
    return s, r, seen, snaps


@pytest.fixture(scope="module")
def f32_runs():
    out = {}
    for name, (gen, kw) in INSTANCES.items():
        jrun = _traced_solve(jalgo.DualIPM, lambda: JSolver(
            JProblem.from_sdpa(getattr(jsyn, gen)(**kw)), fused=False, verbose=False,
            dtype="float32"))
        trun = _traced_solve(talgo.DualIPM, lambda: TSolver(
            TProblem.from_sdpa(getattr(tsyn, gen)(**kw)), device="cpu", fused=False,
            verbose=False, dtype="float32"))
        out[name] = jrun, trun
    return out


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_f32_host_loop_matches_jax(f32_runs, name):
    (js, jr, _, _), (ts, tr, _, _) = f32_runs[name]
    assert tr.status == jr.status == "PRIMAL_DUAL_OPTIMAL", (tr.n_iters, jr.n_iters)
    assert tr.d_obj == pytest.approx(jr.d_obj, rel=D_OBJ_REL)
    assert np.max(np.abs(tr.dimacs)) <= 10.0 * np.max(np.abs(jr.dimacs))
    assert tr.stats["fused"] is False
    assert ts.ipm.dtype == torch.float32


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_f32_dtypes_follow_jax(f32_runs, name):
    """The JAX package's promotions, not a clean float32 loop: the same
    sequence of dtypes on every traced attribute, the same dtypes after
    the first iteration and before the final check (y float64 by then, b
    float32), and the same at the first ratio test."""
    (_, _, jseen, jsnap), (_, _, tseen, tsnap) = f32_runs[name]
    assert tseen == jseen
    assert tsnap == jsnap
    assert tsnap["first"]["b"] == "float32"
    assert tsnap["end"]["y"] == "float64" and tsnap["end"]["b"] == "float32"


def test_f32_check_runs_in_f32(monkeypatch):
    """The final DIMACS check casts the maker point to the IPM's dtype,
    as the JAX package's does: its recovered X is float32."""
    from hdsdp_tpu_torch.solver import dimacs

    seen = []
    orig = dimacs._recover

    def recover(*a, **kw):
        out = orig(*a, **kw)
        seen.append(_dt(tuple(out[0])))
        return out

    monkeypatch.setattr(dimacs, "_recover", recover)
    gen, kw = INSTANCES["maxcut"]
    r = TSolver(TProblem.from_sdpa(getattr(tsyn, gen)(**kw)), device="cpu", fused=False,
                verbose=False, dtype="float32").optimize()
    assert seen and all(s == "(float32)" for s in seen)
    assert r.status == "PRIMAL_DUAL_OPTIMAL" and np.max(np.abs(r.dimacs)) < 1e-4


def test_f32_end_state_moves_with_its_dtypes(tmp_path):
    """A float32 solve's end state (``checkpoint_to``) set into a fresh
    float32 DualIPM by ``load_state`` keeps the dtypes the solve left (y
    float64 once it widened), and the check there repeats the solve's
    status and errors bit for bit (what ``chip_smoke.py`` runs on the host
    at the card's end state)."""
    from hdsdp_tpu_torch.solver import dimacs
    from hdsdp_tpu_torch.solver.params import Params
    from hdsdp_tpu_torch.utils.checkpoint import load_checkpoint

    gen, kw = INSTANCES["maxcut"]
    prob = TProblem.from_sdpa(getattr(tsyn, gen)(**kw))
    path = str(tmp_path / "end.npz")
    s = TSolver(prob, device="cpu", fused=False, verbose=False, dtype="float32")
    r = s.optimize(checkpoint_to=path)
    ipm = talgo.DualIPM(prob, Params(fused=False, verbose=False, dtype="float32"),
                        torch.device("cpu"))
    talgo.load_state(ipm, load_checkpoint(path))
    assert ipm.y.dtype == s.ipm.y.dtype == torch.float64
    assert ipm.maker_acc.y.dtype == s.ipm.maker_acc.y.dtype
    assert torch.equal(ipm.y, s.ipm.y)
    errs = dimacs.check_solution(ipm)
    assert ipm.status == r.status == "PRIMAL_DUAL_OPTIMAL"
    assert np.array_equal(errs, r.dimacs)


# float32 with each other option, on the host loop, against the JAX package
COMBOS = {
    "kkt_hp": ("gpp_sdpa", dict(n=20, seed=0), dict(kkt_hp="on")),
    "cone_dd": ("maxcut_sdpa", dict(n=20, seed=0), dict(cone_fp="dd")),
    "kkt_dd": ("maxcut_sdpa", dict(n=20, seed=0), dict(kkt_fp="dd")),
    "kkt_mp": ("maxcut_sdpa", dict(n=20, seed=0), dict(kkt_mp="on")),
    "free": ("maxcut_sdpa", dict(n=20, seed=0), dict(kkt_mode="free")),
    "operator": ("maxcut_sdpa", dict(n=20, seed=0), dict(kkt_free_threshold=10)),
    "cg": ("maxcut_sdpa", dict(n=20, seed=0), dict(kkt_solver="cg")),
}


@pytest.mark.parametrize("name", sorted(COMBOS))
def test_f32_combination_matches_jax(name):
    gen, kw, over = COMBOS[name]
    js = JSolver(JProblem.from_sdpa(getattr(jsyn, gen)(**kw)), fused=False, verbose=False,
                 dtype="float32", **over)
    jr = js.optimize()
    ts = TSolver(TProblem.from_sdpa(getattr(tsyn, gen)(**kw)), device="cpu", fused=False,
                 verbose=False, dtype="float32", **over)
    tr = ts.optimize()
    assert tr.status == jr.status == "PRIMAL_DUAL_OPTIMAL"
    assert abs(tr.n_iters - jr.n_iters) <= 1
    assert tr.d_obj == pytest.approx(jr.d_obj, rel=D_OBJ_REL)
    assert str(ts.ipm.y.dtype).replace("torch.", "") == str(js.ipm.y.dtype)
    assert ts.ipm.cones.cone_dd == bool(js.ipm.cones.cone_dd)
    assert ts.ipm.kkt_free == bool(js.ipm.kkt_free)
    if over.get("kkt_solver") == "cg":
        assert tr.stats["cg_n_solve"] > 0
    if ts.ipm.kkt_free:
        assert tr.stats["opcg_iters"] > 0


def test_f32_dd_cone_factor_matches_jax():
    """cone_fp="dd" at n = 512: the DD factor of a float32 S is float64,
    in both packages (the factor is converted back from double-single),
    and the two agree to 1e-12 (the JAX side is jitted, which contracts
    the DD arithmetic into FMAs)."""
    import jax.numpy as jnp

    from hdsdp_tpu.ops import chol as jchol
    from hdsdp_tpu_torch.ops import chol as tchol

    rng = np.random.default_rng(4)
    A = rng.normal(size=(512, 512)) / np.sqrt(512)
    S = (A @ A.T + 0.5 * np.eye(512)).astype(np.float32)[None]
    okj, Lj = jchol.psd_factor(jnp.asarray(S), use_dd=True)
    okt, Lt = tchol.psd_factor(torch.as_tensor(S), use_dd=True)
    assert bool(okj) and bool(okt)
    assert str(Lj.dtype) == "float64" and Lt.dtype == torch.float64
    Lj = np.asarray(Lj)
    assert np.max(np.abs(Lt.numpy() - Lj)) <= 1e-12 * np.max(np.abs(Lj))


@pytest.mark.parametrize("fused", ["auto", "phase", "iter"])
def test_f32_fused_driver_raises(fused):
    prob = TProblem.from_sdpa(tsyn.maxcut_sdpa(n=10, seed=0))
    with pytest.raises(NotImplementedError, match="fused=False"):
        TSolver(prob, device="cpu", verbose=False, dtype="float32", fused=fused).optimize()


def test_f32_solve_batch_raises():
    probs = [TProblem.from_sdpa(tsyn.maxcut_sdpa(n=10, seed=s)) for s in range(2)]
    with pytest.raises(NotImplementedError, match="fused=False"):
        solve_batch(probs, device="cpu", dtype="float32")
